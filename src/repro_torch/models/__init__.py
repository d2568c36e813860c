"""Model building blocks of the port (``repro.models``): the graph
networks of ``gnn`` (PNA, EGNN, NequIP, Equiformer-v2, the sampler), the
decoder LM (``transformer``, ``attention``: GQA and MLA; ``moe``: the
dense FFN and the routed MoE) and the shared blocks of ``common``."""
