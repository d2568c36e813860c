"""Model building blocks of the port (``repro.models``): the PNA graph
network, the dense GQA decoder LM (``transformer``, ``attention``,
``moe``'s dense FFN) and the shared blocks of ``common``."""
