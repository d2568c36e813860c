"""repro_torch: DSPC (Dynamic Shortest Path Counting) on PyTorch and CUDA.

The PyTorch/CUDA port of the JAX package ``repro``, which stays the
reference every module here is tested against.  Subpackages mirror the
reference's names:

* ``repro_torch.core``      -- graph edge list, SPC-Index label matrices,
                               counting BFS, construction, IncSPC / DecSPC
                               / HybSPC maintenance and the ``DynamicSPC``
                               driver.
* ``repro_torch.kernels``   -- hand-written CUDA kernels for Hopper
                               (``spc_query``, ``embedding_bag``,
                               ``flash_decode``), each beside its plain
                               PyTorch version, built with ``nvcc`` at
                               first call.
* ``repro_torch.serve``     -- the routed, bucket-padded ``QueryEngine``
                               and the versioned snapshot store.
* ``repro_torch.analytics`` -- betweenness, shortest cycles and
                               recommendation over a pinned snapshot.
* ``repro_torch.models``    -- PNA, and the dense GQA LM's ``prefill`` and
                               KV-cache ``decode_step``.
* ``repro_torch.launch``    -- device meshes that one controller process
                               drives (edge-sharded updates, replicated
                               snapshots, batch-sharded serving).
* ``repro_torch.analysis``  -- lock factories with the canonical names,
                               and the lock-order / lint analyzer
                               (``python -m repro_torch.analysis``).
* ``repro_torch.configs`` / ``repro_torch.data`` -- the ported
                               configurations (``dspc``, ``pna``,
                               ``qwen2-1.5b``) and the graph /
                               update-stream generators.

Entry points take ``device=`` and default to ``"cuda"``; the CPU is used
only when the caller asks for it.  Nothing here imports JAX or ``repro``.
"""

__version__ = "0.1.0"
