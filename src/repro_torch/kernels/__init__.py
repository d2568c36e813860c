"""Hand-written CUDA kernels for Hopper, each beside its plain version.

* ``spc_query`` -- batched label-row intersection (the serving hot path;
  replaces the Pallas kernel of ``repro.kernels.spc_query``).
* ``segment_matmul`` -- segment sums of edge values (scatter-add and
  GNN aggregation; replaces ``repro.kernels.segment_matmul``).
* ``embedding_bag`` -- in-bag row sums (the re-rank's pooling; replaces
  ``repro.kernels.embedding_bag``).
* ``flash_decode`` -- one-token GQA attention over a KV cache (the LM
  decode hot path; replaces ``repro.kernels.flash_decode``).

``common`` builds each kernel's source with ``nvcc`` at first use and
loads it with ``ctypes``.
"""
