"""Hand-written CUDA kernels for Hopper, each beside its plain version.

* ``spc_query`` -- batched label-row intersection (the serving hot path;
  replaces the Pallas kernel of ``repro.kernels.spc_query``).

``common`` builds each kernel's source with ``nvcc`` at first use and
loads it with ``ctypes``.
"""
