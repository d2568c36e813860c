"""The spc_query CUDA kernel's launching wrapper (``csrc/spc_query.cu``).

Replaces the Pallas TPU kernel ``_kernel`` of
``src/repro/kernels/spc_query/kernel.py:38``.  Takes the six gathered
[B, L] label-row operands -- hub and dist int32, cnt **int64** -- and
returns (dist int32[B], count int64[B]), exact for every row (the TPU
kernel counts in fp32, exact only to 2^24).

Each row must be sorted by hub id, as the index keeps its rows; a hub
may repeat on either side, and every pair of equal hubs counts, as in
the reference's L x L table.  Unsorted rows are outside the contract:
the kernel binary-searches L(t) and would miss matches there.

The wrapper checks device, dtype, shape and contiguity, allocates the
outputs with ``torch.empty``, launches on the current stream, raises if
``cudaGetLastError`` reports a failed launch, and counts the launch in
:data:`launches`.  It never falls back to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common

#: Launches of the spc_query kernel (the main-path proof counter).
launches = common.LaunchCounter("spc_query")

_DTYPES = (torch.int32, torch.int32, torch.int64,
           torch.int32, torch.int32, torch.int64)
_NAMES = ("hub_s", "dist_s", "cnt_s", "hub_t", "dist_t", "cnt_t")


def _entry():
    lib = common.load("spc_query")
    fn = lib.spc_query_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int,
                                                ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def spc_query_cuda(hub_s, dist_s, cnt_s, hub_t, dist_t, cnt_t):
    """Launch the kernel on CUDA tensors; raises on anything it does not
    take."""
    rows = (hub_s, dist_s, cnt_s, hub_t, dist_t, cnt_t)
    dev = hub_s.device
    if dev.type != "cuda":
        raise ValueError(f"spc_query_cuda needs CUDA tensors, got {dev}")
    shape = tuple(hub_s.shape)
    if len(shape) != 2:
        raise ValueError(f"label rows must be [B, L], got {shape}")
    for name, x, dt in zip(_NAMES, rows, _DTYPES):
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, hub_s on {dev}")
        if x.dtype != dt:
            raise ValueError(f"{name} has dtype {x.dtype}, want {dt}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"want {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    b, l_cap = shape
    d = torch.empty(b, dtype=torch.int32, device=dev)
    c = torch.empty(b, dtype=torch.int64, device=dev)
    if b == 0:
        return d, c
    if l_cap == 0 or b >= 2 ** 31 or l_cap >= 2 ** 31:
        raise ValueError(f"unsupported shape {shape}")
    err = common.launch(dev, _entry(), *(x.data_ptr() for x in rows),
                        d.data_ptr(), c.data_ptr(), b, l_cap)
    if err != 0:
        raise RuntimeError(f"spc_query launch failed: cudaError {err}")
    launches.count += 1
    return d, c
