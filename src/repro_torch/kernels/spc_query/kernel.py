"""The spc_query CUDA kernels' launching wrappers (``csrc/spc_query.cu``).

Replaces the Pallas TPU kernel ``_kernel`` of
``src/repro/kernels/spc_query/kernel.py:38``.  Returns (dist int32[B],
count int64[B]), exact for every row (the TPU kernel counts in fp32,
exact only to 2^24).  Two forms of the same function:

* :func:`spc_query_index_cuda` reads the label rows by vertex id from
  the index's ``hub``, ``dist`` and ``cnt`` ([n + 1, L]: int32, int32,
  int64, pad hub n) at the int64 ids ``s`` and ``t``: no gathered
  operands.  An id outside [0, n] follows the reference's gather rule:
  a negative id wraps once (id + n + 1), then the row is clamped to
  [0, n].  Each row ends at its first pad hub.
* :func:`spc_query_cuda` takes the six gathered [B, L] operands (hub and
  dist int32, cnt int64), as the reference's microbench and the TPU
  sweep do: the same kernel with identity ids and no length cut.

Each row must be sorted by hub id, as the index keeps its rows; a hub
may repeat on either side, and every pair of equal hubs counts, as in
the reference's L x L table.  Unsorted rows are outside the contract:
the kernel binary-searches one row and would miss matches there.

:func:`plan` picks the design from L alone: ``"staged"`` copies the
searched row into shared memory (4 L bytes), ``"global"`` searches it
in device memory where it would not fit.  :func:`_warp_cuda` runs the
first design (one warp per gathered pair), so that the route it served
can be timed beside the fused one.

The wrappers check device, dtype, shape and contiguity, allocate the
outputs with ``torch.empty``, launch on the current stream, raise if
``cudaGetLastError`` reports a failed launch, and count the launch in
:data:`launches`.  They never fall back to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common

#: Launches of the spc_query kernels (the main-path proof counter).
launches = common.LaunchCounter("spc_query")

#: The most shared memory the staged design takes for one row (4 L
#: bytes): up to L = 16384; past it the row is searched in device memory.
STAGE_BYTES = 64 * 1024
#: ``limit`` of the gathered form: no hub ends a row there.
_NO_CUT = 2 ** 31 - 1

_DTYPES = (torch.int32, torch.int32, torch.int64,
           torch.int32, torch.int32, torch.int64)
_NAMES = ("hub_s", "dist_s", "cnt_s", "hub_t", "dist_t", "cnt_t")


def plan(l_cap: int) -> str:
    """The fused kernel's design for rows of ``l_cap`` labels."""
    return "staged" if 4 * l_cap <= STAGE_BYTES else "global"


def _entry(name: str):
    fn = getattr(common.load("spc_query"), name)
    if fn.argtypes is None:
        if name == "spc_query_fused_launch":
            fn.argtypes = [ctypes.c_void_p] * 10 + [
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_void_p] * 8 + [
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(names, tensors, dtypes, shapes, what):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")
    for name, x, dt, shape in zip(names, tensors, dtypes, shapes):
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, {names[0]} on {dev}")
        if x.dtype != dt:
            raise ValueError(f"{name} has dtype {x.dtype}, want {dt}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"want {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return dev


def _fused(dev, rows_s, rows_t, ids_s, ids_t, b, n_rows, l_cap, limit):
    d = torch.empty(b, dtype=torch.int32, device=dev)
    c = torch.empty(b, dtype=torch.int64, device=dev)
    if b == 0:
        return d, c
    if l_cap == 0 or b >= 2 ** 31 or l_cap >= 2 ** 31:
        raise ValueError(f"unsupported shape: {b} pairs of {l_cap} labels")
    err = common.launch(
        dev, _entry("spc_query_fused_launch"),
        *(x.data_ptr() for x in rows_s + rows_t), ids_s, ids_t,
        d.data_ptr(), c.data_ptr(), b, n_rows, l_cap, limit,
        int(plan(l_cap) == "staged"))
    if err != 0:
        raise RuntimeError(f"spc_query launch failed: cudaError {err}")
    launches.add()
    return d, c


def spc_query_index_cuda(hub, dist, cnt, s, t):
    """(dist int32[B], count int64[B]) for the pairs (s[b], t[b]) of
    int64 ids, the rows read from the index on the card; raises on
    anything the kernel does not take."""
    if hub.dim() != 2 or s.dim() != 1:
        raise ValueError(f"want an index [n + 1, L] and ids [B], got "
                         f"shapes {tuple(hub.shape)} and {tuple(s.shape)}")
    shape, ids = tuple(hub.shape), tuple(s.shape)
    dev = _check(("hub", "dist", "cnt", "s", "t"), (hub, dist, cnt, s, t),
                 (torch.int32, torch.int32, torch.int64, torch.int64,
                  torch.int64), (shape,) * 3 + (ids,) * 2,
                 "spc_query_index_cuda")
    n_rows, l_cap = shape
    if n_rows == 0:
        raise ValueError("the index needs at least its dump row")
    if n_rows > _NO_CUT:
        raise ValueError(f"unsupported index of {n_rows} rows")
    return _fused(dev, (hub, dist, cnt), (hub, dist, cnt), s.data_ptr(),
                  t.data_ptr(), ids[0], n_rows, l_cap, n_rows - 1)


def _check_rows(rows, what):
    if rows[0].dim() != 2:
        raise ValueError(f"label rows must be [B, L], got "
                         f"{tuple(rows[0].shape)}")
    return _check(_NAMES, rows, _DTYPES, (tuple(rows[0].shape),) * 6, what)


def spc_query_cuda(hub_s, dist_s, cnt_s, hub_t, dist_t, cnt_t):
    """(dist int32[B], count int64[B]) over gathered [B, L] rows on the
    card; raises on anything the kernel does not take."""
    rows = (hub_s, dist_s, cnt_s, hub_t, dist_t, cnt_t)
    dev = _check_rows(rows, "spc_query_cuda")
    b, l_cap = hub_s.shape
    return _fused(dev, rows[:3], rows[3:], None, None, b, b, l_cap, _NO_CUT)


def _warp_cuda(hub_s, dist_s, cnt_s, hub_t, dist_t, cnt_t):
    """The first design over gathered rows: one warp per pair, L(t)
    binary-searched in device memory (timed beside the fused kernel)."""
    rows = (hub_s, dist_s, cnt_s, hub_t, dist_t, cnt_t)
    dev = _check_rows(rows, "spc_query_cuda")
    b, l_cap = hub_s.shape
    d = torch.empty(b, dtype=torch.int32, device=dev)
    c = torch.empty(b, dtype=torch.int64, device=dev)
    if b == 0:
        return d, c
    if l_cap == 0 or b >= 2 ** 31 or l_cap >= 2 ** 31:
        raise ValueError(f"unsupported shape {tuple(hub_s.shape)}")
    err = common.launch(dev, _entry("spc_query_launch"),
                        *(x.data_ptr() for x in rows), d.data_ptr(),
                        c.data_ptr(), b, l_cap)
    if err != 0:
        raise RuntimeError(f"spc_query launch failed: cudaError {err}")
    launches.add()
    return d, c
