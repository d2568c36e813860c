"""The embedding_bag CUDA kernel's launching wrapper
(``csrc/embedding_bag.cu``).

Replaces the Pallas TPU kernel ``_kernel`` of
``src/repro/kernels/embedding_bag/kernel.py:29``.  Takes ids int32
[B, S] and a float32 or bfloat16 table [V + 1, D] whose last row is
zero, and returns [B, D] in the table's dtype: the fp32 sum of each
bag's rows.  An id in [0, V) reads its row, an id in [-(V + 1), -1]
row V + 1 + id (from the end, as the reference reads it), and any other
id the zero row.

The route is the packed design: :func:`plan` picks the widest vector a
row can be read in (16, 8, 4 or, in bfloat16, 2 bytes, as the row's
bytes and the table's alignment allow) and how many bags a warp holds.
:func:`_warp_cuda` runs the first design (one warp per bag,
scalar loads), so that both can be timed at the same shapes; the two
give the same bits.

The wrapper checks device, dtype, shape and contiguity, allocates the
output with ``torch.empty``, launches on the current stream, raises if
``cudaGetLastError`` reports a failed launch, and counts the launch in
:data:`launches`.  It never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import common

#: Launches of the embedding_bag kernel (the main-path proof counter).
launches = common.LaunchCounter("embedding_bag")

#: Table dtypes the kernel takes, and the code its C entry expects.
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: Lanes of a warp.
WARP = 32


class Pack(NamedTuple):
    """How the packed design reads a row: vectors of ``vb`` bytes,
    ``nv`` of them a row, ``bags`` bags a warp (its lanes spread over
    (bag, vector); one bag whose vectors the lanes stride over when a
    row has more than 16 vectors)."""
    vb: int
    nv: int
    bags: int


def plan(d: int, dtype: torch.dtype, table_ptr: int = 0) -> Pack:
    """The widest vector that divides the row's bytes and the table's
    address (16, 8, 4, and 2 in bfloat16), and the bags a warp holds."""
    elem = 4 if dtype == torch.float32 else 2
    vb = next(w for w in (16, 8, 4, 2) if w >= elem and
              (d * elem) % w == 0 and table_ptr % w == 0)
    nv = d * elem // vb
    return Pack(vb, nv, WARP // nv if nv <= WARP // 2 else 1)


def _entry(name: str = "embedding_bag_packed_launch"):
    fn = getattr(common.load("embedding_bag"), name)
    if fn.argtypes is None:
        # ids, table, out, B, S, D, V + 1, dtype (+ vb, bags), stream
        ints = [ctypes.c_int] * (2 if "packed" in name else 0)
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int] + ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def embedding_bag_cuda(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Launch the packed design on CUDA tensors; raises on anything it
    does not take."""
    return _launch(ids, table, packed=True)


def _warp_cuda(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The first design (one warp per bag), timed beside the
    packed one."""
    return _launch(ids, table, packed=False)


def _launch(ids: torch.Tensor, table: torch.Tensor, packed: bool
            ) -> torch.Tensor:
    dev = ids.device
    if dev.type != "cuda":
        raise ValueError(f"embedding_bag_cuda needs CUDA tensors, got {dev}")
    if table.device != dev:
        raise ValueError(f"table on {table.device}, ids on {dev}")
    if ids.dtype != torch.int32:
        raise ValueError(f"ids has dtype {ids.dtype}, want torch.int32")
    if table.dtype not in _DTYPE_CODES:
        raise ValueError(f"table has dtype {table.dtype}, want float32 or "
                         f"bfloat16")
    if ids.dim() != 2 or table.dim() != 2:
        raise ValueError(f"want ids [B, S] and table [V + 1, D], got shape "
                         f"{tuple(ids.shape)} and {tuple(table.shape)}")
    if table.shape[0] < 1:
        raise ValueError("table needs at least its zero row")
    for name, x in (("ids", ids), ("table", table)):
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    (b, s), (v1, d) = ids.shape, table.shape
    out = torch.empty((b, d), dtype=table.dtype, device=dev)
    if b == 0 or d == 0:
        return out
    if s >= 2 ** 31 or d >= 2 ** 31 or v1 >= 2 ** 31:
        raise ValueError(f"unsupported shape: ids {tuple(ids.shape)}, "
                         f"table {tuple(table.shape)}")
    args = (ids.data_ptr(), table.data_ptr(), out.data_ptr(), b, s, d, v1,
            _DTYPE_CODES[table.dtype])
    if packed:
        # the output is a fresh allocation: aligned to more than 16 bytes
        pack = plan(d, table.dtype, table.data_ptr())
        err = common.launch(dev, _entry(), *args, pack.vb, pack.bags)
    else:
        err = common.launch(dev, _entry("embedding_bag_launch"), *args)
    if err != 0:
        raise RuntimeError(f"embedding_bag launch failed: cudaError {err}")
    launches.add()
    return out
