"""The flash_decode CUDA kernel's launching wrapper
(``csrc/flash_decode.cu``).

Replaces the Pallas TPU kernel ``_kernel`` of
``src/repro/kernels/flash_decode/kernel.py:32``.  Takes q [B, H, D] and
the cache k, v [B, S, KVH, D] in its own layout -- query head h reads KV
head h // (H / KVH), nothing is expanded to H heads -- with lengths
int32 [B], all float32 or all bfloat16, D in {16, 32, 64, 128}.
Returns [B, H, D] in q's dtype: the fp32 softmax over positions
``< lengths[b]`` of the scaled scores, times V (zeros at length 0); with
``return_lse`` also each row's log-sum-exp of those scores, float32
[B, H] (``-inf`` at length 0), which the merge pass writes from the
final (m, l) it already holds.

:func:`plan` picks the source's route from the dtype and D alone, never
from a failed build or launch: bfloat16 at D = 64 or 128 (the LM's)
runs on the tensor cores (``"mma"``), everything else on the CUDA cores
(``"simt"``).  The wrapper checks device, dtype, shape, contiguity and
alignment, splits S as the plan says, allocates the output and the fp32
per-span scratch with ``torch.empty``, launches both passes on the
current stream, raises if ``cudaGetLastError`` reports a failed launch,
and counts the call in :data:`launches`.  It never falls back to the
plain version.  :func:`_simt_cuda` runs the CUDA-core route whatever the
plan, so that both routes can be timed at the LM's shape.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import common

#: Launches of the flash_decode kernel (the main-path proof counter).
launches = common.LaunchCounter("flash_decode")

#: Input dtypes the kernel takes, and the code its C entry expects.
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
#: Head dims of the tensor-core route (in bfloat16).
MMA_HEAD_DIMS = (64, 128)
#: Cache positions per span unit of each route: spans are multiples of
#: it (``kTile`` of the CUDA-core route, ``kWarpTile`` of the tensor
#: cores).
TILE = {"simt": 64, "mma": 16}
#: Query heads one tensor-core CTA serves: the M of m16n8k16.
MMA_HEADS = 16
#: CTAs to aim for per SM: the CUDA-core route runs 4 waves of 2
#: resident CTAs; the tensor-core route one wave of 2 (4 warps with a
#: 24 KB ring each at D = 128: 96 KB of shared memory a CTA).
CTAS_PER_SM = {"simt": 8, "mma": 2}


class Plan(NamedTuple):
    """How the kernel cuts the work: the route, the query heads one CTA
    serves (``heads``), the CTAs over a KV head's group (``n_chunks``),
    and S cut into ``n_splits`` spans of ``split_len`` positions."""
    route: str
    heads: int
    n_chunks: int
    split_len: int
    n_splits: int


def plan(b: int, kvh: int, h: int, s: int, d: int, dtype: torch.dtype,
         sms: int) -> Plan:
    """The route from ``dtype`` and ``d`` alone, then how it cuts the
    work (:func:`cut`)."""
    route = "mma" if dtype == torch.bfloat16 and d in MMA_HEAD_DIMS \
        else "simt"
    return cut(route, b, kvh, h, s, sms)


def cut(route: str, b: int, kvh: int, h: int, s: int, sms: int) -> Plan:
    """The heads one CTA serves (16 on the tensor cores; 1, 2, 4 or 8 on
    the CUDA cores, sharing one read of a KV head's rows) and spans
    (multiples of the route's :data:`TILE`) so that about
    ``CTAS_PER_SM[route] * sms`` CTAs run: at most one wave on the tensor
    cores, at least 4 waves on the CUDA cores.  Spans are cut from S, not
    from the lengths, so no length is read on the host."""
    group = h // kvh
    heads = MMA_HEADS if route == "mma" else next(
        c for c in (1, 2, 4, 8) if c >= min(group, 8))
    n_chunks = -(-group // heads)
    rows = b * kvh * n_chunks
    per_card = CTAS_PER_SM[route] * sms
    want = per_card // rows if route == "mma" else -(-per_card // rows)
    tiles = -(-s // TILE[route])
    split_len = -(-tiles // max(1, min(tiles, want, 65535))) * TILE[route]
    return Plan(route, heads, n_chunks, split_len, -(-s // split_len))


def cost(b: int, h: int, kvh: int, s: int, d: int,
         dtype: torch.dtype) -> tuple:
    """(FLOPs, bytes) of one call on q [b, h, d] and a cache of ``s``
    positions and ``kvh`` KV heads: the whole window, as the reference's
    ``model_flops`` counts a decode ("cache attention reads the whole
    window").  FLOPs: a multiply and an add per query head, position and
    channel for q . k and again for p . v.  Bytes: K and V once each
    however many query heads share them, q and the output, the int32
    lengths."""
    esize = torch.empty((), dtype=dtype, device="meta").element_size()
    return (4 * b * h * s * d,
            2 * b * s * kvh * d * esize + 2 * b * h * d * esize + 4 * b)


def _entry(name: str = "flash_decode_launch"):
    fn = getattr(common.load("flash_decode"), name)
    if fn.argtypes is None:
        ints = 9 if name == "flash_decode_launch" else 7
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * ints + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, lengths) -> None:
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_decode_cuda needs CUDA tensors, got {dev}")
    for name, x in (("k", k), ("v", v), ("lengths", lengths)):
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"q, k, v have dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; want all float32 or all bfloat16")
    if lengths.dtype != torch.int32:
        raise ValueError(f"lengths has dtype {lengths.dtype}, want "
                         f"torch.int32")
    if q.dim() != 3 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"want q [B, H, D] and k, v [B, S, KVH, D], got "
                         f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    (b, h, d), (_, s, kvh, _) = q.shape, k.shape
    if k.shape[0] != b or k.shape[3] != d or tuple(lengths.shape) != (b,):
        raise ValueError(f"shapes do not agree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, lengths {tuple(lengths.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} unsupported; want one of "
                         f"{HEAD_DIMS}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads do not divide into {kvh} KV "
                         f"heads")
    for name, x in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if name != "lengths" and x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned (the kernel "
                             f"reads 16-byte vectors)")
    if max(b, s, h) >= 2 ** 31:
        raise ValueError(f"unsupported shape: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")


def _launch(q, k, v, lengths, route=None, return_lse=False):
    dev = q.device
    (b, h, d), (_, s, kvh, _) = q.shape, k.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h), dtype=torch.float32, device=dev) \
        if return_lse else None
    if b == 0 or h == 0 or s == 0:
        out.zero_()
        return (out, lse.fill_(-torch.inf)) if return_lse else out
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    p = plan(b, kvh, h, s, d, q.dtype, sms) if route is None else \
        cut(route, b, kvh, h, s, sms)
    part_acc = torch.empty((b * h, p.n_splits, d), dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty((b * h, p.n_splits, 2), dtype=torch.float32,
                          device=dev)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
            lse.data_ptr() if return_lse else None)
    if p.route == "mma":
        err = common.launch(dev, _entry("flash_decode_mma_launch"), *ptrs,
                            b, s, h, kvh, d, p.split_len, p.n_splits)
    else:
        err = common.launch(dev, _entry(), *ptrs, b, s, h, kvh, d, p.heads,
                            p.split_len, p.n_splits,
                            _DTYPE_CODES[q.dtype])
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: cudaError {err}")
    launches.add()
    return (out, lse) if return_lse else out


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lengths: torch.Tensor, return_lse: bool = False):
    """Launch the route :func:`plan` picks, on CUDA tensors; raises on
    anything the kernel does not take.  Returns the output, or (output,
    lse) with ``return_lse``."""
    _check(q, k, v, lengths)
    return _launch(q, k, v, lengths, return_lse=return_lse)


def _simt_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lengths: torch.Tensor, return_lse: bool = False):
    """The CUDA-core route whatever the plan (to time it beside the
    tensor cores in bfloat16, and to hold its LSE output)."""
    _check(q, k, v, lengths)
    return _launch(q, k, v, lengths, "simt", return_lse)
