"""The flash_decode CUDA kernel's launching wrapper
(``csrc/flash_decode.cu``).

Replaces the Pallas TPU kernel ``_kernel`` of
``src/repro/kernels/flash_decode/kernel.py:32``.  Takes q [B, H, D] and
the cache k, v [B, S, KVH, D] in its own layout -- query head h reads KV
head h // (H / KVH), nothing is expanded to H heads -- with lengths
int32 [B], all float32 or all bfloat16, D in {16, 32, 64, 128}.
Returns [B, H, D] in q's dtype: the fp32 softmax over positions
``< lengths[b]`` of the scaled scores, times V (zeros at length 0).

The wrapper checks device, dtype, shape, contiguity and alignment,
splits S with :func:`plan`, allocates the output and the fp32 per-split
scratch with ``torch.empty``, launches both passes on the current
stream, raises if ``cudaGetLastError`` reports a failed launch, and
counts the call in :data:`launches`.  It never falls back to the plain
version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common

#: Launches of the flash_decode kernel (the main-path proof counter).
launches = common.LaunchCounter("flash_decode")

#: Input dtypes the kernel takes, and the code its C entry expects.
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
#: Cache positions per tile (``kTile`` in the source); spans are
#: multiples of it.
TILE = 64
#: CTAs to aim for per SM: 4 waves of 2 resident CTAs.
CTAS_PER_SM = 8


def plan(b: int, kvh: int, h: int, s: int, sms: int):
    """How the kernel cuts the work: ``(kg, n_chunks, split_len,
    n_splits)``.  ``kg`` query heads (1, 2, 4 or 8) share one read of a
    KV head's rows in a CTA, ``n_chunks`` CTAs cover its group, and S
    is cut into ``n_splits`` spans of ``split_len`` positions (a
    multiple of :data:`TILE`) so that about ``CTAS_PER_SM * sms`` CTAs
    run.  Spans are cut from S, not from the lengths, so no length is
    read on the host."""
    group = h // kvh
    kg = next(c for c in (1, 2, 4, 8) if c >= min(group, 8))
    n_chunks = -(-group // kg)
    rows = b * kvh * n_chunks
    tiles = -(-s // TILE)
    want = max(1, min(tiles, -(-CTAS_PER_SM * sms // rows), 65535))
    split_len = -(-tiles // want) * TILE
    return kg, n_chunks, split_len, -(-s // split_len)


def _entry():
    lib = common.load("flash_decode")
    fn = lib.flash_decode_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises on anything it does not
    take."""
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
    out = torch.empty_like(q)
    if b == 0 or h == 0 or s == 0:
        return out.zero_()
    if max(b, s, h) >= 2 ** 31:
        raise ValueError(f"unsupported shape: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    kg, _, split_len, n_splits = plan(b, kvh, h, s, sms)
    part_acc = torch.empty((b * h, n_splits, d), dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty((b * h, n_splits, 2), dtype=torch.float32,
                          device=dev)
    fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
                 part_ml.data_ptr(), b, s, h, kvh, d, kg, split_len,
                 n_splits, _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: cudaError {err}")
    launches.count += 1
    return out

