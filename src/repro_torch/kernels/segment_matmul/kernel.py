"""The segment_matmul CUDA kernel's launching wrapper
(``csrc/segment_matmul.cu``).

Replaces the Pallas TPU kernel ``_kernel`` of
``src/repro/kernels/segment_matmul/kernel.py:34``.  Takes vals float32
or bfloat16 [E, D] and dst int32 [E], and returns [N, D] in the dtype of
vals: ``out[i]`` is the fp32 sum of the rows ``vals[e]`` with
``dst[e] == i``, cast once; ids outside [0, N), negatives included, are
dropped, and a segment with no edge gets zeros.  The result is the same
bit for bit from launch to launch (no float atomics).

The wrapper sorts dst stably (``torch.sort``: the order the kernel reads
vals in, not a permuted copy of vals), checks device, dtype, shape and
contiguity, allocates the output and the kernel's scratch with
``torch.empty``, launches on the current stream, raises if
``cudaGetLastError`` reports a failed launch, and counts the launch in
:data:`launches`.  It never falls back to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common

#: Launches of the segment_matmul kernel (the main-path proof counter).
launches = common.LaunchCounter("segment_matmul")

#: Sorted edge positions per chunk: the unit of work of the kernel's
#: first pass, so a long segment is summed by many warps.
CHUNK = 128

#: vals dtypes the kernel takes, and the code its C entry expects.
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _entry():
    lib = common.load("segment_matmul")
    fn = lib.segment_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def chunks(num_edges: int) -> int:
    """The kernel's chunks of sorted edge positions for ``num_edges``."""
    return -(-num_edges // CHUNK)


def segment_matmul_cuda(vals: torch.Tensor, dst: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises on anything it does not
    take."""
    dev = vals.device
    if dev.type != "cuda":
        raise ValueError(f"segment_matmul_cuda needs CUDA tensors, got {dev}")
    if dst.device != dev:
        raise ValueError(f"dst on {dst.device}, vals on {dev}")
    if vals.dtype not in _DTYPE_CODES:
        raise ValueError(f"vals has dtype {vals.dtype}, want float32 or "
                         f"bfloat16")
    if dst.dtype != torch.int32:
        raise ValueError(f"dst has dtype {dst.dtype}, want torch.int32")
    if vals.dim() != 2 or dst.dim() != 1 or dst.shape[0] != vals.shape[0]:
        raise ValueError(f"want vals [E, D] and dst [E], got shape "
                         f"{tuple(vals.shape)} and {tuple(dst.shape)}")
    if num_segments < 0:
        raise ValueError(f"num_segments {num_segments} < 0")
    for name, x in (("vals", vals), ("dst", dst)):
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    e, d = vals.shape
    out = torch.empty((num_segments, d), dtype=vals.dtype, device=dev)
    if num_segments == 0 or d == 0:
        return out
    if e >= 2 ** 31 or d >= 2 ** 31 or num_segments >= 2 ** 31 - 1:
        raise ValueError(f"unsupported shape: vals {tuple(vals.shape)}, "
                         f"{num_segments} segments")
    skey, perm = torch.sort(dst, stable=True)
    starts = torch.empty(num_segments + 1, dtype=torch.int64, device=dev)
    partial = torch.empty((chunks(e), 2, d), dtype=torch.float32, device=dev)
    align = 4 * vals.element_size()
    vec4 = int(d % 4 == 0 and vals.data_ptr() % align == 0
               and out.data_ptr() % align == 0)
    fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(vals.data_ptr(), skey.data_ptr(), perm.data_ptr(),
                 starts.data_ptr(), partial.data_ptr(), out.data_ptr(), e,
                 num_segments, d, CHUNK, _DTYPE_CODES[vals.dtype], vec4,
                 stream)
    if err != 0:
        raise RuntimeError(f"segment_matmul launch failed: cudaError {err}")
    launches.count += 1
    return out
