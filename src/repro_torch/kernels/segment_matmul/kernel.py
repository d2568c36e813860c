"""The segment_matmul CUDA kernel's launching wrapper
(``csrc/segment_matmul.cu``).

Replaces the Pallas TPU kernel ``_kernel`` of
``src/repro/kernels/segment_matmul/kernel.py:34``.  Takes vals float32
or bfloat16 [E, D] and dst int32 [E], and returns [N, D] in the dtype of
vals: ``out[i]`` is the fp32 sum of the rows ``vals[e]`` with
``dst[e] == i``, cast once; ids outside [0, N), negatives included, are
dropped, and a segment with no edge gets zeros.  The result is the same
bit for bit from launch to launch (no float atomics).

:func:`plan` picks one of the source's two designs from the shapes
(E, N, D, dtype) alone, never from the data and never from a failed
build or launch:

* ``"blocked"`` (few segments): one launch, no sort, no scratch; the
  wrapper allocates the output with one ``torch.empty``.
* ``"sorted"`` (many segments): the wrapper sorts dst stably
  (``torch.sort``: the order the kernel reads vals in, not a permuted
  copy of vals) and allocates the kernel's scratch; three launches.

The wrapper checks device, dtype, shape and contiguity, launches on the
current stream, raises if ``cudaGetLastError`` reports a failed launch,
and counts each call that launches in :data:`launches`.  It never falls
back to the plain version.  :func:`_sorted_cuda` and
:func:`_blocked_cuda` run one design whatever the plan, so that both can
be timed at one shape.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common

#: Launches of the segment_matmul kernel (the main-path proof counter).
launches = common.LaunchCounter("segment_matmul")

#: Sorted edge positions per chunk: the unit of work of the sorted
#: design's first pass, so a long segment is summed by many warps.
CHUNK = 128

#: fp32 elements of the rows one CTA of the blocked design owns
#: (segments x D): 8 KB of its 45 KB of shared memory.
BLOCK_ELEMS = 2048
#: The most bytes of vals the blocked design gives one CTA on average:
#: beyond it the sorted design's chunks spread the rows wider.
BLOCK_VAL_BYTES = 256 * 1024

#: vals dtypes the kernel takes, and the code its C entry expects.
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2}


def _entry(name: str):
    fn = getattr(common.load("segment_matmul"), name)
    if fn.argtypes is None:
        if name == "segment_matmul_launch":
            fn.argtypes = [ctypes.c_void_p] * 6 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def chunks(num_edges: int) -> int:
    """The sorted design's chunks of edge positions for ``num_edges``."""
    return -(-num_edges // CHUNK)


def block_segments(d: int) -> int:
    """Segments one CTA of the blocked design owns at width ``d`` (0
    where even 8 rows would not fit, one for each of its warps)."""
    nblk = min(256, BLOCK_ELEMS // d) if d > 0 else 0
    return nblk if nblk >= 8 else 0


def plan(num_edges: int, num_segments: int, d: int,
         dtype: torch.dtype) -> str:
    """``"blocked"`` or ``"sorted"`` for these shapes.

    Every CTA of the blocked design reads all of dst, from L2 after the
    first: ``4 E ceil(N / nblk)`` bytes of ids beside ``E D s`` bytes of
    vals.  It is taken where those ids are no more than the bytes of
    vals, and where its CTAs are enough for vals (no more than
    :data:`BLOCK_VAL_BYTES` a CTA on average).  At D = 128 in float32
    that is N <= 2048 and E <= 32 N; the kernel microbench (E 16384,
    N 2048) is blocked, the dspc graph (N 65536) sorted."""
    nblk = block_segments(d)
    if nblk == 0 or num_segments <= 0:
        return "sorted"
    ctas = -(-num_segments // nblk)
    val_bytes = num_edges * d * _ELEMENT_BYTES[dtype]
    if 4 * num_edges * ctas <= val_bytes <= ctas * BLOCK_VAL_BYTES:
        return "blocked"
    return "sorted"


def summation_depth(design: str, longest: int) -> int:
    """The most float32 adds any term passes through on its way to the
    output, for a longest segment of ``longest`` edges: inside a chunk,
    then one per chunk its segment spans (sorted); the adds of its
    segment, one after another in id order (blocked)."""
    if design == "blocked":
        return longest
    return CHUNK + longest // CHUNK + 2


def _check(vals: torch.Tensor, dst: torch.Tensor, num_segments: int) -> None:
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
    if e >= 2 ** 31 or d >= 2 ** 31 or num_segments >= 2 ** 31 - 1:
        raise ValueError(f"unsupported shape: vals {tuple(vals.shape)}, "
                         f"{num_segments} segments")


def _vec4(vals: torch.Tensor, out: torch.Tensor) -> int:
    align = 4 * vals.element_size()
    return int(vals.shape[1] % 4 == 0 and vals.data_ptr() % align == 0
               and out.data_ptr() % align == 0)


def _launched(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"segment_matmul launch failed: cudaError {err}")
    launches.count += 1


def _launch_sorted(vals, dst, num_segments):
    dev = vals.device
    e, d = vals.shape
    out = torch.empty((num_segments, d), dtype=vals.dtype, device=dev)
    if num_segments == 0 or d == 0:
        return out
    skey, perm = torch.sort(dst, stable=True)
    starts = torch.empty(num_segments + 1, dtype=torch.int64, device=dev)
    partial = torch.empty((chunks(e), 2, d), dtype=torch.float32, device=dev)
    _launched(common.launch(dev, _entry("segment_matmul_launch"),
                            vals.data_ptr(), skey.data_ptr(),
                            perm.data_ptr(), starts.data_ptr(),
                            partial.data_ptr(), out.data_ptr(), e,
                            num_segments, d, CHUNK,
                            _DTYPE_CODES[vals.dtype], _vec4(vals, out)))
    return out


def _launch_blocked(vals, dst, num_segments):
    dev = vals.device
    e, d = vals.shape
    out = torch.empty((num_segments, d), dtype=vals.dtype, device=dev)
    if num_segments == 0 or d == 0:
        return out
    nblk = block_segments(d)
    if nblk == 0:
        raise ValueError(f"the blocked design takes D <= {BLOCK_ELEMS // 8}, "
                         f"got {d}")
    _launched(common.launch(dev, _entry("segment_matmul_blocked_launch"),
                            vals.data_ptr(), dst.data_ptr(), out.data_ptr(),
                            e, num_segments, d, nblk,
                            _DTYPE_CODES[vals.dtype], _vec4(vals, out),
                            int(dst.data_ptr() % 16 == 0)))
    return out


def segment_matmul_cuda(vals: torch.Tensor, dst: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """Launch the design :func:`plan` picks, on CUDA tensors; raises on
    anything the kernel does not take."""
    _check(vals, dst, num_segments)
    if plan(vals.shape[0], num_segments, vals.shape[1],
            vals.dtype) == "blocked":
        return _launch_blocked(vals, dst, num_segments)
    return _launch_sorted(vals, dst, num_segments)


def _sorted_cuda(vals: torch.Tensor, dst: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """The sorted design whatever the plan (to time it beside the other)."""
    _check(vals, dst, num_segments)
    return _launch_sorted(vals, dst, num_segments)


def _blocked_cuda(vals: torch.Tensor, dst: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """The blocked design whatever the plan (to time it beside the
    other); raises where D is too wide for its shared memory."""
    _check(vals, dst, num_segments)
    return _launch_blocked(vals, dst, num_segments)
