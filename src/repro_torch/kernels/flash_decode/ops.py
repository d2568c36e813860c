"""GQA decode-attention entry point (port of
``repro.kernels.flash_decode.ops``).

The device decides the route: CUDA tensors launch the kernel (or
raise), CPU tensors take the plain version, and meta tensors (a dry
run, ``launch.dryrun``) get empty outputs of the right shapes and
dtypes, launching nothing.  Every route charges the kernel's
:func:`~repro_torch.kernels.flash_decode.kernel.cost` to a dry run's
count (``launch.mesh.kernel_cost``).  There is no fallback from one
route to another, and the reference's ``use_kernel`` and ``block_*``
flags have no counterpart.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_decode.kernel import cost, flash_decode_cuda
from repro_torch.kernels.flash_decode.ref import decode_attention_ref
from repro_torch.launch.mesh import kernel_cost


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, return_lse: bool = False):
    """q [B, H, D]; k, v [B, S, KVH, D]; lengths int [B] -> [B, H, D],
    or (that, lse float32 [B, H]) with ``return_lse``: each row's
    log-sum-exp of its masked scaled scores, ``-inf`` at length 0 (the
    sequence-sharded decode merges shards by it).

    Query head h attends over KV head h // (H / KVH), masked to
    positions ``< lengths[b]``.  On the card the kernel reads the cache
    in this layout; the plain CPU route expands the KV heads as the
    reference does."""
    h, kvh = q.shape[1], k.shape[2]
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads do not divide into {kvh} KV "
                         f"heads")
    if q.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    b, _, d = q.shape
    with kernel_cost("flash_decode", *cost(b, h, kvh, k.shape[1], d,
                                           q.dtype)):
        if q.device.type == "cuda":
            return flash_decode_cuda(q.contiguous(), k.contiguous(),
                                     v.contiguous(),
                                     lengths.to(torch.int32).contiguous(),
                                     return_lse)
        if q.device.type == "meta":
            out = torch.empty_like(q)
            return (out, torch.empty((b, h), dtype=torch.float32,
                                     device=q.device)) if return_lse \
                else out
        return decode_attention_ref(q, k, v, lengths, return_lse)
