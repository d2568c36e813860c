"""Plain PyTorch version of the flash_decode kernel.

``out[r] = softmax(q[r] . k[r, s] / sqrt(D), s < lengths[r]) @ v[r]``
for each of the BH rows, computed in float32 and cast to q's dtype, as
the kernel accumulates.  A row with length 0 gives zeros (the
reference's ``flash_decode_ref`` gives NaN there and its Pallas kernel
the mean of the padded V rows; the port takes the contract of
``acc / max(l, 1e-30)``).  With ``return_lse`` each row's natural
log-sum-exp of its masked scaled scores comes too, float32, ``-inf`` at
length 0: the kernel's optional second output.  :func:`decode_attention_ref`
is the same in the kernel's GQA layout.  The ops wrapper uses it for CPU tensors; on
the card it is what the kernel is held against.
"""

from __future__ import annotations

import math

import torch


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, return_lse: bool = False):
    """q [BH, D], k and v [BH, S, D], lengths int [BH] -> [BH, D] (and
    lse float32 [BH] with ``return_lse``)."""
    d = q.shape[-1]
    s = torch.einsum("bd,bsd->bs", q.float(), k.float()) / math.sqrt(d)
    pos = torch.arange(k.shape[1], device=k.device)
    s = s.masked_fill(pos[None, :] >= lengths[:, None], float("-inf"))
    m = s.amax(dim=1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    out = torch.einsum("bs,bsd->bd", p, v.float())
    den = p.sum(dim=1, keepdim=True)
    out = (out / den.clamp(min=1e-30)).to(q.dtype)
    if not return_lse:
        return out
    return out, (m + torch.log(den))[:, 0]


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, return_lse: bool = False):
    """q [B, H, D], k and v [B, S, KVH, D], lengths int [B] -> [B, H, D]
    (and lse float32 [B, H] with ``return_lse``).

    Query head h reads KV head h // (H / KVH): the KV heads are expanded
    to H as the reference does (``jnp.repeat`` over the head axis), which
    the kernel never does."""
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    kf = k.repeat_interleave(group, dim=2).transpose(1, 2).reshape(b * h, s, d)
    vf = v.repeat_interleave(group, dim=2).transpose(1, 2).reshape(b * h, s, d)
    lf = lengths.repeat_interleave(h)
    got = flash_decode_ref(q.reshape(b * h, d), kf, vf, lf, return_lse)
    if not return_lse:
        return got.reshape(b, h, d)
    return got[0].reshape(b, h, d), got[1].reshape(b, h)
