"""Shared model building blocks (port of part of ``repro.models.common``).

The initialiser, RMSNorm, SwiGLU, ``softmax_cross_entropy`` and the
``{"w", "b"}`` linear layer the ported models use, and its module form
for the GNNs (``Dense``, ``MLP``: the weight kept in the reference's
``[in, out]`` layout).  Randomness comes from an explicit
``torch.Generator``; it gives other numbers than ``jax.random`` from the
same seed, so tests carry the reference's parameters across instead
(``PNA.load_reference_params``, :func:`load_tree` for the trees of the
LM and DIEN).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.graph import resolve_device


def dense_init(d_in: int, d_out: int, *, generator: torch.Generator,
               dtype=torch.float32, device="cuda",
               scale: float | None = None, lead: tuple = ()) -> torch.Tensor:
    """[*lead, d_in, d_out] weights drawn N(0, 1) * ``scale`` (default
    1 / sqrt(d_in)), in the reference's [in, out] layout; ``lead`` adds
    leading axes (the LM's stacked layers).  On the meta device only
    the shape and dtype are made: nothing is drawn."""
    device = resolve_device(device)
    if device.type == "meta":
        return torch.empty((*lead, d_in, d_out), dtype=dtype, device=device)
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((*lead, d_in, d_out), generator=generator,
                    dtype=torch.float32, device=generator.device)
    return (w * scale).to(device=device, dtype=dtype)


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ p["w"]`` plus ``p["b"]`` where the layer has one."""
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rms_norm(g: torch.Tensor, x: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in float32 and cast back to x's dtype."""
    x32 = x.float()
    norm = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (norm * g.float()).to(x.dtype)


def init_rms(d: int, *, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """The RMSNorm gain, ones [d]."""
    return torch.ones((d,), dtype=dtype, device=resolve_device(device))


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over tokens: float32 logsumexp of ``logits [..., V]``
    minus the label's logit.  The reference selects the label's logit
    with an iota compare (which keeps a vocab-sharded mesh elementwise);
    on one card a gather reads the same number."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels[..., None].long())[..., 0]
    return (logz - ll).mean()


def to_tensor(a, device) -> torch.Tensor:
    """A numpy array (bfloat16 from ml_dtypes too) as a tensor on
    ``device``, bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # numpy has no bfloat16 of its own
        t = torch.from_numpy(np.array(a).view(np.uint16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def load_tree(tree, *, device="cuda"):
    """A reference tree of numpy arrays (dicts, lists, tuples, named
    tuples) as the same tree of tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: load_tree(v, device=dev) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(load_tree(v, device=dev) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(load_tree(v, device=dev) for v in tree)
    return to_tensor(tree, dev)


class Dense(nn.Module):
    """``x @ w + b`` with ``w`` [d_in, d_out] in the reference's layout,
    drawn by ``dense_init``; the bias starts at zero."""

    def __init__(self, d_in: int, d_out: int, *, generator, dtype,
                 device) -> None:
        super().__init__()
        self.w = nn.Parameter(dense_init(d_in, d_out, generator=generator,
                                         dtype=dtype, device=device))
        self.b = nn.Parameter(torch.zeros(d_out, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b

    def load(self, p) -> None:
        """Copy a reference ``{"w", "b"}`` layer."""
        copy_param(self.w, p["w"])
        copy_param(self.b, p["b"])


@torch.no_grad()
def copy_param(dst: torch.Tensor, src) -> None:
    """Copy a reference array into ``dst``, raising on a shape that does
    not fit."""
    src = torch.from_numpy(np.array(src))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"reference array {tuple(src.shape)} does not "
                         f"fit {tuple(dst.shape)}")
    dst.copy_(src)


class MLP(nn.Module):
    """The reference's ``_mlp``: SiLU between layers, and after the last
    one when ``last_act``."""

    def __init__(self, dims, *, generator, dtype, device) -> None:
        super().__init__()
        self.layers = nn.ModuleList(
            Dense(a, b, generator=generator, dtype=dtype, device=device)
            for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor, last_act: bool = False):
        for i, lay in enumerate(self.layers):
            x = lay(x)
            if i < len(self.layers) - 1 or last_act:
                x = F.silu(x)
        return x

    def load(self, p) -> None:
        if len(p) != len(self.layers):
            raise ValueError(f"reference MLP has {len(p)} layers, this one "
                             f"{len(self.layers)}")
        for lay, q in zip(self.layers, p):
            lay.load(q)
