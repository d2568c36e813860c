"""Shared model building blocks (port of part of ``repro.models.common``).

The initialiser, RMSNorm, SwiGLU and the ``{"w", "b"}`` linear layer
the ported models use; ``softmax_cross_entropy`` waits for the training
slice.  Randomness comes from an explicit ``torch.Generator``; it gives
other numbers than ``jax.random`` from the same seed, so tests carry the
reference's parameters across instead (``PNA.load_reference_params``,
``transformer.load_reference_params``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.graph import resolve_device


def dense_init(d_in: int, d_out: int, *, generator: torch.Generator,
               dtype=torch.float32, device="cuda",
               scale: float | None = None, lead: tuple = ()) -> torch.Tensor:
    """[*lead, d_in, d_out] weights drawn N(0, 1) * ``scale`` (default
    1 / sqrt(d_in)), in the reference's [in, out] layout; ``lead`` adds
    leading axes (the LM's stacked layers)."""
    device = resolve_device(device)
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
