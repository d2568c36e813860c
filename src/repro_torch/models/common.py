"""Shared model building blocks (port of part of ``repro.models.common``).

Only the initialiser the ported models use.  Randomness comes from an
explicit ``torch.Generator``; it gives other numbers than
``jax.random`` from the same seed, so tests carry the reference's
parameters across instead (``PNA.load_reference_params``).
"""

from __future__ import annotations

import math

import torch


def dense_init(d_in: int, d_out: int, *, generator: torch.Generator,
               dtype=torch.float32, device="cpu",
               scale: float | None = None) -> torch.Tensor:
    """[d_in, d_out] weights drawn N(0, 1) * ``scale`` (default
    1 / sqrt(d_in)), in the reference's [in, out] layout."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator,
                    dtype=torch.float32, device=generator.device) * scale
    return w.to(device=device, dtype=dtype)
