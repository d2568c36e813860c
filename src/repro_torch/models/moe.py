"""Feed-forward blocks of the LM (port of the dense part of
``repro.models.moe``).

Only the SwiGLU FFN of the dense configurations; ``init_moe`` and
``moe_ffn`` wait for the MoE slice.  Weights keep the reference's
[in, out] layout.
"""

from __future__ import annotations

import torch

from repro_torch.core.graph import resolve_device
from repro_torch.models.common import dense_init, swiglu


def init_dense_ffn(d: int, f: int, *, generator: torch.Generator,
                   dtype=torch.float32, device="cuda",
                   lead: tuple = ()) -> dict:
    """``{"w_gate", "w_up": [*lead, d, f], "w_down": [*lead, f, d]}``;
    ``lead`` stacks that many layers on leading axes."""
    kw = dict(generator=generator, dtype=dtype,
              device=resolve_device(device), lead=lead)
    return {"w_gate": dense_init(d, f, **kw), "w_up": dense_init(d, f, **kw),
            "w_down": dense_init(f, d, **kw)}


def dense_ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x @ p["w_gate"], x @ p["w_up"]) @ p["w_down"]
