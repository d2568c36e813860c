"""phi3-medium-14b [arXiv:2404.14219]: dense 40L d_model=5120 40H
(GQA kv=10) d_ff=17920 vocab=100352, RoPE + SwiGLU.

The port's own copy of ``repro.configs.phi3_medium_14b``, values
verbatim.  ``CONFIG.tp`` is the reference's 16, which pads the 40 query
heads to 48 over 10 KV heads (decode pads q to 10 x 5 = 50); on one card
``dataclasses.replace(CONFIG, tp=1)`` keeps the published 40 heads (a
GQA group of 4)."""

from repro_torch.configs.common import LM_SHAPES, ArchSpec
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="phi3-medium-14b",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, d_ff=17920,
    vocab=100352, d_head=128, attn="gqa",
)

SMOKE = TransformerConfig(
    name="phi3-medium-14b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    d_head=16, attn="gqa", tp=2, max_seq=64,
)

SPEC = ArchSpec(arch_id="phi3-medium-14b", family="lm", config=CONFIG,
                smoke=SMOKE, shapes=LM_SHAPES,
                source="arXiv:2404.14219; unverified")
