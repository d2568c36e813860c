"""qwen2-7b [arXiv:2407.10671; hf]: dense 28L d_model=3584 28H
(GQA kv=4) d_ff=18944 vocab=152064, QKV bias.

The port's own copy of ``repro.configs.qwen2_7b``, values verbatim.
``CONFIG.tp`` is the reference's 16, which pads the 28 query heads to
32 for a 16-way mesh; on one card use ``dataclasses.replace(CONFIG,
tp=1)``, which keeps the published 28 heads (a GQA group of 7)."""

from repro_torch.configs.common import LM_SHAPES, ArchSpec
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen2-7b",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
    vocab=152064, d_head=128, attn="gqa", qkv_bias=True,
)

SMOKE = TransformerConfig(
    name="qwen2-7b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    d_head=16, attn="gqa", qkv_bias=True, tp=2, max_seq=64,
)

SPEC = ArchSpec(arch_id="qwen2-7b", family="lm", config=CONFIG,
                smoke=SMOKE, shapes=LM_SHAPES,
                source="arXiv:2407.10671; hf")
