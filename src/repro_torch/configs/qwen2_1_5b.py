"""qwen2-1.5b [arXiv:2407.10671; hf]: dense 28L d_model=1536 12H
(GQA kv=2) d_ff=8960 vocab=151936, QKV bias.

The port's own copy of ``repro.configs.qwen2_1_5b``, values verbatim.
``CONFIG.tp`` is the reference's 16, which pads the 12 query heads to 16
for a 16-way mesh; on one card use ``dataclasses.replace(CONFIG,
tp=1)``, which keeps the published 12 heads."""

from repro_torch.configs.common import LM_SHAPES, ArchSpec
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen2-1.5b",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab=151936, d_head=128, attn="gqa", qkv_bias=True,
)

SMOKE = TransformerConfig(
    name="qwen2-1.5b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    d_head=16, attn="gqa", qkv_bias=True, tp=2, max_seq=64,
)

SPEC = ArchSpec(arch_id="qwen2-1.5b", family="lm", config=CONFIG,
                smoke=SMOKE, shapes=LM_SHAPES,
                source="arXiv:2407.10671; hf")
