"""deepseek-v2-236b [arXiv:2405.04434; hf]: 60L d_model=5120 128H MLA,
MoE 2 shared + 160 routed top-6, moe d_ff=1536, vocab=102400,
kv_lora=512, q_lora=1536.

The port's own copy of ``repro.configs.deepseek_v2_236b``, values
verbatim.  Its 239 B parameters take about 479 GB in bfloat16, more than
four H100s hold: ``chip_smoke.py`` runs it at full width with its depth
cut."""

from repro_torch.configs.common import LM_SHAPES, ArchSpec
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="deepseek-v2-236b",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, d_ff=12288,
    vocab=102400, attn="mla",
    kv_lora=512, q_lora=1536, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
    moe_experts=160, moe_shared=2, moe_top_k=6, moe_d_ff=1536,
)

SMOKE = TransformerConfig(
    name="deepseek-v2-236b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    d_head=16, attn="mla",
    kv_lora=32, q_lora=48, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    moe_experts=8, moe_shared=2, moe_top_k=2, moe_d_ff=32,
    tp=2, max_seq=64,
)

SPEC = ArchSpec(arch_id="deepseek-v2-236b", family="lm", config=CONFIG,
                smoke=SMOKE, shapes=LM_SHAPES,
                source="arXiv:2405.04434; hf")
