"""deepseek-v2-lite-16b [arXiv:2405.04434; hf]: 27L d_model=2048 16H MLA,
MoE 2 shared + 64 routed top-6, moe d_ff=1408, vocab=102400, kv_lora=512
(no q compression in the lite model).

The port's own copy of ``repro.configs.deepseek_v2_lite_16b``, values
verbatim: every layer is MoE, as in the reference.  The 16 heads need
no padding at ``tp = 16``; the MLA cache is ``kv_lora + qk_rope_dim =
576`` values a token and layer."""

from repro_torch.configs.common import LM_SHAPES, ArchSpec
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=10944,
    vocab=102400, attn="mla",
    kv_lora=512, q_lora=0, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    moe_experts=64, moe_shared=2, moe_top_k=6, moe_d_ff=1408,
)

SMOKE = TransformerConfig(
    name="deepseek-v2-lite-16b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    d_head=16, attn="mla",
    kv_lora=32, q_lora=0, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    moe_experts=8, moe_shared=2, moe_top_k=2, moe_d_ff=32,
    tp=2, max_seq=64,
)

SPEC = ArchSpec(arch_id="deepseek-v2-lite-16b", family="lm", config=CONFIG,
                smoke=SMOKE, shapes=LM_SHAPES,
                source="arXiv:2405.04434; hf")
