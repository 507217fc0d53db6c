"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8.
[arXiv:2501.kimi2 (paper-table)]

Assigned spec: 61L, d_model=7168, 64H (GQA kv=8), per-expert d_ff=2048,
vocab=163840, 384 routed experts top-8 (+1 shared, K2 card), first layer dense.
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    arch_id="kimi-k2-1t-a32b", family="moe", source="arXiv:2501.kimi2",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=18432, vocab_size=163840, rope_theta=5e4,
    moe=True, n_experts=384, top_k=8, moe_d_ff=2048,
    n_shared_experts=1, shared_d_ff=2048, first_k_dense=1,
    moe_group_size=1024,
)

REDUCED = ModelConfig(
    arch_id="kimi-k2-1t-a32b-reduced", family="moe", source=CONFIG.source,
    n_layers=3, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab_size=512,
    moe=True, n_experts=4, top_k=2, moe_d_ff=128,
    n_shared_experts=1, shared_d_ff=128, first_k_dense=1, moe_group_size=128,
)
