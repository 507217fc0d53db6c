"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887]

Jamba block structure: period-8 super-block with attention at index 3
(attn_layer_offset=4 in the release, 1 attention per 8 layers) and MoE
replacing the MLP every 2 layers (offset 1).
"""
from repro_torch.models import ModelConfig

_PATTERN = ("mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba", "mamba")

CONFIG = ModelConfig(
    arch_id="jamba-v0.1-52b", family="hybrid", source="arXiv:2403.19887",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=65536, block_pattern=_PATTERN,
    moe=True, n_experts=16, top_k=2, moe_d_ff=14336,
    moe_every=2, moe_offset=1,
    mamba_d_state=16, mamba_expand=2, mamba_conv_width=4,
)

REDUCED = ModelConfig(
    arch_id="jamba-v0.1-52b-reduced", family="hybrid", source=CONFIG.source,
    n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab_size=512, block_pattern=("mamba", "attn"),
    moe=True, n_experts=4, top_k=2, moe_d_ff=256,
    moe_every=2, moe_offset=1, moe_group_size=128,
)
