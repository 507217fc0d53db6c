"""rwkv6-1.6b "Finch" [ssm] — attention-free, data-dependent decay. [arXiv:2404.05892]

head dim 64 (RWKV6 convention) => 32 heads at d_model=2048.
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-1.6b", family="ssm", source="arXiv:2404.05892",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab_size=65536, block_pattern=("rwkv6",),
    rwkv_lora_rank=32, rwkv_w_lora_rank=64,
)

REDUCED = ModelConfig(
    arch_id="rwkv6-1.6b-reduced", family="ssm", source=CONFIG.source,
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
    d_ff=512, vocab_size=512, block_pattern=("rwkv6",),
    rwkv_lora_rank=8, rwkv_w_lora_rank=8,
)
