"""qwen2.5-32b [dense] — GQA (kv=8), QKV bias. [hf:Qwen/Qwen2.5-0.5B family card]"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2.5-32b", family="dense", source="hf:Qwen/Qwen2.5-0.5B",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=27648, vocab_size=152064, qkv_bias=True, rope_theta=1e6,
)

REDUCED = ModelConfig(
    arch_id="qwen2.5-32b-reduced", family="dense", source=CONFIG.source,
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab_size=512, qkv_bias=True,
)
