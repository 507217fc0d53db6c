"""internlm2-1.8b [dense] — GQA (kv=8). [arXiv:2403.17297]"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    arch_id="internlm2-1.8b", family="dense", source="arXiv:2403.17297",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab_size=92544, rope_theta=1e6,
)

REDUCED = ModelConfig(
    arch_id="internlm2-1.8b-reduced", family="dense", source=CONFIG.source,
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab_size=512,
)
