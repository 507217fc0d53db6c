"""internvl2-76b [vlm] — InternViT (stub frontend) + LLM backbone. [arXiv:2404.16821]

The vision encoder is a harness carve-out: ``input_specs()`` supplies
precomputed patch embeddings; only the projector + decoder are implemented.
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-76b", family="vlm", source="arXiv:2404.16821",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab_size=128256, rope_theta=5e5,
    frontend="vision", d_frontend=3200, n_frontend_tokens=256,
)

REDUCED = ModelConfig(
    arch_id="internvl2-76b-reduced", family="vlm", source=CONFIG.source,
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab_size=512,
    frontend="vision", d_frontend=64, n_frontend_tokens=8,
)
