"""musicgen-medium [audio] — decoder-only over EnCodec tokens. [arXiv:2306.05284]

The EnCodec encoder is a harness carve-out: inputs are already-discrete codec
tokens (vocab 2048), so the frontend is the plain token embedding.
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    arch_id="musicgen-medium", family="audio", source="arXiv:2306.05284",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048,
)

REDUCED = ModelConfig(
    arch_id="musicgen-medium-reduced", family="audio", source=CONFIG.source,
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
    d_ff=512, vocab_size=256,
)
