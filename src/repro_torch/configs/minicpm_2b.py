"""minicpm-2b [dense] — MHA (kv=36), WSD LR schedule, tied embeddings.
[arXiv:2404.06395]"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    arch_id="minicpm-2b", family="dense", source="arXiv:2404.06395",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
    d_ff=5760, vocab_size=122753, tie_embeddings=True,
    # §Perf iteration 7: 122753 defeats 16-way vocab sharding (prime-ish);
    # padding rows to a 128 multiple restores it (-36% flops, -31% HBM).
    # Logical vocab stays 122753; pad logits are masked out of the softmax.
    vocab_pad_to=128,
)

REDUCED = ModelConfig(
    arch_id="minicpm-2b-reduced", family="dense", source=CONFIG.source,
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
    d_ff=512, vocab_size=512, tie_embeddings=True,
)
