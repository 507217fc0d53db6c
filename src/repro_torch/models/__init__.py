"""Model zoo (``repro.models``), for the ported families: the GQA
transformer (with an optional sliding window) and RWKV6.  Functional
PyTorch: ``init_params(cfg, generator) -> params`` trees and plain
``forward / prefill / decode_step`` functions over them."""
from repro_torch.models.transformer import (  # noqa: F401
    ModelConfig,
    decode_step,
    forward,
    init_decode_state,
    init_params,
    prefill,
)
