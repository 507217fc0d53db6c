"""Model zoo (``repro.models``): composable decoder-only stacks covering the
ten architectures (GQA with an optional sliding window, MLA, Mamba, RWKV6;
dense or mixture-of-experts ffns; a vision frontend's projector).
Functional PyTorch: ``init_params(cfg, generator) -> params`` trees and
plain ``forward / prefill / decode_step / lm_loss`` functions over them."""
from repro_torch.models.transformer import (  # noqa: F401
    ModelConfig,
    decode_step,
    forward,
    init_decode_state,
    init_params,
    lm_loss,
    prefill,
)
