"""Config registry and the four input shapes (``repro.configs.base``):
all ten architectures of the reference's zoo, each a module exporting
``CONFIG`` and ``REDUCED``; an unknown id raises ``KeyError``.
"""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = (
    "qwen2_5_32b",
    "rwkv6_1_6b",
    "internvl2_76b",
    "minicpm_2b",
    "internlm2_1_8b",
    "jamba_v0_1_52b",
    "qwen2_5_3b",
    "deepseek_v2_lite_16b",
    "kimi_k2_1t_a32b",
    "musicgen_medium",
)

# canonical external ids (hyphenated) -> module names
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
ALIASES.update({
    "qwen2.5-32b": "qwen2_5_32b", "qwen2.5-3b": "qwen2_5_3b",
    "rwkv6-1.6b": "rwkv6_1_6b", "internvl2-76b": "internvl2_76b",
    "minicpm-2b": "minicpm_2b", "internlm2-1.8b": "internlm2_1_8b",
    "jamba-v0.1-52b": "jamba_v0_1_52b", "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b", "musicgen-medium": "musicgen_medium",
})


def _module(arch_id: str):
    name = ALIASES.get(arch_id, arch_id)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch_id!r}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch_id: str):
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str):
    return _module(arch_id).REDUCED


# ---------------------------------------------------------------------------
# Assigned input shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

SWA_WINDOW = 8_192  # sliding-window width for the long-context dense variant


def shape_for(name: str) -> InputShape:
    return INPUT_SHAPES[name]


def adapt_for_shape(cfg, shape: InputShape):
    """Per-shape config adaptation:

    - ``long_500k`` on architectures with any full-attention layer switches to
      the sliding-window variant (``window=SWA_WINDOW``, ``arch_id + "+swa"``);
      SSM layers are unaffected;
    - training chunks the LM loss to bound logits memory.
    """
    changes = {}
    if shape.name == "long_500k" and "attn" in cfg.block_pattern and cfg.window is None:
        changes["window"] = SWA_WINDOW
        changes["arch_id"] = cfg.arch_id + "+swa"
    if shape.kind == "train":
        if cfg.loss_chunk == 0:
            changes["loss_chunk"] = 1_024
        changes["remat"] = True      # activation checkpointing per super-block
    return dataclasses.replace(cfg, **changes) if changes else cfg
