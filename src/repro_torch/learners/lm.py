"""Language models from the model zoo, as federated learner plugins (port
of ``repro.learners.lm``).

Each spec wraps ``repro_torch.models.transformer``'s composable decoder
(the zoo's GQA/SWA transformer, its MoE variant, and the RWKV6 hybrid)
into the ``ModelFns`` triple the round engine consumes.  Federated
specifics, as in the reference:

- ``param_dtype`` is fp32: updates travel as flat fp32 rows;
- ``loss`` returns per-sequence cross-entropy beside the mean, so Oort's
  statistical utility (``sqrt(mean(loss^2))``) works on token workloads;
- ``evaluate`` reports (next-token accuracy, mean NLL).

The port's learner contract (``repro_torch.learners.base``): leaves come
batched (R, ...), one row a learner.  The zoo's ``forward`` takes one
model's leaves (it indexes ``stack``'s leading axis), so ``loss`` and
``evaluate`` map a one-learner function over the rows with
``torch.func.vmap``: every matmul becomes a batched one, rows never mix,
and plain autograd through the map gives each learner its own gradient.

Token lookups and the gold logit are one-hot products under autograd
(``layers.embed_lookup``, ``transformer._onehot_gold``), and the MoE
dispatch and combine are gathers of index maps
(``repro_torch.models.moe``): no float atomics in the backward, so a
round's bits do not change from run to run on the card.

``use_kernels=1`` does not train: the zoo's attention and WKV6 kernels are
forward-only in both packages (and the reference fails in Pallas's JVP
rule at the default knobs), so it raises.
"""
from __future__ import annotations

import torch

from repro_torch.learners.base import Knob, ModelFns, ModelSpec
from repro_torch.learners.registry import register_model
from repro_torch.models import transformer as tf

_AUX_WEIGHT = 0.01   # MoE load-balance weight (matches transformer.lm_loss)


def _seq_xent(mcfg, params, x, y):
    """One model (unbatched leaves), x, y (B, S): (per-sequence mean
    next-token cross-entropy (B,), aux loss, logits (B, S, V))."""
    h, aux, _ = tf.forward(mcfg, params, {"tokens": x})
    logits = tf._logits(mcfg, params, h).float()
    logz = torch.logsumexp(logits, dim=-1)
    return (logz - tf._onehot_gold(logits, y)).mean(dim=-1), aux, logits


def _fns_for(mcfg: tf.ModelConfig) -> ModelFns:
    def one(params, x, y):
        return _seq_xent(mcfg, params, x, y)

    mapped = torch.func.vmap(one)

    def init(generator):
        return tf.init_params(mcfg, generator)

    def loss(params, x, y):
        """Leaves (R, ...), x, y (R, B, S): (mean loss + 0.01 aux (R,),
        per-sequence losses (R, B))."""
        per_seq, aux, _ = mapped(params, x, y)
        return per_seq.mean(dim=-1) + _AUX_WEIGHT * aux, per_seq

    @torch.no_grad()
    def evaluate(params, x, y):
        """Leaves (L, ...), x, y (L, N, S): (next-token accuracy (L,), mean
        NLL (L,)).  A model's accuracy is an exact count over its own
        logits, and its NLL the mean of its own row of losses, so neither
        depends on L."""
        per_seq, _, logits = mapped(params, x, y)
        acc = (logits.argmax(-1) == y).to(torch.float32).flatten(1).mean(-1)
        return acc, torch.stack([row.mean() for row in per_seq])

    return ModelFns(init=init, loss=loss, evaluate=evaluate)


_BASE_KNOBS = (
    Knob("n_layers", 2, "decoder layers"),
    Knob("d_model", 64, "model width"),
    Knob("n_heads", 2, "attention / wkv heads"),
    Knob("d_ff", 128, "dense SwiGLU width"),
)


def _no_kernels(knobs: dict) -> None:
    if int(knobs["use_kernels"]):
        raise NotImplementedError(
            "use_kernels=1 on an LM learner (training through the forward-"
            "only attention / WKV6 kernels) is not ported to repro_torch yet "
            "(ROADMAP.md queue 1 item 13)")


def _base_cfg(knobs: dict, meta, **over) -> tf.ModelConfig:
    return tf.ModelConfig(
        n_layers=int(knobs["n_layers"]),
        d_model=int(knobs["d_model"]),
        n_heads=int(knobs["n_heads"]),
        n_kv_heads=int(knobs["n_heads"]),
        d_ff=int(knobs["d_ff"]),
        vocab_size=int(meta.vocab),
        param_dtype=torch.float32,
        **over)


def _build_transformer(knobs: dict, meta) -> ModelFns:
    _no_kernels(knobs)
    window = int(knobs["window"])
    return _fns_for(_base_cfg(
        knobs, meta, arch_id="fl-transformer",
        window=window if window > 0 else None))


def _build_moe(knobs: dict, meta) -> ModelFns:
    return _fns_for(_base_cfg(
        knobs, meta, arch_id="fl-moe", family="moe", moe=True,
        n_experts=int(knobs["n_experts"]), top_k=int(knobs["top_k"]),
        moe_d_ff=int(knobs["moe_d_ff"])))


def _build_rwkv6(knobs: dict, meta) -> ModelFns:
    _no_kernels(knobs)
    return _fns_for(_base_cfg(
        knobs, meta, arch_id="fl-rwkv6", family="hybrid",
        block_pattern=("rwkv6",)))


register_model(ModelSpec(
    name="transformer",
    build=_build_transformer,
    doc="decoder-only GQA transformer LM (optional sliding-window attention)",
    data_kind="tokens",
    family="dense",
    kernel="swa attention (CUDA, use_kernels=1; serve only)",
    knobs=_BASE_KNOBS + (
        Knob("window", 0, "sliding-window width (0 = full causal)"),
        Knob("use_kernels", 0, "route attention through the kernel "
                               "(forward-only: raises for training)"),
    ),
))

register_model(ModelSpec(
    name="moe",
    build=_build_moe,
    doc="mixture-of-experts transformer LM (top-k router + balance aux)",
    data_kind="tokens",
    family="moe",
    kernel="-",
    knobs=_BASE_KNOBS + (
        Knob("n_experts", 4, "routed experts"),
        Knob("top_k", 2, "experts per token"),
        Knob("moe_d_ff", 64, "per-expert SwiGLU width"),
    ),
))

register_model(ModelSpec(
    name="rwkv6",
    build=_build_rwkv6,
    doc="RWKV6 token/channel-mix LM (linear-attention wkv6 recurrence)",
    data_kind="tokens",
    family="rnn",
    kernel="wkv6 scan (CUDA, use_kernels=1; serve only)",
    knobs=_BASE_KNOBS + (
        Knob("use_kernels", 0, "route the wkv6 recurrence through the kernel "
                               "(forward-only: raises for training)"),
    ),
))
