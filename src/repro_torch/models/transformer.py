"""Composable decoder-only model (``repro.models.transformer``), for the
ported mixers: GQA attention (with an optional sliding window) and RWKV6,
each followed by a dense SwiGLU FFN or (on attention layers of an MoE
config) the mixture of experts of ``repro_torch.models.moe``.

A model is an optional unrolled *prefix* of layers followed by a periodic
*super-block* repeated ``n_rep`` times.  The reference ``lax.scan``s the
super-block over ``params["stack"]``, whose leaves carry a leading ``n_rep``
axis; the port keeps that tree (so weights carry across by key path) and
loops over the axis in Python.  MLA, Mamba and the vision frontend are not
ported (ROADMAP.md queue 1 item 13); neither is ``shard_hints`` (a no-op on
one device; queue 1 item 14).

With autograd on, the token lookup (``layers.embed_lookup``) and the gold
logit (``_onehot_gold``) are one-hot products: the same values, and a
backward that is a GEMM instead of an indexed accumulation with float
atomics, so training on the card gives the same bits every run.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv6 as rw
from repro_torch.device import resolve_device

_NOT_PORTED = "is not ported to repro_torch yet (ROADMAP.md queue 1 item 13)"


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str = "custom"
    family: str = "dense"            # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""                 # citation for the config
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    d_head: Optional[int] = None
    qkv_bias: bool = False
    attn_type: str = "gqa"           # gqa | mla
    window: Optional[int] = None     # sliding-window width (None = full causal)
    rope_theta: float = 1e4
    # --- MLA (DeepSeek-V2) ---
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    first_k_dense: int = 0
    moe_every: int = 1               # MoE ffn on layers where idx % moe_every == moe_offset
    moe_offset: int = 0
    moe_group_size: int = 4096
    # --- hybrid / ssm ---
    block_pattern: Tuple[str, ...] = ("attn",)  # mixer per layer, tiled
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_conv_width: int = 4
    rwkv_lora_rank: int = 32
    rwkv_w_lora_rank: int = 64
    # --- frontend ---
    frontend: Optional[str] = None   # "vision" | None (audio uses plain tokens)
    d_frontend: int = 1024
    n_frontend_tokens: int = 256
    # --- misc ---
    tie_embeddings: bool = False
    vocab_pad_to: int = 0            # pad vocab rows so "model" axis divides
    norm_eps: float = 1e-5
    param_dtype: Any = torch.bfloat16
    use_kernels: bool = False
    mla_absorb: bool = False         # absorbed-matmul MLA decode (beyond-paper)
    loss_chunk: int = 0              # >0: chunk the LM loss over sequence
    remat: bool = False              # activation checkpointing on super-blocks

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        if self.vocab_pad_to <= 0:
            return self.vocab_size
        m = self.vocab_pad_to
        return (self.vocab_size + m - 1) // m * m

    def mixer_of(self, layer_idx: int) -> str:
        return self.block_pattern[layer_idx % len(self.block_pattern)]

    def ffn_of(self, layer_idx: int) -> str:
        if self.mixer_of(layer_idx) == "rwkv6":
            return "dense"  # channel-mix approximated by a dense SwiGLU
        if (self.moe and layer_idx >= self.first_k_dense
                and layer_idx % self.moe_every == self.moe_offset):
            return "moe"
        return "dense"

    def layer_spec(self, layer_idx: int) -> Tuple[str, str]:
        return (self.mixer_of(layer_idx), self.ffn_of(layer_idx))

    def segment_plan(self) -> Tuple[list, list, int]:
        """Returns (prefix_specs, period_specs, n_repeats)."""
        prefix = [self.layer_spec(i) for i in range(self.first_k_dense)]
        rest = self.n_layers - self.first_k_dense
        period = 1
        # the super-block period must tile both the mixer pattern and moe cadence
        for cand in (len(self.block_pattern), self.moe_every):
            period = period * cand // math.gcd(period, cand)
        assert rest % period == 0, (
            f"{self.arch_id}: {rest} layers not divisible by super-block {period}")
        specs = [self.layer_spec(self.first_k_dense + i) for i in range(period)]
        return prefix, specs, rest // period


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a part of ``cfg`` not ported yet."""
    if cfg.frontend is not None:
        raise NotImplementedError(f"frontend {cfg.frontend!r} {_NOT_PORTED}")
    prefix, specs, _ = cfg.segment_plan()
    for mixer, _ in prefix + specs:
        if mixer not in ("attn", "rwkv6"):
            raise NotImplementedError(f"mixer {mixer!r} {_NOT_PORTED}")
        if mixer == "attn" and cfg.attn_type != "gqa":
            raise NotImplementedError(f"attention {cfg.attn_type!r} {_NOT_PORTED}")


# ---------------------------------------------------------------------------
# Trees of tensors (the reference's pytrees of params and states)
# ---------------------------------------------------------------------------


def tree_map(fn, tree):
    """``fn`` applied to every tensor leaf of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _tree_stack(trees):
    """Trees of one structure stacked leaf by leaf along a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _tree_index(tree, i):
    return tree_map(lambda t: t[i], tree)


# ---------------------------------------------------------------------------
# Per-layer init / apply
# ---------------------------------------------------------------------------


def _layer_init(cfg: ModelConfig, gen, spec):
    mixer, ffn = spec
    dev = gen.device
    p = {"norm1": L.rmsnorm_init(cfg.d_model, dev),
         "norm2": L.rmsnorm_init(cfg.d_model, dev)}
    if mixer == "attn":
        p["mixer"] = attn.gqa_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim, cfg.qkv_bias, cfg.param_dtype)
    else:
        p["mixer"] = rw.rwkv6_init(gen, cfg.d_model, cfg.n_heads,
                                   lora_rank=cfg.rwkv_lora_rank,
                                   w_lora_rank=cfg.rwkv_w_lora_rank,
                                   dtype=cfg.param_dtype)
    if ffn == "dense":
        p["ffn"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.param_dtype)
    else:
        p["ffn"] = moe_lib.moe_init(gen, cfg.d_model, cfg.moe_d_ff,
                                    cfg.n_experts, cfg.n_shared_experts,
                                    cfg.shared_d_ff or cfg.moe_d_ff,
                                    cfg.param_dtype)
    return p


def _mixer_forward(cfg, spec, p, x, positions, state):
    """Full-sequence mixer. Returns (out, new_state_or_cache)."""
    if spec[0] == "attn":
        out, kv = attn.gqa_forward(
            p, x, positions, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            d_head=cfg.head_dim, rope_theta=cfg.rope_theta, window=cfg.window,
            use_kernel=cfg.use_kernels)
        return out, {"k": kv[0], "v": kv[1], "pos": positions.to(torch.int32)}
    return rw.rwkv6_forward(p, x, n_heads=cfg.n_heads, state=state,
                            use_kernel=cfg.use_kernels)


def _mixer_decode(cfg, spec, p, x, position, state):
    if spec[0] == "attn":
        return attn.gqa_decode(p, x, position, state, n_heads=cfg.n_heads,
                               n_kv_heads=cfg.n_kv_heads, d_head=cfg.head_dim,
                               rope_theta=cfg.rope_theta, window=cfg.window)
    return rw.rwkv6_decode(p, x, state, n_heads=cfg.n_heads)


def _ffn_forward(cfg, spec, p, x):
    """Returns (out, aux_loss)."""
    if spec[1] == "dense":
        return L.mlp(p["ffn"], x), torch.zeros((), dtype=torch.float32,
                                                device=x.device)
    return moe_lib.moe_forward(p["ffn"], x, n_experts=cfg.n_experts,
                               top_k=cfg.top_k, group_size=cfg.moe_group_size)


def _layer_forward(cfg, spec, p, x, positions, state):
    h, new_state = _mixer_forward(cfg, spec, p["mixer"],
                                  L.rmsnorm(p["norm1"], x, cfg.norm_eps),
                                  positions, state)
    x = x + h
    h, aux = _ffn_forward(cfg, spec, p, L.rmsnorm(p["norm2"], x, cfg.norm_eps))
    return x + h, new_state, aux


def _layer_decode(cfg, spec, p, x, position, state):
    h, new_state = _mixer_decode(cfg, spec, p["mixer"],
                                 L.rmsnorm(p["norm1"], x, cfg.norm_eps),
                                 position, state)
    x = x + h
    h, _ = _ffn_forward(cfg, spec, p, L.rmsnorm(p["norm2"], x, cfg.norm_eps))
    return x + h, new_state


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, gen: torch.Generator):
    """Random parameters drawn from ``gen``, on its device, in the
    reference's tree: ``embed``, ``final_norm``, ``head`` (untied),
    ``prefix`` (a list of layers) and ``stack`` ({"sub<i>": layer} with a
    leading ``n_rep`` axis on every leaf)."""
    check_ported(cfg)
    prefix, specs, n_rep = cfg.segment_plan()
    params = {"embed": L.embed_init_params(gen, cfg.padded_vocab, cfg.d_model,
                                           cfg.param_dtype),
              "final_norm": L.rmsnorm_init(cfg.d_model, gen.device)}
    if not cfg.tie_embeddings:
        params["head"] = {"w_out": L.dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                                                cfg.param_dtype)}
    params["prefix"] = [_layer_init(cfg, gen, spec) for spec in prefix]
    params["stack"] = _tree_stack([
        {f"sub{i}": _layer_init(cfg, gen, spec) for i, spec in enumerate(specs)}
        for _ in range(n_rep)])
    return params


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def _embed_inputs(cfg, params, batch):
    """batch: {"tokens": (B, S)} (the vision frontend is not ported)."""
    return L.embed_lookup(params["embed"], batch["tokens"])


def _logits(cfg, params, x):
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["embedding"].T.to(x.dtype)
    else:
        logits = x @ params["head"]["w_out"].to(x.dtype)
    if cfg.padded_vocab != cfg.vocab_size:
        # mask pad rows out of the softmax support
        pad = torch.arange(logits.shape[-1], device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill / eval)
# ---------------------------------------------------------------------------


def forward(cfg: ModelConfig, params, batch, *, return_states: bool = False):
    """Returns (final hidden, aux_loss, states)."""
    check_ported(cfg)
    prefix, specs, n_rep = cfg.segment_plan()
    x = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    prefix_states = []
    for p, spec in zip(params["prefix"], prefix):
        x, st, aux = _layer_forward(cfg, spec, p, x, positions, None)
        aux_total = aux_total + aux
        prefix_states.append(st if return_states else None)

    stack_states = []
    for rep in range(n_rep):
        p_slice = _tree_index(params["stack"], rep)
        states = {}
        for i, spec in enumerate(specs):
            x, st, aux = _layer_forward(cfg, spec, p_slice[f"sub{i}"], x,
                                        positions, None)
            aux_total = aux_total + aux
            if return_states:
                states[f"sub{i}"] = st
        stack_states.append(states)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    states = ({"prefix": prefix_states, "stack": _tree_stack(stack_states)}
              if return_states else None)
    return x, aux_total, states


def _onehot_gold(logits, labels):
    """logits[..., labels] as a one-hot product: the same values (one
    nonzero term a sum), and a backward with no scatter."""
    cols = torch.arange(logits.shape[-1], device=logits.device)
    return (logits * (labels[..., None] == cols).to(logits.dtype)).sum(-1)


def lm_loss(cfg: ModelConfig, params, batch, *, aux_weight: float = 0.01):
    """Cross-entropy next-token loss (labels = batch["labels"]) plus
    ``aux_weight`` times the MoE balance loss."""
    x, aux, _ = forward(cfg, params, batch)
    labels = batch["labels"]

    def chunk_loss(xc, yc):
        logits = _logits(cfg, params, xc).float()
        logz = torch.logsumexp(logits, dim=-1)
        return (logz - _onehot_gold(logits, yc)).sum()

    B, S, _ = x.shape
    if cfg.loss_chunk and S > cfg.loss_chunk and S % cfg.loss_chunk == 0:
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for lo in range(0, S, cfg.loss_chunk):
            hi = lo + cfg.loss_chunk
            total = total + chunk_loss(x[:, lo:hi], labels[:, lo:hi])
    else:
        total = chunk_loss(x, labels)
    return total / (B * S) + aux_weight * aux


def prefill(cfg: ModelConfig, params, batch):
    """Run the full prompt; returns (last-position logits, states for decode)."""
    x, _, states = forward(cfg, params, batch, return_states=True)
    logits = _logits(cfg, params, x[:, -1:])[..., :cfg.vocab_size]
    return logits, states


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _mixer_state(cfg, spec, B, cache_len, device):
    dt = cfg.param_dtype
    if spec[0] == "attn":
        shape = (B, cache_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device),
                "pos": torch.full((B, cache_len), -1, dtype=torch.int32, device=device)}
    N = cfg.d_model // cfg.n_heads
    return {"x_prev": torch.zeros((B, cfg.d_model), dtype=dt, device=device),
            "wkv": torch.zeros((B, cfg.n_heads, N, N), dtype=torch.float32,
                               device=device)}


def init_decode_state(cfg: ModelConfig, B: int, max_seq: int, device=None):
    """Allocate the serve-time state on ``device`` (the GPU unless given;
    with no GPU this raises).  Attention caches are ring buffers of
    ``min(max_seq, window)`` slots when a sliding window is configured."""
    check_ported(cfg)
    device = resolve_device(device)
    cache_len = max_seq if cfg.window is None else min(max_seq, cfg.window)
    prefix, specs, n_rep = cfg.segment_plan()
    one = {f"sub{i}": _mixer_state(cfg, s, B, cache_len, device)
           for i, s in enumerate(specs)}
    return {"prefix": [_mixer_state(cfg, s, B, cache_len, device) for s in prefix],
            "stack": tree_map(lambda t: t.expand((n_rep,) + t.shape).clone(), one)}


def decode_step(cfg: ModelConfig, params, state, tokens, position):
    """One-token decode. tokens: (B,), position: (B,) absolute positions.

    Returns (logits (B, vocab), new_state); ``state`` is left as it was.
    """
    prefix, specs, n_rep = cfg.segment_plan()
    x = L.embed_lookup(params["embed"], tokens[:, None])

    new_prefix = []
    for p, spec, st in zip(params["prefix"], prefix, state["prefix"]):
        x, st_new = _layer_decode(cfg, spec, p, x, position, st)
        new_prefix.append(st_new)

    new_stack = []
    for rep in range(n_rep):
        p_slice = _tree_index(params["stack"], rep)
        st_slice = _tree_index(state["stack"], rep)
        new_states = {}
        for i, spec in enumerate(specs):
            x, new_states[f"sub{i}"] = _layer_decode(
                cfg, spec, p_slice[f"sub{i}"], x, position, st_slice[f"sub{i}"])
        new_stack.append(new_states)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _logits(cfg, params, x)[:, 0, :cfg.vocab_size]
    return logits, {"prefix": new_prefix, "stack": _tree_stack(new_stack)}
