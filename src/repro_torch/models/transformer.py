"""Composable decoder-only model covering all ten architectures of the
zoo (``repro.models.transformer``).

A model is a sequence of *layers*, each layer = (mixer, ffn) with mixer in
{GQA attention (with an optional sliding window), MLA attention, Mamba,
RWKV6} and ffn in {dense SwiGLU, the mixture of experts of
``repro_torch.models.moe``}; a vision config projects precomputed patch
embeddings (``batch["frontend_embeds"]``) and puts them before the tokens.

The layers are an optional unrolled *prefix* followed by a periodic
*super-block* repeated ``n_rep`` times.  The reference ``lax.scan``s the
super-block over ``params["stack"]``, whose leaves carry a leading ``n_rep``
axis; the port keeps that tree (so weights carry across by key path) and
loops over the axis in Python.  The activations pass through
``shard_hints.constrain_activations`` where the reference pins them (the
identity unless a pod layout is configured; then a DTensor's batch dim is
pinned to the mesh's batch axes).  ``shape_params`` builds the parameter
tree as ``meta`` tensors, for the launch layer's placements.  With
``cfg.remat`` and grad mode
on, each repetition of the super-block runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``): the
backward recomputes its activations instead of keeping them.

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
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import frontends as fr
from repro_torch.models import layers as L
from repro_torch.models import mamba as mb
from repro_torch.models import shard_hints
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv6 as rw
from repro_torch.device import resolve_device


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


# ---------------------------------------------------------------------------
# Trees of tensors (the reference's pytrees of params and states)
# ---------------------------------------------------------------------------


def tree_map(fn, tree, *rest):
    """``fn`` applied to every tensor leaf of nested dicts and lists, with
    the leaves at the same key paths of the trees in ``rest`` (of the same
    structure) as further arguments."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _tree_stack(trees):
    """Trees of one structure stacked leaf by leaf along a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _tree_index(tree, i):
    return tree_map(lambda t: t[i], tree)


def _tree_unbind(tree) -> list:
    """A dict tree of stacked leaves as the list of its slices along axis 0
    (views): the slices' backward stacks their gradients once, where
    indexing each slice adds a zero-padded full-size gradient per slice."""
    if isinstance(tree, dict):
        subs = {k: _tree_unbind(v) for k, v in tree.items()}
        n = len(next(iter(subs.values())))
        return [{k: v[i] for k, v in subs.items()} for i in range(n)]
    return list(tree.unbind(0))


def _stack_reps(make, n_rep):
    """``n_rep`` trees from ``make()`` stacked leaf by leaf along a new axis
    0, holding at most one tree beside the stack (a single tree becomes the
    stack without a copy): the largest models fill most of one card."""
    first = make()
    if n_rep == 1:
        return tree_map(lambda t: t.unsqueeze(0), first)
    stack = tree_map(lambda t: t.new_empty((n_rep,) + t.shape), first)

    def put(dst, src, r):
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k], r)
        else:
            dst[r].copy_(src)
    for r in range(n_rep):
        put(stack, first if r == 0 else make(), r)
        first = None
    return stack


# ---------------------------------------------------------------------------
# Per-layer init / apply
# ---------------------------------------------------------------------------


def _layer_init(cfg: ModelConfig, gen, spec):
    mixer, ffn = spec
    dev = gen.device
    p = {"norm1": L.rmsnorm_init(cfg.d_model, dev),
         "norm2": L.rmsnorm_init(cfg.d_model, dev)}
    if mixer == "attn" and cfg.attn_type == "mla":
        p["mixer"] = attn.mla_init(
            gen, cfg.d_model, cfg.n_heads, kv_lora_rank=cfg.kv_lora_rank,
            qk_nope_dim=cfg.qk_nope_dim, qk_rope_dim=cfg.qk_rope_dim,
            v_head_dim=cfg.v_head_dim, dtype=cfg.param_dtype)
    elif mixer == "attn":
        p["mixer"] = attn.gqa_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim, cfg.qkv_bias, cfg.param_dtype)
    elif mixer == "mamba":
        p["mixer"] = mb.mamba_init(gen, cfg.d_model, d_state=cfg.mamba_d_state,
                                   expand=cfg.mamba_expand,
                                   conv_width=cfg.mamba_conv_width,
                                   dtype=cfg.param_dtype)
    elif mixer == "rwkv6":
        p["mixer"] = rw.rwkv6_init(gen, cfg.d_model, cfg.n_heads,
                                   lora_rank=cfg.rwkv_lora_rank,
                                   w_lora_rank=cfg.rwkv_w_lora_rank,
                                   dtype=cfg.param_dtype)
    else:
        raise ValueError(mixer)
    if ffn == "dense":
        p["ffn"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.param_dtype)
    else:
        p["ffn"] = moe_lib.moe_init(gen, cfg.d_model, cfg.moe_d_ff,
                                    cfg.n_experts, cfg.n_shared_experts,
                                    cfg.shared_d_ff or cfg.moe_d_ff,
                                    cfg.param_dtype)
    return p


def _mla_dims(cfg):
    return dict(n_heads=cfg.n_heads, kv_lora_rank=cfg.kv_lora_rank,
                qk_nope_dim=cfg.qk_nope_dim, qk_rope_dim=cfg.qk_rope_dim,
                v_head_dim=cfg.v_head_dim, rope_theta=cfg.rope_theta,
                window=cfg.window)


def _mamba_dims(cfg):
    return dict(d_state=cfg.mamba_d_state, expand=cfg.mamba_expand,
                conv_width=cfg.mamba_conv_width)


def _mixer_forward(cfg, spec, p, x, positions, state):
    """Full-sequence mixer. Returns (out, new_state_or_cache)."""
    mixer = spec[0]
    if mixer == "attn" and cfg.attn_type == "mla":
        out, (c_kv, k_rope) = attn.mla_forward(p, x, positions, **_mla_dims(cfg))
        return out, {"c_kv": c_kv, "k_rope": k_rope, "pos": positions.to(torch.int32)}
    if mixer == "attn":
        out, kv = attn.gqa_forward(
            p, x, positions, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            d_head=cfg.head_dim, rope_theta=cfg.rope_theta, window=cfg.window,
            use_kernel=cfg.use_kernels)
        return out, {"k": kv[0], "v": kv[1], "pos": positions.to(torch.int32)}
    if mixer == "mamba":
        return mb.mamba_forward(p, x, state=state, **_mamba_dims(cfg))
    if mixer == "rwkv6":
        return rw.rwkv6_forward(p, x, n_heads=cfg.n_heads, state=state,
                                use_kernel=cfg.use_kernels)
    raise ValueError(mixer)


def _mixer_decode(cfg, spec, p, x, position, state):
    mixer = spec[0]
    if mixer == "attn" and cfg.attn_type == "mla":
        return attn.mla_decode(p, x, position, state, absorbed=cfg.mla_absorb,
                               **_mla_dims(cfg))
    if mixer == "attn":
        return attn.gqa_decode(p, x, position, state, n_heads=cfg.n_heads,
                               n_kv_heads=cfg.n_kv_heads, d_head=cfg.head_dim,
                               rope_theta=cfg.rope_theta, window=cfg.window)
    if mixer == "mamba":
        return mb.mamba_decode(p, x, state, **_mamba_dims(cfg))
    if mixer == "rwkv6":
        return rw.rwkv6_decode(p, x, state, n_heads=cfg.n_heads)
    raise ValueError(mixer)


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
    x = x + shard_hints.reduced(h)
    h, aux = _ffn_forward(cfg, spec, p, L.rmsnorm(p["norm2"], x, cfg.norm_eps))
    return x + shard_hints.reduced(h), new_state, aux


def _layer_decode(cfg, spec, p, x, position, state):
    h, new_state = _mixer_decode(cfg, spec, p["mixer"],
                                 L.rmsnorm(p["norm1"], x, cfg.norm_eps),
                                 position, state)
    x = x + shard_hints.reduced(h)
    h, _ = _ffn_forward(cfg, spec, p, L.rmsnorm(p["norm2"], x, cfg.norm_eps))
    return x + shard_hints.reduced(h), new_state


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, gen: torch.Generator):
    """Random parameters drawn from ``gen``, on its device, in the
    reference's tree: ``embed``, ``final_norm``, ``head`` (untied),
    ``frontend`` (vision), ``prefix`` (a list of layers) and ``stack``
    ({"sub<i>": layer} with a leading ``n_rep`` axis on every leaf)."""
    prefix, specs, n_rep = cfg.segment_plan()
    params = {"embed": L.embed_init_params(gen, cfg.padded_vocab, cfg.d_model,
                                           cfg.param_dtype),
              "final_norm": L.rmsnorm_init(cfg.d_model, gen.device)}
    if not cfg.tie_embeddings:
        params["head"] = {"w_out": L.dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                                                cfg.param_dtype)}
    if cfg.frontend == "vision":
        params["frontend"] = fr.frontend_init(gen, cfg.d_frontend, cfg.d_model,
                                              cfg.param_dtype)
    params["prefix"] = [_layer_init(cfg, gen, spec) for spec in prefix]
    params["stack"] = _stack_reps(
        lambda: {f"sub{i}": _layer_init(cfg, gen, spec) for i, spec in enumerate(specs)},
        n_rep)
    return params


class _ShapeOnly:
    """Stands in for the generator of ``init_params`` when only shapes are
    wanted: every leaf comes out a ``meta`` tensor and nothing is drawn."""
    device = torch.device("meta")


def shape_params(cfg: ModelConfig):
    """The tree of ``init_params(cfg, ...)`` as ``meta`` tensors of the same
    key paths, shapes and dtypes (the reference's
    ``jax.eval_shape(init_params)``): a full-width model's layout with no
    memory behind it."""
    return init_params(cfg, _ShapeOnly())


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def _embed_inputs(cfg, params, batch):
    """batch: {"tokens": (B, S_text)[, "frontend_embeds": (B, P, d_frontend)]};
    a vision config's projected patches come first: (B, P + S_text, d)."""
    x = L.embed_lookup(params["embed"], batch["tokens"])
    if cfg.frontend == "vision":
        fe = fr.project_frontend(params["frontend"], batch["frontend_embeds"])
        # placed, both halves pinned alike first: DTensor has no concat of a
        # batch-split half with a half of partial sums
        fe, x = (shard_hints.constrain_activations(shard_hints.reduced(t))
                 for t in (fe.to(x.dtype), x))
        x = torch.cat([fe, x], dim=1)
    return x


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
    prefix, specs, n_rep = cfg.segment_plan()
    x = shard_hints.constrain_activations(_embed_inputs(cfg, params, batch))
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    prefix_states = []
    for p, spec in zip(params["prefix"], prefix):
        x, st, aux = _layer_forward(cfg, spec, p, x, positions, None)
        aux_total = aux_total + aux
        prefix_states.append(st if return_states else None)

    def superblock(x, aux_acc, p_slice):
        states = {}
        for i, spec in enumerate(specs):
            x, st, aux = _layer_forward(cfg, spec, p_slice[f"sub{i}"], x,
                                        positions, None)
            aux_acc = aux_acc + aux
            if return_states:
                states[f"sub{i}"] = st
        return shard_hints.constrain_activations(x), aux_acc, states

    # activation checkpointing, as the reference's jax.checkpoint(superblock):
    # a repetition keeps only its inputs and recomputes its forward in the
    # backward (the same ops on the same inputs: the same bits)
    remat = cfg.remat and torch.is_grad_enabled()
    stack_states = []
    for p_slice in _tree_unbind(params["stack"]):
        if remat:
            x, aux_total, states = checkpoint(superblock, x, aux_total, p_slice,
                                              use_reentrant=False)
        else:
            x, aux_total, states = superblock(x, aux_total, p_slice)
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
    # only the token positions are scored (frontend positions carry no labels)
    if cfg.frontend == "vision":
        x = x[:, -labels.shape[1]:]

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
    dt, mixer = cfg.param_dtype, spec[0]
    zeros = lambda *shape, dtype=dt: torch.zeros(shape, dtype=dtype, device=device)
    if mixer == "attn":
        pos = torch.full((B, cache_len), -1, dtype=torch.int32, device=device)
        if cfg.attn_type == "mla":
            return {"c_kv": zeros(B, cache_len, cfg.kv_lora_rank),
                    "k_rope": zeros(B, cache_len, cfg.qk_rope_dim), "pos": pos}
        return {"k": zeros(B, cache_len, cfg.n_kv_heads, cfg.head_dim),
                "v": zeros(B, cache_len, cfg.n_kv_heads, cfg.head_dim), "pos": pos}
    if mixer == "mamba":
        d_inner = cfg.mamba_expand * cfg.d_model
        return {"conv": zeros(B, cfg.mamba_conv_width - 1, d_inner),
                "ssm": zeros(B, d_inner, cfg.mamba_d_state, dtype=torch.float32)}
    if mixer == "rwkv6":
        N = cfg.d_model // cfg.n_heads
        return {"x_prev": zeros(B, cfg.d_model),
                "wkv": zeros(B, cfg.n_heads, N, N, dtype=torch.float32)}
    raise ValueError(mixer)


def init_decode_state(cfg: ModelConfig, B: int, max_seq: int, device=None):
    """Allocate the serve-time state on ``device`` (the GPU unless given;
    with no GPU this raises).  Attention caches are ring buffers of
    ``min(max_seq, window)`` slots when a sliding window is configured."""
    device = resolve_device(device)
    cache_len = max_seq if cfg.window is None else min(max_seq, cfg.window)
    prefix, specs, n_rep = cfg.segment_plan()
    one = {f"sub{i}": _mixer_state(cfg, s, B, cache_len, device)
           for i, s in enumerate(specs)}
    return {"prefix": [_mixer_state(cfg, s, B, cache_len, device) for s in prefix],
            "stack": tree_map(lambda t: t.expand((n_rep,) + t.shape).clone(), one)}


# the ring caches' leaves: a slot per position, the axis after the batch
CACHE_KEYS = ("k", "v", "c_kv", "k_rope", "pos")


def load_prefill(state, states, stacked=False, key=None):
    """A fresh decode ``state`` holding ``prefill``'s ``states`` of a prompt
    no longer than its caches: cache leaves (``CACHE_KEYS``) copied into
    their first slots (the axis after the batch, and after the stack's
    repeat axis), recurrent leaves whole."""
    if isinstance(state, dict):
        return {k: load_prefill(state[k], states[k], stacked or k == "stack", k)
                for k in state}
    if isinstance(state, list):
        return [load_prefill(a, b, stacked, key) for a, b in zip(state, states)]
    if key not in CACHE_KEYS:
        return states.clone()
    out, axis = state.clone(), 2 if stacked else 1
    out.narrow(axis, 0, states.shape[axis]).copy_(states)
    return out


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
