"""Sharding rules (port of ``repro.launch.shardings``): parameter
placements and input specs per (arch x shape).

Logical plan, as the reference's:
- batch / participant cohort -> ("pod", "data") mesh axes;
- tensor parallelism -> "model": attention q/o heads, FFN hidden, MoE
  experts, vocab;
- FSDP for >8B-param archs: the non-"model" matrix dim additionally
  sharded on "data" (within a pod);
- decode KV caches are sharded over the *sequence* dim on "model" (kv-head
  counts, 2..36, do not generally divide the 16-way axis, sequence does);
- stacked super-block params carry a leading repeat dim never sharded.

A placement is a ``PartitionSpec``: for each dim of a leaf, a mesh-axis
name, a tuple of them, or None (replicated), as the reference's
``jax.sharding.PartitionSpec``.  ``placements`` turns one into DTensor
``Shard`` / ``Replicate`` placements on a ``DeviceMesh``, ``distribute``
places a whole tree, and ``shard_bytes`` counts what one chip holds.
Input stand-ins are ``meta`` tensors in place of ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.launch.mesh import axis_sizes, batch_axes
from repro_torch.models.transformer import ModelConfig, init_decode_state

FSDP_THRESHOLD = 8e9  # params; above this the "data" axis also shards weights


class PartitionSpec(tuple):
    """One leaf's placement: per dim a mesh-axis name, a tuple of names,
    or None.  A tuple subclass, so ``tuple(spec)`` compares with the
    reference's ``PartitionSpec``; the tree helpers here treat it as a
    leaf (they recurse into dicts and lists only)."""

    def __new__(cls, *axes):
        # a one-axis tuple is that axis, as the reference normalizes it
        return super().__new__(cls, (a[0] if isinstance(a, tuple) and len(a) == 1
                                     else a for a in axes))

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec


def map_tree(fn, tree, *rest, path=()):
    """``fn(path, leaf, *rest_leaves)`` over the leaves of nested dicts and
    lists (anything else, a tensor or a ``PartitionSpec``, is a leaf);
    ``path`` holds the keys and indices down to the leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v, *(r[i] for r in rest), path=path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def leaves(tree) -> list:
    out = []
    map_tree(lambda _, leaf: out.append(leaf), tree)
    return out


# ---------------------------------------------------------------------------
# Parameter partitioning
# ---------------------------------------------------------------------------

# leaf-name -> (spec for 2-D (in, out) matrices): "col" = out on model,
# "row" = in on model, "rep" = replicated
_MATRIX_RULE = {
    "w_q": "col", "w_k": "col", "w_v": "col", "w_gate": "col", "w_up": "col",
    "w_in": "col", "w_dt": "col", "w_r": "col", "w_g": "col", "w_out": "col",
    "lora_b": "col", "w_uk": "col", "w_uv": "col", "proj": "col",
    "w_o": "row", "w_down": "row",
    "w_dkv": "rep", "w_kr": "rep", "w_x": "row", "router": "rep",
    "lora_a": "rep",
}

_VEC_MODEL = {"b_q", "b_k", "b_v", "conv_b", "dt_bias", "D"}


def _leaf_spec(name: str, shape, fsdp: bool, model_divides) -> P:
    nd = len(shape)
    f = "data" if fsdp else None
    if name == "embedding":                      # (V, d)
        return P("model", f)
    if name in ("A_log",):                       # (d_inner, N)
        return P("model", None)
    if name == "conv_w":                         # (W, d_inner)
        return P(None, "model")
    if name in _VEC_MODEL and nd == 1:
        return P("model") if model_divides(shape[0]) else P(None)
    if nd == 1 or name in ("w0", "u", "mu_x", "scale", "ln_x_scale") \
            or name.startswith("mu_"):
        return P(*([None] * nd))
    rule = _MATRIX_RULE.get(name)
    if rule == "col":
        if nd == 3:                              # MoE experts (E, d, f)
            return P("model", f, None)
        return P(f, "model") if model_divides(shape[-1]) else P(f, None)
    if rule == "row":
        if nd == 3:                              # MoE (E, f, d)
            return P("model", None, f)
        return P("model", f) if model_divides(shape[0]) else P(None, f)
    return P(*([None] * nd))


def param_pspecs(cfg: ModelConfig, params_shape, mesh, *, fsdp=None) -> Any:
    """PartitionSpec tree matching ``init_params``' structure.
    ``params_shape``: ``shape_params(cfg)`` (leaves have ``.shape``).
    ``fsdp`` overrides the FSDP choice, which is otherwise the tree's own
    (more than ``FSDP_THRESHOLD`` params): a depth-cut copy of a model
    keeps the full model's layout."""
    sizes = axis_sizes(mesh)
    if fsdp is None:
        n_params = sum(math.prod(l.shape) for l in leaves(params_shape))
        fsdp = n_params > FSDP_THRESHOLD
    fsdp = fsdp and "data" in sizes
    m_size, d_size = sizes["model"], sizes["data"]

    def spec_for(path, leaf):
        names = [str(k) for k in path]
        stacked = "stack" in names
        dims = leaf.shape[1:] if stacked else leaf.shape
        base = _leaf_spec(names[-1], dims, fsdp, lambda n: n % m_size == 0)
        # drop an axis from the dims it does not divide
        fixed = []
        for ax, d in zip(base, dims):
            if ax == "data" and d % d_size != 0:
                ax = None
            if ax == "model" and d % m_size != 0:
                ax = None
            fixed.append(ax)
        return P(None, *fixed) if stacked else P(*fixed)

    return map_tree(spec_for, params_shape)


# ---------------------------------------------------------------------------
# Placements on a DeviceMesh
# ---------------------------------------------------------------------------


def placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one a mesh dim: ``Shard``
    of the tensor dim that names the mesh axis, else ``Replicate`` (also
    for an axis of one rank, which splits nothing: DTensor's view rules
    would refuse views across such a shard in some torch versions).  A dim
    named by several axes is split by them in mesh order (the reference's
    major-to-minor order for a tuple of axes in mesh order)."""
    from torch.distributed.tensor import Replicate, Shard
    of_axis = {}
    for dim, ax in enumerate(spec):
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                of_axis[a] = dim
    return [Shard(of_axis[a]) if a in of_axis and mesh.size(i) > 1
            else Replicate() for i, a in enumerate(mesh.mesh_dim_names)]


def distribute(tree, specs, mesh):
    """Every leaf of ``tree`` as a DTensor placed by its spec in ``specs``
    (a tree of the same structure); ``meta`` leaves give ``meta`` shards."""
    from torch.distributed.tensor import distribute_tensor
    return map_tree(lambda _, t, s: distribute_tensor(
        t, mesh, placements(s, mesh)), tree, specs)


def shard_shape(shape, spec, sizes: dict) -> tuple:
    """The largest shard's shape (rank 0's) of a dim-``shape`` leaf placed by
    ``spec`` on a mesh of axis ``sizes``: each dim split by the product of
    the axes naming it, rounded up."""
    out = []
    for i, d in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        axes = ax if isinstance(ax, tuple) else (ax,)
        n = math.prod(sizes[a] for a in axes if a is not None)
        out.append(-(-d // n))
    return tuple(out)


def shard_bytes(tree, specs, mesh) -> int:
    """Bytes of ``tree``'s leaves one chip holds under ``specs``."""
    sizes = axis_sizes(mesh)
    total = []
    map_tree(lambda _, t, s: total.append(
        math.prod(shard_shape(t.shape, s, sizes)) * t.element_size()),
        tree, specs)
    return int(sum(total))


# ---------------------------------------------------------------------------
# Input specs (meta-tensor stand-ins, no allocation)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StepSpec:
    """Everything the dry run needs to place one step."""
    kind: str                  # train | prefill | decode
    args: dict                 # name -> tree of meta tensors
    arg_specs: dict            # name -> PartitionSpec tree
    n_participants: int = 0


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_batch(cfg: ModelConfig, B: int, S: int, lead=()):
    """Token batch (+frontend embeds for a vision config; the text
    sequence shrinks by the patches)."""
    s_text = S - (cfg.n_frontend_tokens if cfg.frontend == "vision" else 0)
    b = {"tokens": _meta(lead + (B, s_text), torch.int32),
         "labels": _meta(lead + (B, s_text), torch.int32)}
    if cfg.frontend == "vision":
        b["frontend_embeds"] = _meta(lead + (B, cfg.n_frontend_tokens,
                                             cfg.d_frontend), torch.bfloat16)
    return b


def input_specs(cfg: ModelConfig, shape, mesh, cohort: str = "vmap",
                stream_participants: int = 8) -> StepSpec:
    sizes = axis_sizes(mesh)
    baxes = batch_axes(mesh)
    n_batch_shards = math.prod(sizes[a] for a in baxes)

    if shape.kind == "train":
        if cohort == "stream":
            # participants are scanned in time; each participant's LOCAL
            # batch rides the ("pod", "data") axes so no chip idles
            p = stream_participants
            local_b = shape.global_batch // p
            assert local_b % n_batch_shards == 0, (local_b, n_batch_shards)

            def bspec(_, leaf):
                return P(None, baxes, *([None] * (leaf.dim() - 2)))
        else:
            # whole cohort in flight: the participant axis IS the batch axis
            p = max(16, n_batch_shards)
            local_b = shape.global_batch // p

            def bspec(_, leaf):
                return P(baxes, *([None] * (leaf.dim() - 1)))
        batch = _token_batch(cfg, local_b, shape.seq_len, lead=(p,))
        args = {"batch": batch, "fresh": _meta((p,), torch.bool),
                "tau": _meta((p,), torch.int32)}
        arg_specs = {"batch": map_tree(bspec, batch),
                     "fresh": P(None), "tau": P(None)}
        return StepSpec("train", args, arg_specs, n_participants=p)

    if shape.kind == "prefill":
        batch = _token_batch(cfg, shape.global_batch, shape.seq_len)
        bspec = map_tree(lambda _, leaf: P(baxes, *([None] * (leaf.dim() - 1))),
                         batch)
        return StepSpec("prefill", {"batch": batch}, {"batch": bspec})

    # decode: one new token against a seq_len cache
    B = shape.global_batch
    state = init_decode_state(cfg, B, shape.seq_len, device="meta")
    shard_batch = B % n_batch_shards == 0
    m_size = sizes["model"]

    def state_spec(path, leaf):
        # caches: (B, Sc, ...) -> batch on baxes (if divisible), Sc on
        # "model"; stacked states carry a leading unsharded repeat dim
        stacked = "stack" in [str(k) for k in path]
        dims = list(leaf.shape[1:] if stacked else leaf.shape)
        spec = [baxes if shard_batch else None]
        if len(dims) >= 2:
            seq_ok = dims[1] >= 1024 and dims[1] % m_size == 0
            spec.append("model" if seq_ok else None)
        spec += [None] * (len(dims) - len(spec))
        spec = spec[:len(dims)]
        return P(None, *spec) if stacked else P(*spec)

    args = {"state": state, "tokens": _meta((B,), torch.int32),
            "position": _meta((B,), torch.int32)}
    arg_specs = {"state": map_tree(state_spec, state),
                 "tokens": P(baxes) if shard_batch else P(None),
                 "position": P(baxes) if shard_batch else P(None)}
    return StepSpec("decode", args, arg_specs)
