"""Sharding-constraint hints for model internals (port of
``repro.models.shard_hints``).

The launch layer registers the mesh axes here and the model pins the
layout at the few places that anchor it: the activations after the
embedding and between super-blocks (batch dim -> batch axes) and the MoE
dispatch buffers (expert dim -> "model").  Where the reference calls
``jax.lax.with_sharding_constraint``, the port redistributes a DTensor to
the pinned placement (the named dim sharded on the named axes, every other
mesh axis replicated), which is where the collectives the partitioner
would insert happen.

With no axes set (the default, and every run of the simulator and of the
serve and train paths on plain tensors) ``constrain_activations`` and
``constrain_expert_dim`` return their argument.  With axes set they take
DTensors only: a plain tensor has no placement to pin, and they raise.

``whole_heads`` has no counterpart in the reference: DTensor cannot view
a projection whose last dim is split into more shards than it has heads
(a head would straddle two shards), which XLA's partitioner resolves by
itself.  It gathers such a projection's weight over the axes that split
it, so no activation of the projection is split mid-head.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

_STATE = {"batch_axes": None, "model_axis": None}


def configure(*, batch_axes: Optional[Tuple[str, ...]] = None,
              model_axis: Optional[str] = None):
    _STATE["batch_axes"] = batch_axes
    _STATE["model_axis"] = model_axis


def reset():
    configure()


@contextlib.contextmanager
def hints(*, batch_axes=None, model_axis=None):
    old = dict(_STATE)
    configure(batch_axes=batch_axes, model_axis=model_axis)
    try:
        yield
    finally:
        _STATE.update(old)


def placed() -> bool:
    """Whether a pod layout is configured (the model axis is set)."""
    return _STATE["model_axis"] is not None


def _pin(t, spec, what: str):
    """``t`` (a DTensor) redistributed to the placements of ``spec`` on its
    own mesh."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.shardings import P, placements
    if not isinstance(t, DTensor):
        raise TypeError(
            f"{what}: mesh axes are configured ({dict(_STATE)}) but the "
            f"tensor is a plain {type(t).__name__}; only a DTensor placed on "
            "a DeviceMesh (repro_torch.launch.shardings.distribute) can be "
            "pinned")
    mesh = t.device_mesh
    return t.redistribute(mesh, placements(P(*spec), mesh))


def constrain_activations(x):
    """x: (..., B, S, d) — pin the batch dim (3rd from the end)."""
    ba = _STATE["batch_axes"]
    if ba is None:
        return x
    spec = [None] * x.ndim
    spec[-3] = tuple(ba)
    return _pin(x, spec, "constrain_activations")


def constrain_expert_dim(t, expert_axis_index: int):
    """Pin dim ``expert_axis_index`` of t to the model axis (expert parallel)."""
    ma = _STATE["model_axis"]
    if ma is None:
        return t
    spec = [None] * t.ndim
    spec[expert_axis_index] = ma
    return _pin(t, spec, "constrain_expert_dim")


def whole_heads(t, n_heads: int, dim: int = -1):
    """t: a projection weight or bias whose dim ``dim`` is (H * d_head),
    with H a multiple of ``n_heads`` (the heads, or the kv groups queries
    come in).  A DTensor whose ``dim`` is split into a number of shards
    that ``n_heads`` is not a multiple of comes back replicated along the
    axes that split it; anything else as it is."""
    if _STATE["model_axis"] is None:
        return t
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        return t
    mesh, dim = t.device_mesh, dim % t.ndim
    splits = [p.is_shard(dim) for p in t.placements]
    shards = 1
    for i, split in enumerate(splits):
        shards *= mesh.size(i) if split else 1
    if n_heads % shards == 0:
        return t
    return t.redistribute(mesh, [Replicate() if split else p
                                 for p, split in zip(t.placements, splits)])
