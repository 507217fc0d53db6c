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

``pin_heads`` has no counterpart in the reference: DTensor cannot view a
projection whose last dim is split into shards that do not hold whole
heads, which XLA's partitioner resolves by itself, and DTensor's planner
may re-split a product it was handed whole.  It pins a head-carrying
activation to one placement, so that every chip holds whole kv groups:
the batch keeps its axes, the model axis splits the heads only where
their groups divide over it and otherwise holds them all.  ``reduced``
(partial sums added before a residual add), ``gathered`` (a tensor whole
on every chip) and ``placed_as`` (a written cache kept in its layout) act
on any DTensor, configured or not: they state placements DTensor's
propagation would otherwise choose, differently across torch versions.
Each returns a plain tensor at once (``type(t) is torch.Tensor``), before
any import of ``torch.distributed``: the serve and train paths call them
every layer.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

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


def reduced(t):
    """``t`` with its partial sums added up: a DTensor's ``Partial``
    placements made ``Replicate`` (an all-reduce), the others kept.  The
    model adds a row-parallel product's partial sums here before the
    residual add, as a tensor-parallel layer's all-reduce does: DTensor
    would otherwise split the residual into partial shares (x / n each) and
    carry them on, which adds the same values in another order.  Anything
    else comes back as it is."""
    if type(t) is torch.Tensor:
        return t
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor) or not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in t.placements])


def placed_as(t, ref):
    """``t`` placed as the DTensor ``ref`` (a cache written out of place
    keeps its cache's layout, which DTensor's propagation need not choose);
    anything else as it is."""
    if type(t) is torch.Tensor:
        return t
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor) or not isinstance(ref, DTensor):
        return t
    return t.redistribute(ref.device_mesh, ref.placements)


def gathered(t):
    """``t`` whole on every chip: a DTensor redistributed to ``Replicate``
    on every mesh dim (an all-gather of its shards, an all-reduce of its
    partial sums).  Anything else comes back as it is."""
    if type(t) is torch.Tensor:
        return t
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def pin_heads(t, n_groups: int, dim: int = -1):
    """t: an activation whose dim ``dim`` holds ``n_groups`` groups of
    heads (kv groups, or heads where each is its own group), batch first.
    With a pod layout configured, a DTensor comes back with its batch dim
    on the mesh dims that shard it now, ``dim`` on the model axis when
    ``n_groups`` is a multiple of that axis' size (whole groups a chip)
    and replicated along it otherwise, every other mesh dim replicated;
    the redistribution is where the collective (an all-gather, or an
    all-reduce of partial sums) is, and its backward pins the gradient
    likewise.  Anything else comes back as it is."""
    ma = _STATE["model_axis"]
    if ma is None or type(t) is torch.Tensor:
        return t
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(t, DTensor):
        return t
    mesh, dim = t.device_mesh, dim % t.ndim
    want = []
    for i, (name, p) in enumerate(zip(mesh.mesh_dim_names, t.placements)):
        if mesh.size(i) == 1:          # an axis of one rank splits nothing
            want.append(Replicate())
        elif name == ma:
            want.append(Shard(dim) if n_groups % mesh.size(i) == 0
                        else Replicate())
        else:
            want.append(p if p.is_shard(0) else Replicate())
    # redistributed even when ``t`` is placed so already: its backward then
    # pins the gradient
    return t.redistribute(mesh, want)
