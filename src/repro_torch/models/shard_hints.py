"""Sharding-constraint hints for model internals (port of
``repro.models.shard_hints``).

In the reference the launch layer registers the mesh axes here and the
model pins the layout at a few places the partitioner loses it: the
activations after the embedding and between super-blocks (batch dim ->
batch axes) and the MoE dispatch buffers (expert dim -> "model").  Only the
reference's pod dry run configures them (``repro.launch.dryrun``).

The port keeps the state and the call sites: ``configure``, ``reset`` and
``hints`` set and restore the axes as in the reference, and with none set
(the default, and every run of the simulator and the serve and train
paths) ``constrain_activations`` and ``constrain_expert_dim`` return their
argument.  With axes set they raise: placing a tensor on a pod mesh is the
dry run's layout work (DTensor over a ``DeviceMesh``), ROADMAP.md queue 1
item 15, which is not ported yet.
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


def _unported(what: str):
    return NotImplementedError(
        f"{what} places a tensor on a pod mesh, which is not ported to "
        "repro_torch yet (ROADMAP.md queue 1 item 15)")


def constrain_activations(x):
    """x: (..., B, S, d) — pin the batch dim (3rd from the end)."""
    if _STATE["batch_axes"] is None:
        return x
    raise _unported(f"constrain_activations(batch_axes="
                    f"{_STATE['batch_axes']!r})")


def constrain_expert_dim(t, expert_axis_index: int):
    """Pin dim ``expert_axis_index`` of t to the model axis (expert parallel)."""
    if _STATE["model_axis"] is None:
        return t
    raise _unported(f"constrain_expert_dim(model_axis="
                    f"{_STATE['model_axis']!r})")
