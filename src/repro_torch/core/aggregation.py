"""Flat-row SAA aggregation (paper Alg. 2) and the server optimizers, the
slice of ``repro.core.aggregation`` the round pipeline and the per-stage
flat path run.

A model's parameters travel as one flat fp32 row in ``FlatSpec`` leaf order
(dict keys sorted, the order ``jax.tree.flatten`` gives the reference), so
the stale cache, aggregation and server step never see the model's
structure.  ``aggregate_updates`` / ``weights_and_aggregate_by_id`` are the
``use_agg_kernel=False`` server path; with the flag on, the pipeline and
``stale_synchronous_aggregate_flat`` call the CUDA kernels in
``repro_torch.kernels.staleness_agg`` instead.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.staleness import RULE_ID, staleness_weights_by_id


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Leaf names, shapes and start offsets (plus a total-D sentinel) of a
    flattened parameter dict: ``flat[..., offsets[i]:offsets[i+1]]`` is leaf
    ``names[i]``.  Hashable, computed once per model."""
    names: tuple
    shapes: tuple
    offsets: tuple


def make_flat_spec(params: dict) -> FlatSpec:
    names = tuple(sorted(params))
    shapes = tuple(tuple(params[k].shape) for k in names)
    offs, off = [], 0
    for s in shapes:
        offs.append(off)
        off += int(np.prod(s)) if s else 1
    return FlatSpec(names, shapes, tuple(offs) + (off,))


def flat_dim(spec: FlatSpec) -> int:
    """Total flat vector length D."""
    return int(spec.offsets[-1])


def flatten_update(params: dict) -> tuple:
    """Parameter dict -> (flat fp32 vector, its ``FlatSpec``)."""
    spec = make_flat_spec(params)
    flat = torch.cat([torch.as_tensor(params[k]).reshape(-1).to(torch.float32)
                      for k in spec.names])
    return flat, spec


def unflatten_update(flat: torch.Tensor, spec: FlatSpec) -> dict:
    """Flat (..., D') rows -> dict of (..., *shape) views.  Leading axes
    ride along (a batch of per-learner rows unflattens to batched leaves);
    a row wider than D is block-padded and its tail is ignored."""
    lead = tuple(flat.shape[:-1])
    return {name: flat[..., lo:hi].reshape(lead + shp)
            for name, shp, lo, hi in zip(spec.names, spec.shapes,
                                         spec.offsets[:-1], spec.offsets[1:])}


def aggregate_updates(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """stacked: (n, D), weights: (n,) normalized -> (D,)."""
    return weights @ stacked


def weights_and_aggregate_by_id(stacked, fresh, tau, valid, beta, rule_id):
    """Eq. 2 weights and the weighted aggregate of one round's rows."""
    w = staleness_weights_by_id(stacked, fresh, tau, rule_id, beta=beta,
                                valid=valid)
    return aggregate_updates(stacked, w), w


def bucket_pow2(n: int) -> int:
    """Next power of two (the reference's participant padding bucket)."""
    return 1 << (n - 1).bit_length()


def bucket_block(n: int, block: int) -> int:
    """Power-of-two up to ``block``, then multiples of ``block`` (the
    reference's two-tier padding bucket).  The port's round pipeline runs
    eagerly on exact shapes; padding never changes a result."""
    if n <= block:
        return bucket_pow2(n)
    return block * ((n + block - 1) // block)


def pad_cols(t, block: int) -> torch.Tensor:
    """``t`` as a new fp32 tensor with zero columns up to the next multiple
    of ``block`` on its last axis (no padding when ``block`` is 0)."""
    t = torch.as_tensor(t)
    d = t.shape[-1]
    out = t.new_zeros(t.shape[:-1] + (d + (-d) % block if block else d,),
                      dtype=torch.float32)
    out[..., :d] = t
    return out


def bucket_pad(updates, fresh, tau, *, lane_block: int = 0):
    """Pad a round's updates for the kernels, on the updates' device.

    Pads the feature axis up to the next multiple of ``lane_block`` (when
    > 0).  The participant axis keeps its exact count: the port runs
    eagerly on exact shapes, so it has no compiled programs to bound by
    bucketing rows.  Returns (updates (n, Dp) fp32, fresh (n,) bool, tau
    (n,) int32, valid (n,) bool, all true).
    """
    u = pad_cols(updates, lane_block)
    dev = u.device
    fr = torch.as_tensor(fresh, dtype=torch.bool, device=dev)
    ta = torch.as_tensor(tau, dtype=torch.int32, device=dev)
    return u, fr, ta, torch.ones_like(fr)


def stale_synchronous_aggregate_flat(stacked, fresh, tau, *,
                                     rule: str = "relay", beta: float = 0.35,
                                     use_kernel: bool = False):
    """Aggregate already-stacked flat updates: the per-stage engine's server
    path.  stacked: (n, D) fp32 rows (fresh first, then landing stale);
    fresh: (n,) bool; tau: (n,) int32.  Returns (aggregate (D,), weights
    (n,)).  With ``use_kernel`` it goes through ``fused_staleness_aggregate``
    (D padded to the block, exact n), else through the torch path the fused
    pipeline runs without the kernel."""
    if use_kernel:
        from repro_torch.kernels.staleness_agg import ops as agg_ops
        return agg_ops.staleness_aggregate(stacked, fresh, tau, rule=rule,
                                           beta=beta)
    return weights_and_aggregate_by_id(stacked, fresh, tau,
                                       torch.ones_like(fresh), beta,
                                       RULE_ID[rule])


# ---------------------------------------------------------------------------
# Server optimizers on the flat row (they apply the aggregated delta)
# ---------------------------------------------------------------------------


def fedavg_apply(flat, delta, server_lr: float = 1.0):
    """x_{t+1} = x_t + lr * Delta  (McMahan et al., 2017)."""
    return flat + server_lr * delta


def yogi_init_flat(d: int, *, device=None, width: int | None = None) -> dict:
    """YoGi state over a flat (D,) row: m = 0, v = 1e-6, t = 0.  A ``width``
    past D (the kernel's block-padded layout) adds columns that are zero in
    m and v, which a YoGi step keeps exactly zero."""
    width = d if width is None else int(width)
    v = torch.zeros(width, dtype=torch.float32, device=device)
    v[:d] = 1e-6
    return {"m": torch.zeros(width, dtype=torch.float32, device=device),
            "v": v, "t": torch.zeros((), dtype=torch.int32, device=device)}


def yogi_apply_flat(flat, delta, state: dict, *, lr=1e-2, b1=0.9, b2=0.99,
                    eps=1e-3):
    """Federated YoGi (Reddi et al., 2020) on flat fp32 rows, the
    reference's elementwise formulas in its order:

        v <- v - (1-b2) * d^2 * sign(v - d^2)

    Returns (new row, new state); nothing is updated in place."""
    m = b1 * state["m"] + (1 - b1) * delta
    d2 = torch.square(delta)
    v = state["v"] - (1 - b2) * d2 * torch.sign(state["v"] - d2)
    new = flat + lr * m / (torch.sqrt(v) + eps)
    return new, {"m": m, "v": v, "t": state["t"] + 1}
