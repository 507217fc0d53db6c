"""Flat-row SAA aggregation (paper Alg. 2), the slice of
``repro.core.aggregation`` the round pipeline runs.

A model's parameters travel as one flat fp32 row in ``FlatSpec`` leaf order
(dict keys sorted, the order ``jax.tree.flatten`` gives the reference), so
the stale cache, aggregation and server step never see the model's
structure.  ``aggregate_updates`` / ``weights_and_aggregate_by_id`` are the
``use_agg_kernel=False`` server path; with the flag on the pipeline calls
the CUDA kernel in ``repro_torch.kernels.staleness_agg`` instead.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.staleness import staleness_weights_by_id


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
