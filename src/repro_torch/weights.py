"""Carry the reference's model parameters across to the port.

The reference draws its initial model from ``jax.random``, which torch
cannot reproduce, so a parity run hands the reference's weights to
``Substrate.build(cfg, flat_params0=...)`` instead.  Both packages lay a
parameter dict out flat in sorted-key leaf order (the order
``jax.tree.flatten`` gives a dict), so the flat vectors agree element for
element.  The model zoo's trees carry across whole (``from_jax_tree``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.aggregation import flatten_update


def from_jax_params(params: dict) -> np.ndarray:
    """A reference parameter dict (leaf name -> numpy array) as the port's
    flat fp32 (D,) vector."""
    flat, _ = flatten_update({k: torch.from_numpy(np.array(v, np.float32))
                              for k, v in params.items()})
    return flat.numpy()


def from_flat(flat_params0: np.ndarray) -> np.ndarray:
    """The reference Substrate's ``flat_params0`` as the port's flat fp32
    (D,) vector (same leaf order; checked to be one finite fp32 row)."""
    flat = np.asarray(flat_params0)
    if flat.ndim != 1 or flat.dtype != np.float32:
        raise ValueError(f"expected a flat float32 (D,) vector, got "
                         f"{flat.dtype} {flat.shape}")
    if not np.isfinite(flat).all():
        raise ValueError("flat_params0 has non-finite values")
    return flat.copy()


def _leaf(arr) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":    # numpy has no bf16: carry the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def from_jax_tree(params):
    """The reference model zoo's parameter tree (nested dicts and lists of
    arrays, e.g. ``repro.models.init_params`` mapped through
    ``np.asarray``) as the port's tree of CPU tensors: the same key paths,
    shapes and dtypes, the ``stack`` axis kept."""
    if isinstance(params, dict):
        return {k: from_jax_tree(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [from_jax_tree(v) for v in params]
    return _leaf(params)
