"""Parameter trees to npz and back (port of ``repro.checkpoint.checkpoint``).

A tree is a nested dict of tensors.  Leaves are keyed by their ``/``-joined
key path; a restore needs a template tree of the same structure (the usual
``init`` output), so the structure round-trips exactly.  Device tensors are
copied to the host; bf16 is stored as its uint16 view (npz has no bf16).
"""
from __future__ import annotations

import os

import numpy as np
import torch


class CheckpointError(ValueError):
    """The stored checkpoint does not match the template tree."""


def _map(tree, fn, prefix=""):
    """``tree`` with each leaf replaced by ``fn(key path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def _keys(tree) -> list:
    keys = []
    _map(tree, lambda key, _leaf: keys.append(key))
    return keys


def save_pytree(path: str, tree) -> None:
    flat = {}

    def store(key, leaf):
        t = torch.as_tensor(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            flat[key + "::bf16"] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            flat[key] = t.numpy()
    _map(tree, store)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load_pytree(path: str, template):
    """The tree stored at ``path``, shaped, typed and placed as
    ``template``."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    stored = {f.removesuffix("::bf16") for f in data.files}
    expected = set(_keys(template))
    if stored != expected:
        raise CheckpointError(
            f"checkpoint {path!r} does not match template tree: "
            f"missing keys {sorted(expected - stored)}, unexpected keys "
            f"{sorted(stored - expected)}")

    def load(key, leaf):
        if key + "::bf16" in data:
            arr = torch.from_numpy(data[key + "::bf16"].view(np.int16)) \
                .view(torch.bfloat16)
        else:
            arr = torch.from_numpy(data[key])
        if tuple(arr.shape) != tuple(leaf.shape):
            raise CheckpointError(
                f"checkpoint {path!r}: leaf {key!r} has shape "
                f"{tuple(arr.shape)}, template expects {tuple(leaf.shape)}")
        return arr.to(dtype=leaf.dtype, device=leaf.device)
    return _map(template, load)
