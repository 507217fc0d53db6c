"""Learner-side local training for the FL simulation (port of
``repro.sim.learner``).

The default simulation model is a 2-layer MLP classifier; any registered
learner (``repro_torch.learners``: the LM zoo too) trains through the same
``local_train_cohort``.  A round's whole cohort trains in one batched
call: R learners' parameters are stacked into ``(R, ...)`` leaves and
every matmul is batched over the learner axis.  The reference has no kernel for this step (it vmaps a jitted SGD
loop), so it is plain torch.  The backward of the *sum* of per-learner mean
losses gives each learner its own gradient, because rows never mix.

Float32 matmuls run in full fp32: ``fp32_matmuls()`` turns TF32 off in
cuBLAS and cuDNN, since TF32 keeps about three decimal digits and the port
is held against the fp32 reference.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.aggregation import unflatten_update


def fp32_matmuls() -> None:
    """Full fp32 matmuls and convolutions on the GPU (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mlp_init(generator: torch.Generator, dim: int, n_classes: int,
             hidden: int = 128) -> dict:
    """Random MLP parameters (CPU fp32) drawn from ``generator``.  Same
    scales as the reference; torch cannot reproduce the reference's
    ``jax.random`` stream, so parity tests inject the reference's weights."""
    s1, s2 = dim ** -0.5, hidden ** -0.5
    return {
        "w1": torch.randn((dim, hidden), generator=generator) * s1,
        "b1": torch.zeros(hidden),
        "w2": torch.randn((hidden, n_classes), generator=generator) * s2,
        "b2": torch.zeros(n_classes),
    }


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits; batched leaves (R, ...) with x (R, B, dim) run as bmm."""
    if params["w1"].dim() == 3:
        h = F.relu(torch.bmm(x, params["w1"]) + params["b1"][:, None, :])
        return torch.bmm(h, params["w2"]) + params["b2"][:, None, :]
    h = F.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def _losses(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-example cross-entropy of ``logits`` against labels ``y``."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, y[..., None])[..., 0]


def xent(params: dict, x: torch.Tensor, y: torch.Tensor):
    """(mean loss over the last batch axis, per-example losses)."""
    losses = _losses(mlp_apply(params, x), y)
    return losses.mean(dim=-1), losses


def local_train_cohort(flat_params: torch.Tensor, bx: torch.Tensor,
                       by: torch.Tensor, *, spec, lr: float, prox_mu: float,
                       loss=xent, out_dim: int | None = None):
    """K local SGD steps for R learners at once (paper Alg. 2).

    flat_params: the global model in ``spec`` leaf order, fp32: one (D,)
    row every learner starts from, or (R, D) rows, one a learner (a sweep
    batch gathers each row's cell model, as the reference's packed training
    does); a wider, block-padded row is read up to D.  bx: (R, steps,
    batch, *sample) (a classifier's features, or a token sequence); by:
    (R, steps, batch, *label) int64.  ``prox_mu > 0`` adds
    FedProx's proximal term.  Returns (deltas (R, out_dim or D) zero-padded
    past D, mean losses (R,), sqrt(mean loss^2) stats (R,)), each averaged
    over the steps.  Rows never mix, so a row's results do not depend on
    the rows trained beside it.
    """
    d = spec.offsets[-1]
    r, steps = bx.shape[0], bx.shape[1]
    p0 = flat_params[..., :d].expand(r, d)
    p = p0.clone()
    step_losses, step_l2s = [], []
    for k in range(steps):
        p.requires_grad_(True)
        mean, per = loss(unflatten_update(p, spec), bx[:, k], by[:, k])
        (g,) = torch.autograd.grad(mean.sum(), p)
        with torch.no_grad():
            if prox_mu > 0.0:
                g = g + prox_mu * (p - p0)
            p = p - lr * g
        step_losses.append(mean.detach())
        step_l2s.append(torch.sqrt(torch.mean(per.detach() ** 2, dim=-1)))
    width = d if out_dim is None else int(out_dim)
    deltas = torch.zeros((r, width), dtype=torch.float32, device=p.device)
    deltas[:, :d] = p - p0
    return deltas, _step_mean(step_losses), _step_mean(step_l2s)


def _step_mean(per_step: list) -> torch.Tensor:
    """Mean of per-step (R,) vectors, elementwise in step order: a row's
    value does not depend on R (a mean over a stacked (steps, R) block
    picks its blocking by R)."""
    total = per_step[0]
    for x in per_step[1:]:
        total = total + x
    return total / len(per_step)


@torch.no_grad()
def evaluate(params: dict, x: torch.Tensor, y: torch.Tensor):
    """(accuracy, mean loss) of L models at once: leaves batched (L, ...),
    x (L, N, dim), y (L, N) (a shared test set expanded); returns two (L,)
    tensors.  A model's numbers do not depend on L: its logits come from
    its own matrices of the bmm, its accuracy is an exact count, and its
    loss is the mean of its own contiguous row of losses (a mean over an
    (L, N) block picks its blocking by L)."""
    logits = mlp_apply(params, x)
    acc = (logits.argmax(-1) == y).to(torch.float32).mean(dim=-1)
    losses = _losses(logits, y)
    return acc, torch.stack([row.mean() for row in losses])


def sample_batch_indices(shard_idx: np.ndarray, n_steps: int, batch: int,
                         rng: np.random.Generator) -> np.ndarray:
    """Sample indices for one learner's fixed-shape local batches (with
    replacement when the shard is small) — the reference's RNG draw."""
    return rng.choice(shard_idx, size=n_steps * batch,
                      replace=len(shard_idx) < n_steps * batch)


def sample_local_batches(shard_idx: np.ndarray, x: np.ndarray, y: np.ndarray,
                         n_steps: int, batch: int, rng: np.random.Generator):
    """Fixed-shape local batches materialized on the host (the legacy
    engine's): the same RNG draw as ``sample_batch_indices``, whose rows
    the other paths gather on the device."""
    take = sample_batch_indices(shard_idx, n_steps, batch, rng)
    return (x[take].reshape((n_steps, batch) + x.shape[1:]),
            y[take].reshape((n_steps, batch) + y.shape[1:]))
