"""The FL round as ONE step (``repro.launch.train``: paper Alg. 2, the pod FL
train step, on one card).

``fl_train_step(params, batch, fresh, tau)`` runs a cohort of P
participants: each takes K local SGD steps of ``lm_loss`` on its own shard
(batch leaves carry a leading participant axis P), produces a delta, and
the server applies the staleness-aware (Eq. 2) weighted aggregate of the
deltas.  Host-scale federated training (selection, the stale cache, guards,
telemetry, sweeps) lives in ``repro_torch.sim``; this module is the
full-width train step of one model of the zoo.

Two cohort strategies, as the reference's:

- ``vmap`` (paper-naive): all P fp32 deltas materialize together (P x
  params memory), stacked leaf by leaf along a leading P axis.  They are
  computed one participant at a time: autograd over P copies of a
  full-width model at once would hold P sets of activations.
- ``stream`` (memory-optimal): three passes over the participants with the
  deltas recomputed --
    pass 1: accumulate the fresh average and per-participant ||u||^2;
    pass 2: recompute the deltas, collect <u_hat, u_s> -> exact Lam_s and
            the Eq. 2 weights;
    pass 3: recompute the deltas, accumulate the weighted aggregate.
  Memory is O(1) in P (two fp32 accumulators); compute is 3x.

Each keeps the reference's own Lam formula (``vmap``: ||u_hat - u_s||^2 /
((n_F+1)^2 ||u_hat||^2); ``stream``: its inner-product form), not
``core.staleness.deviation_scores``.  ``param_specs`` (a tree of
``launch.shardings.PartitionSpec``s, the parameters' placement on a
``DeviceMesh``) place the step: params and batch are DTensors, each local
step's gradients are redistributed to their parameter's placement (the
reference's ``_constrain_like``: a token-sharded partial gradient is
reduce-scattered to the parameter's shards), and the step runs under
DTensor's implicit replication, so its plain scalars and masks act as
replicated.  With ``param_specs=None`` the step is the plain one.

    python -m repro_torch.launch.train [--arch internlm2-1.8b] [--rounds 50]
        [--participants 4] [--local-batch 2] [--seq 64] [--rule relay]
        [--device cpu]

trains the arch's REDUCED config on seeded token shards (the GPU unless
``--device`` says otherwise).
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.core.aggregation import tree_leaves, yogi_apply
from repro_torch.core.staleness import EPS, SCALING_RULES
from repro_torch.models import ModelConfig
from repro_torch.models.transformer import lm_loss, tree_map


# ---------------------------------------------------------------------------
# Tree helpers (norms and inner products leaf by leaf, fp32)
# ---------------------------------------------------------------------------


def _tree_dot(a, b):
    return sum(torch.sum(x.float() * y.float())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _tree_sq(a):
    return sum(torch.sum(torch.square(x.float())) for x in tree_leaves(a))


def _tree_axpy_(alpha, x, acc):
    """acc <- alpha * x + acc over trees (fp32 accumulate), in place."""
    for a, b in zip(tree_leaves(x), tree_leaves(acc)):
        b.add_(alpha * a.float())
    return acc


def _zeros_like_f32(tree):
    """fp32 zeros of each leaf's shape, device and (for a DTensor) placement."""
    return tree_map(lambda l: torch.zeros_like(l, dtype=torch.float32), tree)


def _pin_grads(params, grads: list, param_specs) -> list:
    """``grads`` (aligned with ``tree_leaves(params)``) redistributed to
    their parameter's placement in ``param_specs``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.shardings import map_tree, placements
    spec_of = {}
    map_tree(lambda _, w, s: spec_of.__setitem__(id(w), s), params, param_specs)
    out = []
    for w, g in zip(tree_leaves(params), grads):
        if not isinstance(g, DTensor):
            raise TypeError("param_specs place the step on a DeviceMesh: the "
                            "params must be DTensors (launch.shardings."
                            "distribute), got a plain tensor")
        out.append(g.redistribute(g.device_mesh,
                                  placements(spec_of[id(w)], g.device_mesh)))
    return out


def _relay_weights(fresh, tau, lam, *, rule, beta):
    lam_max = torch.max(torch.where(~fresh, lam, torch.zeros_like(lam)))
    w = torch.where(fresh, torch.ones_like(lam),
                    SCALING_RULES[rule](tau, lam, lam_max, beta))
    return w / torch.clamp(w.sum(), min=EPS)


def _participant(batch, i):
    return {k: v[i] for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Participant-local update (K local SGD steps; Alg. 2 inner loop)
# ---------------------------------------------------------------------------


def _participant_delta_fn(cfg: ModelConfig, local_lr: float, local_steps: int,
                          param_specs=None):
    """delta_fn(params, pbatch) -> (delta tree in fp32, mean local loss).
    Each step: w <- (w.f32 - lr * g.f32) cast back to w's dtype; the delta is
    (final - params) in the param dtype, then fp32, as the reference's.
    With ``param_specs`` each step's gradients are pinned to the params'
    placements."""

    def delta_fn(params, pbatch):
        p, losses = params, []
        for _ in range(local_steps):
            q = tree_map(lambda w: w.detach().requires_grad_(), p)
            leaves = tree_leaves(q)
            with torch.enable_grad():
                loss = lm_loss(cfg, q, pbatch)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
            if param_specs is not None:
                grads = _pin_grads(q, grads, param_specs)
            with torch.no_grad():
                g_of = dict(zip(map(id, leaves), grads))
                del grads
                p = tree_map(lambda w: (w.float() - local_lr * g_of.pop(id(w)).float()
                                        ).to(w.dtype), q)
            losses.append(loss.detach())
            del q, leaves, loss
        with torch.no_grad():
            delta = tree_map(lambda a, b: (a - b).float(), p, params)
        return delta, torch.stack(losses).mean()
    return delta_fn


# ---------------------------------------------------------------------------
# Cohort strategies
# ---------------------------------------------------------------------------


def make_fl_aggregate_step(cfg: ModelConfig, *, local_lr: float = 1e-2,
                           rule: str = "relay", beta: float = 0.35,
                           local_steps: int = 1, cohort: str = "vmap",
                           param_specs=None) -> Callable:
    """Returns agg_step(params, batch, fresh, tau) -> (agg_delta, metrics) —
    the SAA-weighted cohort aggregate (fp32 leaves), before any server
    optimizer."""
    return _make_step_impl(cfg, local_lr=local_lr, rule=rule, beta=beta,
                           local_steps=local_steps, cohort=cohort,
                           param_specs=param_specs)


def make_fl_train_step(cfg: ModelConfig, *, local_lr: float = 1e-2,
                       server_lr: float = 1.0, rule: str = "relay",
                       beta: float = 0.35, local_steps: int = 1,
                       cohort: str = "vmap", param_specs=None) -> Callable:
    """FedAvg-server step (Alg. 2): step(params, batch, fresh, tau)
    -> (params, metrics). batch leaves have leading participant axis P."""
    impl = make_fl_aggregate_step(cfg, local_lr=local_lr, rule=rule, beta=beta,
                                  local_steps=local_steps, cohort=cohort,
                                  param_specs=param_specs)

    def step(params, batch, fresh, tau):
        agg, metrics = impl(params, batch, fresh, tau)
        with torch.no_grad():
            new = tree_map(lambda p, d: (p.float() + server_lr * d).to(p.dtype),
                           params, agg)
        return new, metrics
    return step


def make_fl_train_step_yogi(cfg: ModelConfig, *, yogi_lr: float = 1e-2,
                            **kw) -> Callable:
    """YoGi-server step (the paper's aggregator for the non-CIFAR benchmarks):
    step(params, opt_state, batch, fresh, tau) -> (params, opt_state, metrics).
    opt_state from ``repro_torch.core.aggregation.yogi_init``."""
    impl = make_fl_aggregate_step(cfg, **kw)

    def step(params, opt_state, batch, fresh, tau):
        agg, metrics = impl(params, batch, fresh, tau)
        with torch.no_grad():
            new, new_state = yogi_apply(params, agg, opt_state, lr=yogi_lr)
        return new, new_state, metrics
    return step


def _stacked_empty(leaf, P: int):
    """An uninitialised fp32 (P, *leaf.shape) buffer on ``leaf``'s device;
    for a DTensor, a DTensor on its mesh placed as ``leaf`` one dim on."""
    shape = (P,) + tuple(leaf.shape)
    from torch.distributed.tensor import DTensor
    if not isinstance(leaf, DTensor):
        return torch.empty(shape, dtype=torch.float32, device=leaf.device)
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor import empty as dt_empty
    return dt_empty(shape, dtype=torch.float32, device_mesh=leaf.device_mesh,
                    placements=[Shard(p.dim + 1) if p.is_shard() else p
                                for p in leaf.placements])


def _make_step_impl(cfg: ModelConfig, *, local_lr, rule, beta, local_steps,
                    cohort, param_specs) -> Callable:
    delta_fn = _participant_delta_fn(cfg, local_lr, local_steps, param_specs)

    def vmap_step(params, batch, fresh, tau, *, deltas_out=None):
        """``deltas_out`` (a dict) receives the (P, ...) fp32 deltas."""
        P = fresh.shape[0]
        deltas = tree_map(lambda l: _stacked_empty(l, P), params)
        losses = []
        for i in range(P):
            delta, loss = delta_fn(params, _participant(batch, i))
            with torch.no_grad():
                tree_map(lambda d, u: d[i].copy_(u), deltas, delta)
            losses.append(loss)
            del delta
        with torch.no_grad():
            fresh_f = fresh.float()
            n_f = torch.clamp(fresh_f.sum(), min=1.0)
            # u_hat leaf by leaf, never the whole tree at once:
            # Lam_s = ||u_hat - (u_s + n_F u_hat)/(n_F+1)||^2 / ||u_hat||^2
            #       = ||u_hat - u_s||^2 / ((n_F+1)^2 ||u_hat||^2)
            diff_sq = torch.zeros(P, dtype=torch.float32, device=fresh.device)
            uhat_sq = 0.0
            for d in tree_leaves(deltas):
                h = torch.tensordot(fresh_f, d, dims=1) / n_f
                diff_sq = diff_sq + torch.stack(
                    [torch.sum((h - d[j]) ** 2) for j in range(P)])
                uhat_sq = uhat_sq + torch.sum(torch.square(h))
                del h
            lam = diff_sq / ((n_f + 1.0) ** 2 * (uhat_sq + EPS))
            lam = torch.where(fresh, torch.zeros_like(lam), lam)
            w = _relay_weights(fresh, tau, lam, rule=rule, beta=beta)
            agg = tree_map(lambda d: torch.tensordot(w, d, dims=1), deltas)
        if deltas_out is not None:
            deltas_out["deltas"] = deltas
        return agg, {"loss": torch.stack(losses).mean(), "weights": w}

    def stream_step(params, batch, fresh, tau):
        P = fresh.shape[0]
        fresh_f = fresh.float()
        n_f = torch.clamp(fresh_f.sum(), min=1.0)

        # pass 1: fresh average + per-participant squared norms
        acc, loss_sum, sq = _zeros_like_f32(params), 0.0, []
        for i in range(P):
            delta, loss = delta_fn(params, _participant(batch, i))
            with torch.no_grad():
                _tree_axpy_(fresh_f[i], delta, acc)
                sq.append(_tree_sq(delta))
            loss_sum = loss_sum + loss
            del delta
        with torch.no_grad():
            u_hat = tree_map(lambda a: a.div_(n_f), acc)
            uhat_sq = _tree_sq(u_hat)
        del acc

        # pass 2: exact deviations via <u_hat, u_s> (recompute deltas)
        dots = []
        for i in range(P):
            delta, _ = delta_fn(params, _participant(batch, i))
            with torch.no_grad():
                dots.append(_tree_dot(u_hat, delta))
            del delta
        del u_hat
        with torch.no_grad():
            diff_sq = uhat_sq - 2.0 * torch.stack(dots) + torch.stack(sq)
            lam = torch.where(fresh, torch.zeros_like(diff_sq),
                              diff_sq / ((n_f + 1.0) ** 2 * (uhat_sq + EPS)))
            w = _relay_weights(fresh, tau, lam, rule=rule, beta=beta)

        # pass 3: weighted aggregate (recompute deltas)
        agg = _zeros_like_f32(params)
        for i in range(P):
            delta, _ = delta_fn(params, _participant(batch, i))
            with torch.no_grad():
                _tree_axpy_(w[i], delta, agg)
            del delta
        return agg, {"loss": loss_sum / P, "weights": w}

    if cohort == "vmap":
        step = vmap_step
    elif cohort == "stream":
        step = stream_step
    else:
        raise ValueError(cohort)
    if param_specs is None:
        return step

    def placed_step(*args, **kw):
        """The step under DTensor's implicit replication: its plain scalars
        and masks act as replicated."""
        from torch.distributed.tensor.experimental import implicit_replication
        with implicit_replication():
            return step(*args, **kw)
    return placed_step


STREAM_THRESHOLD = 8e9
# The reference's trade (its EXPERIMENTS.md): the vmap cohort's P x fp32
# deltas outgrow a device past ~8B params, where the 3x-recompute stream
# cohort wins.


def default_cohort(cfg: ModelConfig, params_shape) -> str:
    """``stream`` past ``STREAM_THRESHOLD`` params, else ``vmap``.
    ``params_shape`` is a tree whose leaves have a ``.shape`` (meta tensors
    will do): no weights need to exist."""
    n = sum(math.prod(l.shape) for l in tree_leaves(params_shape))
    return "stream" if n > STREAM_THRESHOLD else "vmap"


# ---------------------------------------------------------------------------
# CLI: host-scale federated training of a reduced assigned arch
# ---------------------------------------------------------------------------


def main(argv=None):
    import argparse

    import numpy as np

    from repro_torch.configs import get_reduced
    from repro_torch.data.synthetic import federated_token_shards
    from repro_torch.device import resolve_device
    from repro_torch.models import init_params

    ap = argparse.ArgumentParser(description="FL-cohort training (reduced arch)")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--participants", type=int, default=4)
    ap.add_argument("--local-batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--rule", default="relay")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU, which must exist)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    shards = federated_token_shards(cfg.vocab_size, 32, 64, args.seq, skew=0.3)
    rng = np.random.default_rng(0)
    step = make_fl_train_step(cfg, local_lr=0.05, rule=args.rule)
    for r in range(args.rounds):
        lids = rng.choice(len(shards), args.participants, replace=False)
        sel = lambda k: torch.from_numpy(np.stack([shards[l][k][rng.integers(
            0, len(shards[l][k]), args.local_batch)] for l in lids])).to(device)
        fresh = np.ones(args.participants, bool)
        tau = np.zeros(args.participants, np.int32)
        if r % 3 == 0 and args.participants > 1:
            fresh[-1] = False
            tau[-1] = 2
        params, m = step(params, {"tokens": sel("tokens"), "labels": sel("labels")},
                         torch.from_numpy(fresh).to(device),
                         torch.from_numpy(tau).to(device))
        if (r + 1) % 10 == 0:
            print(f"round {r+1:4d} loss={float(m['loss']):.4f}")
    print("done")


if __name__ == "__main__":
    main()
