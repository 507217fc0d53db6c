"""What the sharding tests run inside ranks spawned by
``repro_torch.sim.participant_sharding.run_ranks`` (a module of its own, so
the spawned processes import these functions by name; pytest collects
nothing here).

Each function runs a list of cases on one rank of a gloo group and returns
host objects: summaries, records, final params (numpy), the pipeline's
stats, and the calls the rank made to ``torch.distributed.all_reduce``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch.distributed as dist

BASE = dict(n_learners=30, rounds=8, eval_every=4, n_target=4,
            mapping="label_uniform")


def records(acct) -> list:
    """Every field of every round record."""
    return [dataclasses.astuple(r) for r in acct.records]


def same_records(a: list, b: list) -> bool:
    """``records`` lists equal field by field, NaN equal to NaN (rounds
    without an evaluation)."""
    return len(a) == len(b) and all(
        len(x) == len(y) and all(u == v or (u != u and v != v)
                                 for u, v in zip(x, y))
        for x, y in zip(a, b))


def aggregated_rounds(acct) -> int:
    return sum(1 for r in acct.records if r.n_fresh + r.n_stale > 0)


class CountAllReduce:
    """``torch.distributed.all_reduce`` counted while active."""

    def __enter__(self):
        self.calls, self._orig = 0, dist.all_reduce

        def counted(*args, **kwargs):
            self.calls += 1
            return self._orig(*args, **kwargs)
        dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        dist.all_reduce = self._orig


def _sim_result(pipe, sim, acct, calls) -> dict:
    return {"summary": dict(acct.summary()), "records": records(acct),
            "params": sim.flat_params.numpy().copy(),
            "opt": (None if sim.flat_opt_state is None else
                    {k: v.numpy().copy()
                     for k, v in sim.flat_opt_state.items()}),
            "stats": pipe.stats.as_dict(), "all_reduce_calls": calls,
            "aggregated": aggregated_rounds(acct)}


def run_sims(rank, cases) -> list:
    """Each case ``(cfg kwargs, shard_participants, flat params0 or
    None)``: one simulation on the fused pipeline, sharded over the
    group's ranks (``shard_participants=0``: unsharded on every rank),
    from the given initial weights or the seed's."""
    from repro_torch.sim import SimConfig, Simulator, Substrate
    from repro_torch.sim.pipeline import RoundPipeline
    out = []
    for kw, n_p, flat0 in cases:
        cfg = SimConfig(**kw, shard_participants=n_p)
        sub = None if flat0 is None else Substrate.build(cfg, flat_params0=flat0)
        sim = Simulator(cfg, sub, device="cpu")
        with CountAllReduce() as c:
            pipe = RoundPipeline([sim])
            acct = pipe.run()[0]
        out.append(_sim_result(pipe, sim, acct, c.calls))
    return out


def run_sweeps(rank, cases) -> list:
    """Each case ``(SweepSpec kwargs, SweepRunner sharding kwargs)``: a
    batched sweep on the fused pipeline; per cell its summary, records and
    params, and the runner's batch stats."""
    from repro_torch.sweeps import SweepRunner, SweepSpec
    out = []
    for spec_kw, shard_kw in cases:
        cells = SweepSpec(**spec_kw).expand()
        with CountAllReduce() as c:
            runner = SweepRunner(cells, device="cpu", **shard_kw)
            res = runner.run()
        out.append({"cells": [{"summary": dict(r.summary),
                               "records": records(r.acct),
                               "params": sim.flat_params.numpy().copy()}
                              for r, sim in zip(res, runner.sims)],
                    "stats": runner.batch_stats, "all_reduce_calls": c.calls})
    return out


def run_crash_resume(rank, kw, n_p, path, crash_after) -> dict:
    """A sharded run that snapshots every 2 rounds and crashes (soft)
    after round ``crash_after``; then every rank rebuilds the pipeline
    from the snapshot rank 0 wrote and runs it to the end.  The resumed
    run's result."""
    from repro_torch.checkpoint.state import (build_resumed_pipeline,
                                              load_snapshot)
    from repro_torch.faults import FaultPlan, InjectedCrash
    from repro_torch.sim import SimConfig, Simulator
    cfg = SimConfig(**kw, shard_participants=n_p)
    plan = FaultPlan(cfg.n_learners, cfg.rounds, crash_after=crash_after,
                     crash_mode="soft")
    sim = Simulator(cfg, device="cpu", fault_plan=plan)
    try:
        sim.run(checkpoint_path=path, checkpoint_every=2)
        raise AssertionError("the crash did not fire")
    except InjectedCrash:
        pass
    dist.barrier()                 # rank 0's snapshot is on disk
    pipe = build_resumed_pipeline(load_snapshot(path), device="cpu")
    with CountAllReduce() as c:
        acct = pipe.run()[0]
    return _sim_result(pipe, pipe.sims[0], acct, c.calls)


def bits(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.int32)
