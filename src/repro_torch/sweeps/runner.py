"""Batched multi-simulation executor (port of ``repro.sweeps.runner``; a
fused batch runs in ``SimConfig.rounds_per_dispatch``-round chunks,
optionally sharded over a round mesh of ranks).

``SweepRunner`` drives compatible cells (``compat_key``) in lockstep.
Each round every cell's host state machine runs per cell (the Simulator's
own stages, shared code with serial runs), while the device work is
batched across the sweep axis.  Two executors:

  * the fused device-resident pipeline (``fused_rounds=True``,
    ``repro_torch.sim.pipeline.RoundPipeline``): one packed training call
    over every live cell's survivors, straggler scatter into the batch's
    one device stale cache, a (G, n, D) aggregation operand and one server
    step for all G groups (kernel 1, or kernel 2 + YoGi, or the robust step
    with one launch of kernel 7), and one evaluation per substrate;
  * the per-stage batched path (``fused_rounds=False``): the packed
    training call, each cell's host-side update collection,
    ``sweep_bucket_pad`` + ``sweep_aggregate_flat`` (kernel 2 in one launch
    under ``use_agg_kernel``) or the robust step, a batched FedAvg / YoGi
    apply and the batched evaluation.

No reduction a cell's numbers go through depends on the batch around it
(``repro_torch.sim.pipeline``), so on the CPU every cell's metrics are bit
for bit those of a serial ``Simulator.run`` of the same config
(``tests/test_torch_sweeps.py``).  On the GPU, cuBLAS's batched GEMM may
give one matrix other bits at another batch count: ``chip_smoke.py``
probes it at the sweep's training shapes and prints what it finds.

Cells sharing a substrate key also share one ``Substrate`` build and its
device copy of the dataset.  A fault plan (``fault_plan``) applies to
every cell, guarded cells screen their rows on both executors, and a fused
sweep takes crash-safe snapshots (``checkpoint_path``,
``checkpoint_every``: the in-flight batch's pipeline snapshot in an
envelope with the grid and the finished cells' accountings), which
``resume_sweep`` finishes bit for bit.  A ``TelemetrySession``
(``telemetry``) is shared by every batch: one registry, one trace (a
``batch`` span a fused batch) and, for level-2 cells, one round log, a
line a cell and recorded round.  ``shard``, ``mesh`` and
``shard_participants`` shard each fused batch over a round mesh of the
default process group's ranks (``repro_torch.sim.participant_sharding``),
as the reference composes them; every rank runs the same ``SweepRunner``
and ends with the same results.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.aggregation import (screen_rows, sweep_aggregate_flat,
                                          sweep_bucket_pad, yogi_apply_flat)
from repro_torch.core.staleness import RULE_ID
from repro_torch.robust.aggregators import robust_sweep
from repro_torch.sim.engine import (SharedData, Simulator, Substrate,
                                    resolve_device, substrate_key,
                                    train_packed)
from repro_torch.sim.participant_sharding import (as_round_mesh, n_ranks,
                                                  participant_mesh,
                                                  round_mesh)
from repro_torch.sim.pipeline import RoundPipeline, pipeline_key
from repro_torch.sweeps.grid import Cell
from repro_torch.sweeps.results import CellResult, SweepResults


def compat_key(cfg) -> tuple:
    """Cells sharing this key run in one lockstep batch: ``pipeline_key``
    (the fields that fix the round's device work or its cadence, the
    selector among them, so batches are selector-uniform) and the
    substrate (fused or per-stage).  Everything else (SAA, APT, setting,
    hardware, seeds, beta, server_lr, target_accuracy, and off the kernels
    the scaling rule) varies freely within a batch."""
    return pipeline_key(cfg) + (cfg.fused_rounds,)


@dataclasses.dataclass
class SweepRunner:
    """Expand cells (``SweepSpec.expand()``) and run them batched, on the
    GPU unless ``device`` names another (without a GPU it raises unless
    ``device="cpu"``).  ``substrate_cache`` maps ``substrate_key`` to a
    prebuilt ``Substrate`` (the tests inject the reference's initial
    weights this way); ``fault_plan`` applies to every cell;
    ``checkpoint_path`` with ``checkpoint_every`` writes a resumable sweep
    snapshot every ``checkpoint_every`` rounds of a fused batch;
    ``telemetry`` is a ``TelemetrySession`` every fused batch shares.
    ``shard=True`` places each fused batch's cells on the sweep axis "s"
    of a round mesh over every rank of the default process group (pass
    ``mesh=``, a ``RoundMesh`` or an ``{"s": n, "p": n}`` shape, for
    another); ``shard_participants`` adds the participant axis "p": True
    takes every rank (sweep-axis sharding off), an int N combines with
    ``shard=True`` as an ``(n_ranks // N) x N`` mesh.  Without a process
    group the mesh is one rank.  After ``run()``, ``sims[i]`` holds cell i's finished Simulator (its
    final ``flat_params``) and ``batch_stats`` each fused batch's
    ``PipelineStats.as_dict()``, in batch order: without a session each
    batch's own counters, with one the shared registry's totals so far
    (the graph counters stay each batch's own)."""
    cells: Sequence[Cell]
    device: Optional[object] = None
    substrate_cache: Optional[dict] = None
    fault_plan: Optional[object] = None
    progress: bool = False
    shard: bool = False
    mesh: Optional[object] = None
    shard_participants: object = 0
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0
    telemetry: Optional[object] = None

    def __post_init__(self):
        if self.mesh is None and (self.shard or self.shard_participants):
            n = n_ranks()
            if not self.shard:
                self.mesh = participant_mesh(self.shard_participants)
            elif not self.shard_participants:
                self.mesh = round_mesh(n, 1)
            else:
                n_p = int(self.shard_participants)
                if self.shard_participants is True or n_p < 1 or n % n_p:
                    raise ValueError(
                        "shard=True with shard_participants needs an integer "
                        f"participant shard count dividing the {n} ranks")
                self.mesh = round_mesh(n // n_p, n_p)
        if self.mesh is not None:
            self.mesh = as_round_mesh(self.mesh)
            for c in self.cells:
                if not c.config.fused_rounds:
                    raise ValueError(
                        f"cell {c.name}: round-mesh sharding requires the "
                        "fused pipeline (fused_rounds=True)")
        self.device = resolve_device(self.device)
        if self.substrate_cache is None:
            self.substrate_cache = {}
        self.sims = [None] * len(self.cells)
        self.batch_stats = []

    def substrate(self, cfg) -> Substrate:
        key = substrate_key(cfg)
        if key not in self.substrate_cache:
            self.substrate_cache[key] = Substrate.build(cfg)
        return self.substrate_cache[key]

    def batches(self) -> list:
        """The cell indices of each lockstep batch, in first-seen order."""
        groups: "OrderedDict[tuple, list]" = OrderedDict()
        for i, c in enumerate(self.cells):
            groups.setdefault(compat_key(c.config), []).append(i)
        return list(groups.values())

    def run(self, completed: Optional[dict] = None) -> SweepResults:
        """Run every batch not in ``completed`` (cell index -> finished
        Accounting: a resumed sweep's), in order."""
        completed = {} if completed is None else completed
        for idxs in self.batches():
            if idxs[0] in completed:
                continue
            sims = [Simulator(self.cells[i].config,
                              substrate=self.substrate(self.cells[i].config),
                              device=self.device, fault_plan=self.fault_plan)
                    for i in idxs]
            if sims[0].cfg.fused_rounds:
                with self._span("batch", cells=len(idxs)):
                    pipe = RoundPipeline(
                        sims, progress=self.progress,
                        checkpoint_path=self.checkpoint_path,
                        checkpoint_every=self.checkpoint_every,
                        checkpoint_wrap=self._ckpt_wrap(idxs, completed),
                        telemetry=self.telemetry,
                        labels=[self.cells[i].name for i in idxs],
                        mesh=self.mesh)
                    accts = pipe.run()
                self.batch_stats.append(pipe.stats.as_dict())
            else:
                accts = self._run_batch_stages(sims)
            for i, sim, acct in zip(idxs, sims, accts):
                self.sims[i] = sim
                completed[i] = acct
        return SweepResults([CellResult(cell=c, summary=completed[i].summary(),
                                        acct=completed[i])
                             for i, c in enumerate(self.cells)])

    def _span(self, name: str, **args):
        """A span of the shared session (a null context without one)."""
        if self.telemetry is None:
            return contextlib.nullcontext()
        return self.telemetry.span(name, **args)

    def _ckpt_wrap(self, idxs, completed):
        """The envelope of a batch's pipeline snapshots: the grid, the
        cells finished before this batch (``completed``, read when the
        snapshot is taken) and the batch's cell indices, which
        ``resume_sweep`` reads."""
        def wrap(pipeline_payload):
            return {"version": 1, "kind": "sweep", "cells": list(self.cells),
                    "completed": dict(completed), "group": list(idxs),
                    "fault_plan": self.fault_plan,
                    "checkpoint_every": self.checkpoint_every,
                    "pipeline": pipeline_payload}
        return wrap

    def _run_batch_stages(self, sims):
        """The per-stage batched executor (``fused_rounds=False``): the
        serial flat path's stages, with the device stages batched."""
        cfg0 = sims[0].cfg
        s, dev = len(sims), self.device
        data = SharedData(sims, dev)
        params = torch.stack([sim.flat_params for sim in sims])
        yogi = cfg0.server_opt == "yogi"
        opt = ({k: torch.stack([sim.flat_opt_state[k] for sim in sims])
                for k in ("m", "v", "t")} if yogi else None)
        lr = torch.tensor([[sim.cfg.server_lr] for sim in sims],
                          dtype=torch.float32, device=dev)
        counts_all = torch.zeros((s, 2), dtype=torch.int32, device=dev)
        robust = sims[0]._attack is not None or sims[0]._robust is not None
        guard = ((cfg0.guard_clip, cfg0.guard_reject_mult,
                  max(int(cfg0.quorum), 1)) if cfg0.guard else None)
        done = [False] * s
        for r in range(cfg0.rounds):
            if all(done):
                break
            with record_function("round.schedule"):
                plans = {}
                for i, sim in enumerate(sims):
                    if not done[i]:
                        plan = sim._begin_round(r)
                        if plan is not None:
                            plans[i] = plan
            if not plans:
                continue
            order = list(plans)
            with record_function("round.device"):
                deltas, l2, first = train_packed(sims, data, params, plans,
                                                 order)
                l2_host = None if l2 is None else l2.cpu().numpy()
            with record_function("round.schedule"):
                tails, updates = {}, {}
                for i in order:
                    plan = plans[i]
                    surv, pos = sims[i].survivors(plan)
                    l2s = np.zeros(plan.k, np.float32)
                    cell_deltas = None
                    if len(surv):
                        lo = first[i]
                        l2s[surv] = l2_host[lo:lo + len(surv)]
                        cell_deltas = sims[i]._corrupt_deltas(
                            r, plan, deltas[lo:lo + len(surv)])
                    t_end, fresh, stale, taus, lids = sims[i]._collect_updates(
                        r, plan, cell_deltas, pos, l2s)
                    tails[i] = (t_end, len(fresh), len(stale))
                    if fresh or stale:
                        updates[i] = ((fresh + stale,
                                       [True] * len(fresh) + [False] * len(stale),
                                       [0] * len(fresh) + list(taus)), lids)
            groups = list(updates)
            if groups:
                with record_function("round.device"):
                    self._server_step(r, sims, groups, updates, params, opt,
                                      lr, counts_all, robust, guard)
            acc = loss = None
            if sims[order[0]].eval_due(r):
                with record_function("round.eval"):
                    acc, loss = data.evaluate(sims, params, order)
            for k, i in enumerate(order):
                t_end, n_fresh, n_stale = tails[i]
                sims[i]._record_round(
                    r, plans[i].t_now, t_end, len(plans[i].chosen), n_fresh,
                    n_stale, progress=self.progress,
                    acc_loss=None if acc is None else (acc[k], loss[k]))
                if sims[i]._target_reached():
                    sims[i].acct.stopped_early = True
                    done[i] = True
        accts = []
        for i, sim in enumerate(sims):
            sim.flat_params = params[i].clone()
            if yogi:
                sim.flat_opt_state = {k: v[i].clone() for k, v in opt.items()}
            sim.robust_counts = counts_all[i].clone()
            accts.append(sim._finalize())
        return accts

    @staticmethod
    def _server_step(r, sims, groups, updates, params, opt, lr, counts_all,
                     robust, guard=None):
        """One batched aggregation and server step over the cells
        ``groups``, in place on ``params`` / ``opt`` / ``counts_all``.
        Under the ``guard`` (clip, reject_mult, quorum) the padded operand
        is screened once and its survivor mask is the aggregate's
        ``valid`` (``fresh`` unmasked, as the reference's per-stage sweep
        hands its kernel), each cell's counts go to its accounting, and a
        cell below the quorum keeps its params and YoGi state."""
        cfg0 = sims[0].cfg
        d, dev = params.shape[1], params.device
        idx = (slice(None) if groups == list(range(len(sims)))
               else torch.as_tensor(groups, device=dev))
        screened = None
        u, fresh, tau, valid, _ = sweep_bucket_pad(
            [updates[i][0] for i in groups], d)
        sizes = [len(updates[i][0][0]) for i in groups]
        if robust:
            att = None
            if sims[0]._attack is not None:
                flags = np.zeros(tuple(valid.shape), bool)
                for k, i in enumerate(groups):
                    flags[k, :sizes[k]] = sims[i].attack_flags(r, updates[i][1])
                att = torch.as_tensor(flags, device=dev)
            agg, counts = robust_sweep(
                u, fresh, tau, valid, att, sizes, attack=sims[0]._attack,
                robust=sims[0]._robust, betas=[sims[i].cfg.beta for i in groups],
                rule_ids=[RULE_ID[sims[i].cfg.scaling_rule] for i in groups],
                use_kernel=cfg0.use_agg_kernel,
                guard=None if guard is None else guard[:2])
            counts_all[idx] += counts[:, :2]
            if guard is not None:
                screened = counts[:, 2:].cpu()
        else:
            if guard is not None:
                u, valid, n_nf, n_out, _ = screen_rows(
                    u, valid, clip=guard[0], reject_mult=guard[1])
                screened = torch.stack(
                    [n_nf, n_out, valid.sum(dim=1, dtype=torch.int32)],
                    dim=1).cpu()
            agg, _ = sweep_aggregate_flat(
                u, fresh, tau, valid, [sims[i].cfg.beta for i in groups],
                rule=[sims[i].cfg.scaling_rule for i in groups],
                use_kernel=cfg0.use_agg_kernel, sizes=sizes)
        gate = None
        if screened is not None:
            ok = screened[:, 2] >= guard[2]
            for (n_nf, n_out, _), applied, i in zip(screened.tolist(),
                                                    ok.tolist(), groups):
                sims[i].acct.note_guard(n_nf, n_out, applied)
            gate = ok.to(dev)
        old = params[idx]
        if opt is not None:
            st = {k: v[idx] for k, v in opt.items()}
            new, st_new = yogi_apply_flat(old, agg, st)
            for k, v in st_new.items():
                if gate is not None:      # a quorum skip keeps the state
                    v = torch.where(gate.view((-1,) + (1,) * (v.dim() - 1)),
                                    v, st[k])
                opt[k][idx] = v
        else:
            new = old + lr[idx] * agg
        params[idx] = new if gate is None else torch.where(gate[:, None],
                                                           new, old)


# ---------------------------------------------------------------------------
# Batched-vs-serial harness (``python -m repro_torch.sweeps``, chip_smoke.py)
# ---------------------------------------------------------------------------


def run_serial(cells: Sequence[Cell], device=None, substrate_cache=None):
    """The baseline a sweep replaces: one ``Simulator(cfg).run()`` per cell
    (a fresh substrate each, or the one in ``substrate_cache``).  Returns
    (summaries, wall seconds)."""
    device = resolve_device(device)
    t0 = time.time()
    summaries = []
    for c in cells:
        key = substrate_key(c.config)
        sub = None if substrate_cache is None else substrate_cache.get(key)
        summaries.append(Simulator(c.config, substrate=sub,
                                   device=device).run().summary())
    return summaries, time.time() - t0


def run_batched(cells: Sequence[Cell], device=None, shard: bool = False,
                mesh=None, shard_participants=0, fault_plan=None,
                checkpoint_path=None, checkpoint_every: int = 0,
                telemetry=None, substrate_cache=None):
    """Returns (SweepResults, wall seconds); wall includes substrate
    builds."""
    t0 = time.time()
    results = SweepRunner(cells, device=device,
                          substrate_cache=substrate_cache,
                          fault_plan=fault_plan, shard=shard, mesh=mesh,
                          shard_participants=shard_participants,
                          checkpoint_path=checkpoint_path,
                          checkpoint_every=checkpoint_every,
                          telemetry=telemetry).run()
    return results, time.time() - t0


def resume_sweep(path: str, progress: bool = False, telemetry=None,
                 device=None, shard: bool = False, mesh=None,
                 shard_participants=0):
    """Finish a sweep from its snapshot (``SweepRunner`` with
    ``checkpoint_path``): the batches finished before the crash come back
    from their stored accountings, the batch in flight resumes its
    pipeline mid-run, and the batches never started run afresh, each
    cell bit for bit the uninterrupted sweep's.  Returns (SweepResults,
    wall seconds).  ``telemetry``: the session of the resumed batches (its
    round log truncated to the snapshot's offset first); ``shard``,
    ``mesh``, ``shard_participants``: their round mesh, as
    ``SweepRunner`` takes it (every rank resumes the same snapshot)."""
    from repro_torch.checkpoint.state import (SnapshotError,
                                              build_resumed_pipeline,
                                              load_snapshot)
    t0 = time.time()
    payload = load_snapshot(path)
    if payload["kind"] != "sweep":
        raise SnapshotError(f"{path!r} is a {payload['kind']!r} snapshot, "
                            "not a sweep snapshot (use repro_torch."
                            "checkpoint.resume_run)")
    completed = dict(payload["completed"])
    fp = payload.get("fault_plan")
    runner = SweepRunner(payload["cells"], device=device, progress=progress,
                         fault_plan=None if fp is None else fp.without_crash(),
                         telemetry=telemetry, shard=shard, mesh=mesh,
                         shard_participants=shard_participants)
    with runner._span("batch", cells=len(payload["group"])):
        pipe = build_resumed_pipeline(payload["pipeline"], progress=progress,
                                      device=runner.device,
                                      telemetry=telemetry, mesh=runner.mesh)
        accts = pipe.run()
    for i, acct in zip(payload["group"], accts):
        completed[i] = acct
    return runner.run(completed), time.time() - t0


# the summary fields that host decisions alone fix (selection, schedule,
# accounting, stop round, robust counts); the accuracies read the model
HOST_KEYS = ("rounds", "sim_time", "resource_used", "resource_wasted",
             "waste_fraction", "unique_participants", "stopped_early",
             "rejected_nonfinite", "rejected_norm", "quorum_skips",
             "robust_rejected", "robust_trimmed")


def exact_parity(device) -> bool:
    """Whether batched runs equal serial runs bit for bit on ``device``:
    on the CPU they do; on the GPU cuBLAS's batched GEMM gives one matrix
    other bits at another batch count (the probe ``chip_smoke.py`` prints),
    so a batch's training differs from a serial run's in the last bits and
    only the host decisions are held equal there."""
    return torch.device(device).type == "cpu"


def summaries_equal(a: dict, b: dict, keys=None) -> bool:
    """Exact summary comparison (NaN-tolerant for the accuracy fields), of
    every key or of ``keys``."""
    if set(a) != set(b):
        return False
    return all(a[k] == b[k] or (a[k] != a[k] and b[k] != b[k])
               for k in (a if keys is None else keys))


def assert_parity(results: SweepResults, serial_summaries,
                  exact: bool = True) -> None:
    """Each cell's summary equals its serial run's: every key, or with
    ``exact=False`` the ``HOST_KEYS``."""
    keys = None if exact else HOST_KEYS
    for res, ser in zip(results, serial_summaries):
        if not summaries_equal(dict(res.summary), dict(ser), keys):
            raise AssertionError(
                f"sweep parity violation at cell {res.cell.name}:\n"
                f"  batched: {res.summary}\n  serial : {ser}")
