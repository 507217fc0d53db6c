"""Batched multi-simulation executor (port of ``repro.sweeps.runner``,
unsharded; a fused batch runs in ``SimConfig.rounds_per_dispatch``-round
chunks).

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
device copy of the dataset.  Sweep-axis and participant sharding (ROADMAP
queue 1 item 14), checkpoints (item 10) and telemetry (item 12) are not
ported: asking for them raises.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.aggregation import (sweep_aggregate_flat,
                                          sweep_bucket_pad, yogi_apply_flat)
from repro_torch.core.staleness import RULE_ID
from repro_torch.robust.aggregators import robust_sweep
from repro_torch.sim.engine import (SharedData, Simulator, Substrate,
                                    resolve_device, substrate_key,
                                    train_packed)
from repro_torch.sim.pipeline import RoundPipeline, pipeline_key
from repro_torch.sweeps.grid import Cell
from repro_torch.sweeps.results import CellResult, SweepResults


def unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               f"(ROADMAP.md queue 1 item {item})")


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
    weights this way); ``fault_plan`` (attacker sets only) applies to
    every cell.  After ``run()``, ``sims[i]`` holds cell i's finished
    Simulator (its final ``flat_params``) and ``batch_stats`` each fused
    batch's ``PipelineStats.as_dict()``, in batch order."""
    cells: Sequence[Cell]
    device: Optional[object] = None
    substrate_cache: Optional[dict] = None
    fault_plan: Optional[object] = None
    progress: bool = False
    shard: bool = False
    mesh: Optional[object] = None
    shard_participants: object = 0
    checkpoint_path: Optional[str] = None
    telemetry: Optional[object] = None

    def __post_init__(self):
        if self.shard or self.mesh is not None or self.shard_participants:
            raise unported("sweep-axis and participant sharding", 14)
        if self.checkpoint_path is not None:
            raise unported("sweep checkpoints", 10)
        if self.telemetry is not None:
            raise unported("sweep telemetry", 12)
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

    def run(self) -> SweepResults:
        results: list = [None] * len(self.cells)
        for idxs in self.batches():
            sims = [Simulator(self.cells[i].config,
                              substrate=self.substrate(self.cells[i].config),
                              device=self.device, fault_plan=self.fault_plan)
                    for i in idxs]
            if sims[0].cfg.fused_rounds:
                pipe = RoundPipeline(sims, progress=self.progress)
                accts = pipe.run()
                self.batch_stats.append(pipe.stats.as_dict())
            else:
                accts = self._run_batch_stages(sims)
            for i, sim, acct in zip(idxs, sims, accts):
                self.sims[i] = sim
                results[i] = CellResult(cell=self.cells[i],
                                        summary=acct.summary(), acct=acct)
        return SweepResults(results)

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
                        cell_deltas = deltas[lo:lo + len(surv)]
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
                                      lr, counts_all, robust)
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
                     robust):
        """One batched aggregation and server step over the cells
        ``groups``, in place on ``params`` / ``opt`` / ``counts_all``."""
        cfg0 = sims[0].cfg
        d = params.shape[1]
        u, fresh, tau, valid, _ = sweep_bucket_pad(
            [updates[i][0] for i in groups], d)
        dev = params.device
        idx = (slice(None) if groups == list(range(len(sims)))
               else torch.as_tensor(groups, device=dev))
        if robust:
            sizes = [len(updates[i][0][0]) for i in groups]
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
                use_kernel=cfg0.use_agg_kernel)
            counts_all[idx] += counts
        else:
            agg, _ = sweep_aggregate_flat(
                u, fresh, tau, valid, [sims[i].cfg.beta for i in groups],
                rule=[sims[i].cfg.scaling_rule for i in groups],
                use_kernel=cfg0.use_agg_kernel)
        if opt is not None:
            st = {k: v[idx] for k, v in opt.items()}
            new, st = yogi_apply_flat(params[idx], agg, st)
            params[idx] = new
            for k, v in st.items():
                opt[k][idx] = v
        else:
            params[idx] = params[idx] + lr[idx] * agg


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
                checkpoint_path=None, telemetry=None, substrate_cache=None):
    """Returns (SweepResults, wall seconds); wall includes substrate
    builds."""
    t0 = time.time()
    results = SweepRunner(cells, device=device,
                          substrate_cache=substrate_cache,
                          fault_plan=fault_plan, shard=shard, mesh=mesh,
                          shard_participants=shard_participants,
                          checkpoint_path=checkpoint_path,
                          telemetry=telemetry).run()
    return results, time.time() - t0


def resume_sweep(path: str, progress: bool = False, telemetry=None):
    """Resuming a sweep from a crash-safe snapshot needs checkpoints."""
    raise unported("sweep resume (checkpoints)", 10)


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
