"""Device-resident round pipeline for S >= 1 lockstep simulations (port of
the K = 1, unsharded case of ``repro.sim.pipeline``).

``RoundPipeline`` drives one Simulator (``Simulator.run()`` passes
``[self]``) or a sweep batch of compatible ones (``pipeline_key``): every
round, each live cell's host state machine runs first, then ONE device
round serves every cell:

  1. the cohorts' local batches are gathered on the device from one copy
     of each distinct substrate's dataset (the host sends one packed int64
     index tensor a round);
  2. every live cell's surviving learners train in one batched call, each
     row from its own cell's model (a serial run broadcasts its one row);
  3. straggler rows are scattered into the batch's one device stale cache
     *before* the landing rows are gathered out of it — the slots freed by
     a round's landings (any cell's) are quarantined for one round, so a
     round's scatter slots never collide with its gather slots;
  4. the round's G aggregation groups (the live cells with fresh or landing
     rows) form one (G, n, D) operand, padded with invalid zero rows to the
     round's largest group, and the server step runs on it: under
     ``use_agg_kernel`` FedAvg is ONE launch of
     ``sweep_fused_staleness_apply`` (kernel 1) with per-cell ``(beta,
     server_lr)`` rows, YoGi one launch of ``sweep_fused_staleness_aggregate``
     (kernel 2) before its batched elementwise step; an attacked or robust
     batch runs ``robust.aggregators.robust_sweep`` (the coordinate-wise
     kinds under ``use_agg_kernel``: ONE launch of kernel 7 for the G
     groups); without the kernels each group runs ``core.aggregation``'s
     torch path on its own rows;
  5. on ``eval_every`` rounds the cells are evaluated in one batched call
     per substrate.

Every decision of a round depends only on durations and dropouts, never on
update values, so the host side equals the reference's.  Per-cell results
are bit-identical to serial runs because no reduction a cell's numbers go
through depends on the batch: training rows never mix, the CUDA SAA
kernels and kernel 7 reduce each cell apart (padding adds exact zeros, or
``+inf`` rows past the band), and the torch steps whose blocking follows
their shape (row norms and sums over D, a mean over an (L, N) block) run
per group on the group's own rows.

A ``needs_feedback`` selector (oort, ucb, contribution) reads each
arrival's statistical utility from the training's per-row l2 stats: its
batch copies the round's stats to the host once, after the device round
(span ``round.feedback``), then applies each cell's feedback and caches its
stragglers, cell by cell in batch order, before the next round's selection.
Any other selector gets its feedback (utility 0) before the device round.

A cell whose evaluation reaches its ``target_accuracy`` leaves the live
set: no host stage, no rows, no group, no evaluation.  Eager torch has no
shape buckets to repack, so leaving is dropping the cell's index.

The params rows, the cache rows and the YoGi state are kept ``d_pad`` wide
under the SAA kernels (D rounded up to their 2048-column block); the pad
columns stay exact zeros because the deltas are zero-padded where they are
made and every server operation is columnwise.  Attacked and robust
batches keep the true D, as the reference does: their row norms, means and
distances reduce over the last axis, and reducing over the pad would
change their bits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.aggregation import (flat_dim, no_stale_aggregate,
                                          weights_and_aggregate_by_id,
                                          yogi_apply_flat, yogi_init_flat)
from repro_torch.core.stale_cache import DeviceStaleCache
from repro_torch.core.staleness import RULE_ID
from repro_torch.faults import attack_key
from repro_torch.kernels.staleness_agg import ops as saa_ops
from repro_torch.learners import model_key
from repro_torch.robust import robust_key
from repro_torch.robust.aggregators import robust_sweep
from repro_torch.selection.registry import selector_key
from repro_torch.sim.engine import (SharedData, _InFlight, agg_lids,
                                   train_packed)


def pipeline_key(cfg) -> tuple:
    """Config fields every Simulator of one pipeline must share: they fix
    the round's device work or the lockstep cadence (the reference's
    ``pipeline_key``).  ``repro_torch.sweeps.runner.compat_key`` groups
    cells by it."""
    return (cfg.benchmark, cfg.local_steps, cfg.local_batch, cfg.local_lr,
            cfg.prox_mu, cfg.rounds, cfg.eval_every, cfg.server_opt,
            robust_key(cfg), attack_key(cfg), selector_key(cfg),
            cfg.use_agg_kernel,
            cfg.scaling_rule if cfg.use_agg_kernel else None,
            cfg.rounds_per_dispatch, cfg.shard_participants,
            cfg.guard, cfg.guard_clip, cfg.guard_reject_mult, cfg.quorum,
            cfg.telemetry, model_key(cfg))


@dataclasses.dataclass
class RoundWork:
    """One round's host outcome for the cells that took part: their plans,
    schedules and appended records; the device round and the evaluation
    remain."""
    r: int
    order: list          # cells with a plan this round, in batch order
    plans: dict
    scheds: dict
    recs: dict
    first: dict = None   # cell -> its survivors' first packed row (set by
                         # the device round)


def _quarantine_frees(order, scheds) -> list:
    """Cache slots released by a round's landings and expiries (every
    cell's); the pipeline frees them one round later."""
    return [f.delta for i in order
            for f in scheds[i].landing + scheds[i].expired]


class RoundPipeline:
    def __init__(self, sims, progress: bool = False):
        sims = list(sims) if isinstance(sims, (list, tuple)) else [sims]
        cfg0 = sims[0].cfg
        for sim in sims:
            if pipeline_key(sim.cfg) != pipeline_key(cfg0):
                raise ValueError("incompatible Simulators in one pipeline "
                                 "batch (pipeline_key differs)")
            if sim.device != sims[0].device:
                raise ValueError("a pipeline batch runs on one device")
        self.sims = sims
        self.progress = progress
        self.device = dev = sims[0].device
        self.spec = sims[0]._flat_spec
        self.d = flat_dim(self.spec)
        self.attack, self.robust = attack_key(cfg0), robust_key(cfg0)
        robust = self.attack is not None or self.robust is not None
        self.d_pad = (self.d + (-self.d) % saa_ops.D_BLK
                      if cfg0.use_agg_kernel and not robust else self.d)
        s = len(sims)
        # (S, d_pad): the kernels' (S, D) params operand, a row a cell
        self.params = torch.zeros((s, self.d_pad), dtype=torch.float32,
                                  device=dev)
        for i, sim in enumerate(sims):
            self.params[i, :self.d] = sim.flat_params
        self.cache = DeviceStaleCache(
            self.d_pad, capacity=max(sim.cfg.stale_cache_capacity
                                     for sim in sims), device=dev)
        self.yogi = cfg0.server_opt == "yogi"
        if self.yogi:
            st = yogi_init_flat(self.d, device=dev, width=self.d_pad)
            self.opt_state = {"m": st["m"].repeat(s, 1),
                              "v": st["v"].repeat(s, 1),
                              "t": torch.zeros(s, dtype=torch.int32,
                                               device=dev)}
        else:
            self.opt_state = None
        # per-cell (beta, server_lr) rows: the kernel's scal operand
        self._scal = torch.tensor([[sim.cfg.beta, sim.cfg.server_lr]
                                   for sim in sims], dtype=torch.float32,
                                  device=dev)
        self.robust_counts = torch.zeros((s, 2), dtype=torch.int32,
                                         device=dev)
        self.data = SharedData(sims, dev)
        self.fetch_l2s = sims[0]._sel_spec.needs_feedback
        self.done = [False] * s
        self._pending_free = []   # freed slots quarantined for one round

    def run(self):
        """Drive every round, then finalize; returns the cells'
        Accountings, in batch order."""
        for sim in self.sims:
            sim._t_now = 0.0
        for r in range(self.sims[0].cfg.rounds):
            if all(self.done):
                break
            self.step(r)
        return self.finalize()

    def step(self, r: int) -> list:
        """One round of every live cell: the host state machines, the
        device round, the evaluation when due, the early stops.  Returns
        each cell's RoundRecord (None for a cell that skipped the round or
        had stopped)."""
        with record_function("round.schedule"):
            work = self._schedule(r)
        if work is None:
            return [None] * len(self.sims)
        with record_function("round.device"):
            l2 = self._device_round(r, work)
        if self.fetch_l2s:
            with record_function("round.feedback"):
                self._fetch_feedback(work, l2)
        if self.sims[work.order[0]].eval_due(r):
            with record_function("round.eval"):
                self._eval(work)
        return [work.recs.get(i) for i in range(len(self.sims))]

    def _schedule(self, r: int):
        """The host half of round ``r`` for every live cell: plans,
        schedules, cache slots, feedback (for a selector that reads no
        stats) and records.  None when every cell skipped the round."""
        sims = self.sims
        plans = {}
        for i, sim in enumerate(sims):
            if not self.done[i]:
                plan = sim._begin_round(r)
                if plan is not None:
                    plans[i] = plan
        if not plans:
            return None
        order = list(plans)
        scheds = {i: sims[i]._schedule_round(r, plans[i]) for i in order}
        if self._pending_free:
            self.cache.free(self._pending_free)
        self._pending_free = _quarantine_frees(order, scheds)
        for i in order:
            if scheds[i].new_stale:
                scheds[i].slots = self.cache.alloc(len(scheds[i].new_stale))
        if not self.fetch_l2s:
            for i in order:
                self._feedback(sims[i], r, scheds[i], None)
        recs = {i: sims[i]._advance_round_state(
            r, plans[i].t_now, scheds[i].t_end, len(plans[i].chosen),
            len(scheds[i].fresh_rows), len(scheds[i].landing))
            for i in order}
        return RoundWork(r, order, plans, scheds, recs)

    @staticmethod
    def _feedback(sim, r, sched, l2s) -> None:
        """A cell's selector feedback, then its stragglers into its host
        cache with their statistical utility (0 when ``l2s`` is None)."""
        sim._apply_feedback(r, sched, l2s)
        for (row, lid, arr, dur), slot in zip(sched.new_stale, sched.slots):
            sim.stale_cache.append(_InFlight(lid, r, arr, dur, slot,
                                             sim._stat_util(row, l2s)))

    def _fetch_feedback(self, work, l2) -> None:
        """The round's one device-to-host copy of the l2 stats, then each
        cell's feedback in batch order."""
        l2_host = None if l2 is None else l2.cpu().numpy()
        for i in work.order:
            sim, plan = self.sims[i], work.plans[i]
            l2s = np.zeros(plan.k, np.float32)      # by plan row
            surv = sim.survivors(plan)[0]
            if l2_host is not None and len(surv):
                l2s[surv] = l2_host[work.first[i]:work.first[i] + len(surv)]
            self._feedback(sim, work.r, work.scheds[i], l2s)

    def _eval(self, work) -> None:
        """The batched evaluation of the round's cells, their records'
        fill, and the accuracy-target early stops."""
        acc, loss = self.data.evaluate(self.sims, self.params, work.order)
        for k, i in enumerate(work.order):
            sim = self.sims[i]
            sim._fill_round_eval(work.recs[i], acc[k], loss[k],
                                 progress=self.progress)
            if sim._target_reached():
                sim.acct.stopped_early = True
                self.done[i] = True

    def _device_round(self, r: int, work: RoundWork):
        """The round's training and server step on the device; returns the
        survivors' l2 stats (device, packed in batch order; None when no
        learner survived)."""
        sims, order = self.sims, work.order
        cfg0 = sims[0].cfg
        deltas, l2, work.first = train_packed(sims, self.data, self.params,
                                              work.plans, order)
        # the stragglers into their cache slots, then the operand's rows
        groups = [i for i in order if work.scheds[i].fresh_rows
                  or work.scheds[i].landing]
        pos = {i: sims[i].survivors(work.plans[i])[1] for i in order}
        stale_src, slots = [], []
        for i in order:
            sc = work.scheds[i]
            stale_src += [work.first[i] + pos[i][row]
                          for row, _l, _a, _d in sc.new_stale]
            slots += sc.slots
        sizes = [len(work.scheds[i].fresh_rows) + len(work.scheds[i].landing)
                 for i in groups]
        g, n = len(groups), max(sizes + [1])
        fdst, fsrc, sdst, ssrc = [], [], [], []
        meta = np.zeros((3, g, n), np.int64)     # fresh, valid, tau
        att = None if self.attack is None else np.zeros((g, n), np.int64)
        for k, i in enumerate(groups):
            sc, plan = work.scheds[i], work.plans[i]
            nf = len(sc.fresh_rows)
            fdst += range(k * n, k * n + nf)
            fsrc += [work.first[i] + pos[i][row] for row in sc.fresh_rows]
            sdst += range(k * n + nf, k * n + sizes[k])
            ssrc += [f.delta for f in sc.landing]
            meta[0, k, :nf] = 1
            meta[1, k, :sizes[k]] = 1
            meta[2, k, nf:sizes[k]] = sc.landing_taus
            if att is not None:
                att[k, :sizes[k]] = sims[i].attack_flags(r, agg_lids(plan, sc))
        # one host->device copy: every index the server step needs
        parts = [stale_src, slots, fdst, fsrc, sdst, ssrc, groups,
                 meta.ravel(), [] if att is None else att.ravel()]
        lens = [len(p) for p in parts]
        ints = torch.as_tensor(np.concatenate(parts).astype(np.int64),
                               device=self.device)
        (stale_src, slots, fdst, fsrc, sdst, ssrc, cells_t, meta_t,
         att_t) = torch.split(ints, lens)
        if lens[0]:
            self.cache.rows[slots] = deltas[stale_src]
        if not groups:
            return l2
        u = self.params.new_zeros((g * n, self.d_pad))
        if lens[2]:
            u[fdst] = deltas[fsrc]
        if lens[4]:
            u[sdst] = self.cache.rows[ssrc]
        u = u.view(g, n, self.d_pad)
        meta_t = meta_t.view(3, g, n)
        fresh, valid = meta_t[0].bool(), meta_t[1].bool()
        tau = meta_t[2].to(torch.int32)
        # the groups' rows of the (S, ...) state: a slice (no copy) when
        # they are every cell in order
        idx = slice(None) if groups == list(range(len(sims))) else cells_t
        rule = cfg0.scaling_rule
        if self.attack is not None or self.robust is not None:
            agg, counts = robust_sweep(
                u, fresh, tau, valid,
                None if att is None else att_t.view(g, n).bool(), sizes,
                attack=self.attack, robust=self.robust,
                betas=[sims[i].cfg.beta for i in groups],
                rule_ids=[RULE_ID[sims[i].cfg.scaling_rule] for i in groups],
                use_kernel=cfg0.use_agg_kernel,
                no_stale=[not work.scheds[i].landing for i in groups])
            self.robust_counts[idx] += counts
        elif cfg0.use_agg_kernel and not self.yogi:
            rows = self.params if isinstance(idx, slice) else self.params[idx]
            saa_ops.sweep_fused_staleness_apply(
                rows, u, fresh, tau, valid, self._scal[idx], rule=rule)
            if not isinstance(idx, slice):
                self.params[idx] = rows
            return l2
        elif cfg0.use_agg_kernel:
            agg, _ = saa_ops.sweep_fused_staleness_aggregate(
                u, fresh, tau, self._scal[idx, 0].contiguous(), valid,
                rule=rule)
        else:
            agg = torch.stack([self._plain_aggregate(
                sims[i].cfg, u[k, :sizes[k]], fresh[k, :sizes[k]],
                tau[k, :sizes[k]], valid[k, :sizes[k]],
                not work.scheds[i].landing) for k, i in enumerate(groups)])
        if self.yogi:
            st = {key: v[idx] for key, v in self.opt_state.items()}
            new, st = yogi_apply_flat(self.params[idx], agg, st)
            self.params[idx] = new
            for key, v in st.items():
                self.opt_state[key][idx] = v
        else:
            self.params[idx] += self._scal[idx, 1:2] * agg
        return l2

    @staticmethod
    def _plain_aggregate(cfg, u, fresh, tau, valid, no_stale: bool):
        """One group's Eq. 2 aggregate through ``core.aggregation``'s torch
        path, on the group's own rows (a serial run's call)."""
        if no_stale:
            return no_stale_aggregate(u, fresh, valid)
        agg, _ = weights_and_aggregate_by_id(
            u, fresh, tau, valid, cfg.beta, RULE_ID[cfg.scaling_rule])
        return agg

    def finalize(self) -> list:
        """Write each cell's device model (and YoGi state, robust counters)
        back to its Simulator and finalize it; returns the Accountings."""
        accts = []
        for i, sim in enumerate(self.sims):
            sim.flat_params = self.params[i, :self.d].clone()
            if self.yogi:
                sim.flat_opt_state = {
                    "m": self.opt_state["m"][i, :self.d].clone(),
                    "v": self.opt_state["v"][i, :self.d].clone(),
                    "t": self.opt_state["t"][i].clone()}
            sim.robust_counts = self.robust_counts[i].clone()
            accts.append(sim._finalize())
        return accts
