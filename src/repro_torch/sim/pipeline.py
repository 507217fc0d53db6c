"""Device-resident round pipeline for one simulation (port of the S = 1,
K = 1, unsharded case of ``repro.sim.pipeline``).

Every decision of a round (cohort, arrival order, round end, fresh vs
straggler split, stale landings) depends only on durations and dropouts,
never on update values, so the host state machine runs first and the
round's device work is index plumbing around the training and the server
step:

  1. the cohort's local batches are gathered on the device from a device
     copy of the dataset (the host sends one packed int64 index tensor);
  2. the surviving learners train in one batched call;
  3. straggler rows are scattered into the device stale cache *before* the
     landing rows are gathered out of it — the slots freed by a round's
     landings are quarantined for one round, so this round's scatter slots
     never collide with its gather slots;
  4. SAA weights and the server step update the model in place: through
     the CUDA kernels (``use_agg_kernel=True``), else through
     ``core.aggregation``'s plain torch path.  FedAvg applies the aggregate
     inside the kernel (``sweep_fused_staleness_apply``); YoGi takes the
     aggregate (``sweep_fused_staleness_aggregate``) and steps its own
     state.  An attacked or robust round instead rewrites the attacker
     rows and runs the robust strategy (``robust.aggregators.robust_cell``,
     the flat path's function) before FedAvg or YoGi; there
     ``use_agg_kernel`` routes only the coordinate-wise trim through its
     kernel (``kernels.trimmed_agg``).

A ``needs_feedback`` selector (oort, ucb, contribution) reads each
arrival's statistical utility, which comes from the training's per-row l2
loss stats: for one the pipeline copies the survivors' stats to the host
once, after the device round (span ``round.feedback``), then applies the
selector feedback and caches the round's stragglers with their utility,
as the reference's fused pipeline does.  Any other selector gets its
feedback (utility 0) before the device round, and nothing is fetched.

The model row, the cache rows and the YoGi state are kept ``d_pad`` wide
under the SAA kernels (D rounded up to their 2048-column block); the pad
columns stay exact zeros (zero in YoGi's m and v too) because the deltas
are zero-padded where they are made and every server operation is
columnwise.  Attacked and robust runs keep the true D, as the reference
does: their row norms, means and distances reduce over the last axis, and
reducing over the pad would change their bits.
The reference pads participant counts to shape buckets to bound XLA
recompiles; eager PyTorch runs the exact shapes (padding never changes a
result in the reference either).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.aggregation import (flat_dim, no_stale_aggregate,
                                          unflatten_update,
                                          weights_and_aggregate_by_id,
                                          yogi_apply_flat, yogi_init_flat)
from repro_torch.core.stale_cache import DeviceStaleCache
from repro_torch.core.staleness import RULE_ID
from repro_torch.kernels.staleness_agg import ops as saa_ops
from repro_torch.robust.aggregators import robust_cell
from repro_torch.sim.engine import _InFlight, agg_lids


def _quarantine_frees(sched) -> list:
    """Cache slots released by a round's landings and expiries; the
    pipeline frees them one round later."""
    return [f.delta for f in sched.landing + sched.expired]


class RoundPipeline:
    def __init__(self, sim, progress: bool = False):
        cfg = sim.cfg
        self.sim = sim
        self.progress = progress
        self.device = dev = sim.device
        self.spec = sim._flat_spec
        self.d = flat_dim(self.spec)
        self.robust = sim._attack is not None or sim._robust is not None
        self.d_pad = (self.d + (-self.d) % saa_ops.D_BLK
                      if cfg.use_agg_kernel and not self.robust else self.d)
        # (1, d_pad): the kernel's (S, D) params operand with S = 1
        self.params = torch.zeros((1, self.d_pad), dtype=torch.float32,
                                  device=dev)
        self.params[0, :self.d] = sim.flat_params
        self.cache = DeviceStaleCache(self.d_pad,
                                      capacity=cfg.stale_cache_capacity,
                                      device=dev)
        self.yogi = cfg.server_opt == "yogi"
        self.opt_state = (yogi_init_flat(self.d, device=dev, width=self.d_pad)
                          if self.yogi else None)
        self._scal = torch.tensor([[cfg.beta, cfg.server_lr]],
                                  dtype=torch.float32, device=dev)
        self._beta = self._scal[:, 0].contiguous()
        self._pending_free = []   # freed slots quarantined for one round
        self.fetch_l2s = sim._sel_spec.needs_feedback

    def run(self):
        """Drive every round, then finalize; returns the Accounting."""
        sim = self.sim
        sim._t_now = 0.0
        for r in range(sim.cfg.rounds):
            rec = self.step(r)
            if rec is not None and sim._target_reached():
                sim.acct.stopped_early = True
                break
        return self.finalize()

    def step(self, r: int):
        """One round: the host state machine, the device work, and the
        evaluation when due.  Returns the RoundRecord, or None when the
        round was skipped (nobody available or selected)."""
        sim = self.sim
        # torch.profiler spans for the host stages, the device work and the
        # eval (a few microseconds each; chip_smoke.py reads them)
        with record_function("round.schedule"):
            plan = sim._begin_round(r)
            if plan is None:
                return None
            sched = sim._schedule_round(r, plan)
            if self._pending_free:
                self.cache.free(self._pending_free)
            self._pending_free = _quarantine_frees(sched)
            if sched.new_stale:
                sched.slots = self.cache.alloc(len(sched.new_stale))
            if not self.fetch_l2s:
                self._feedback(r, sched, None)
            rec = sim._advance_round_state(r, plan.t_now, sched.t_end,
                                           len(plan.chosen),
                                           len(sched.fresh_rows),
                                           len(sched.landing))
        with record_function("round.device"):
            l2 = self._device_round(r, plan, sched)
        if self.fetch_l2s:
            with record_function("round.feedback"):
                l2s = np.zeros(plan.k, np.float32)      # by plan row
                if l2 is not None:
                    l2s[sim.survivors(plan)[0]] = l2.cpu().numpy()
                self._feedback(r, sched, l2s)
        if sim.eval_due(r):
            with record_function("round.eval"):
                acc, loss = sim._model_fns.evaluate(
                    unflatten_update(self.params[0], self.spec), sim.x_test,
                    sim.y_test)
                sim._fill_round_eval(rec, acc, loss, progress=self.progress)
        return rec

    def _feedback(self, r, sched, l2s) -> None:
        """The round's selector feedback, then its stragglers into the
        host cache with their statistical utility (0 when ``l2s`` is
        None)."""
        sim = self.sim
        sim._apply_feedback(r, sched, l2s)
        for (row, lid, arr, dur), slot in zip(sched.new_stale, sched.slots):
            sim.stale_cache.append(_InFlight(lid, r, arr, dur, slot,
                                             sim._stat_util(row, l2s)))

    def _device_round(self, r, plan, sched):
        """The round's training and server step on the device; returns the
        survivors' l2 stats (a device tensor), or None when no learner
        survived."""
        sim = self.sim
        cfg = sim.cfg
        surv, pos = sim.survivors(plan)
        nf, ns = len(sched.fresh_rows), len(sched.landing)
        # one host->device copy per round: every index the round needs,
        # the aggregation rows' staleness (fresh rows first) and, under an
        # attack, their attacker flags
        att = sim.attack_flags(r, agg_lids(plan, sched))
        parts = [plan.bidx[surv].ravel(),
                 pos[[row for row, _l, _a, _d in sched.new_stale]],
                 sched.slots, pos[sched.fresh_rows],
                 [f.delta for f in sched.landing],
                 [0] * nf + sched.landing_taus,
                 [] if att is None else att]
        sizes = [len(p) for p in parts]
        ints = torch.as_tensor(np.concatenate(parts).astype(np.int64),
                               device=self.device)
        bidx, stale_rows, slots, fresh_pos, land_slots, taus, att_t = \
            torch.split(ints, sizes)

        l2 = None
        if len(surv):
            deltas, _, l2 = sim.train_cohort(
                self.params[0], bidx.view(len(surv), -1), out_dim=self.d_pad)
            if sched.new_stale:
                self.cache.rows[slots] = deltas[stale_rows]
        if nf + ns == 0:
            return l2
        u = torch.cat(([deltas[fresh_pos]] if nf else [])
                      + ([self.cache.rows[land_slots]] if ns else []))
        fresh = torch.arange(nf + ns, device=self.device) < nf
        tau = taus.to(torch.int32)
        valid = torch.ones_like(fresh)
        if self.robust:
            agg, counts = robust_cell(
                u, fresh, tau, valid, att_t.bool(), attack=sim._attack,
                robust=sim._robust, beta=cfg.beta,
                rule_id=RULE_ID[cfg.scaling_rule],
                use_kernel=cfg.use_agg_kernel, no_stale=ns == 0)
            sim.robust_counts += counts
        elif cfg.use_agg_kernel and not self.yogi:
            saa_ops.sweep_fused_staleness_apply(
                self.params, u[None], fresh[None], tau[None], valid[None],
                self._scal, rule=cfg.scaling_rule)
            return l2
        elif cfg.use_agg_kernel:
            agg, _ = saa_ops.sweep_fused_staleness_aggregate(
                u[None], fresh[None], tau[None], self._beta, valid[None],
                rule=cfg.scaling_rule)
            agg = agg[0]
        elif ns == 0:
            agg = no_stale_aggregate(u, fresh, valid)
        else:
            agg, _ = weights_and_aggregate_by_id(
                u, fresh, tau, valid, cfg.beta, RULE_ID[cfg.scaling_rule])
        if self.yogi:
            new, self.opt_state = yogi_apply_flat(self.params[0], agg,
                                                  self.opt_state)
            self.params[0] = new
        else:
            self.params[0] += cfg.server_lr * agg
        return l2

    def finalize(self):
        """Write the device model back to the Simulator and finalize it."""
        sim = self.sim
        sim.flat_params = self.params[0, :self.d].clone()
        if self.yogi:
            sim.flat_opt_state = {k: v[:self.d].clone() if v.dim() else v
                                  for k, v in self.opt_state.items()}
        return sim._finalize()
