"""Event-driven FL round engine (paper §5.1); port of ``repro.sim.engine``.

Supports the paper's settings: OC (over-commit selection by 30%, wait for
the first N_t updates) and DL (fixed reporting deadline).  RELAY (IPS + APT
+ SAA with Eq. 2 weights) and random selection + FedAvg are expressible.
Simulated time is decoupled from wall-clock: device durations come from
the heterogeneity profiles, availability from the trace substrate.

Two substrates run a simulation: the fused device-resident pipeline
(``repro_torch.sim.pipeline``, ``fused_rounds=True``) and the per-stage
flat path below (``_run_loop``: train, collect, aggregate, apply, record),
which the fused pipeline is held against bit for bit.  Both serve FedAvg
and YoGi server steps, with or without the SAA kernels.  The host side —
the round stages below — is numpy with the reference's RNG draw order, so
for the same config, seed and initial weights every host decision (cohort,
arrival schedule, fresh/straggler split, stale landings, APT targets,
resource accounting) equals the reference's.  Configurations outside the
slice raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.aggregation import (fedavg_apply, flat_dim,
                                          flatten_update, make_flat_spec,
                                          stale_synchronous_aggregate_flat,
                                          unflatten_update, yogi_apply_flat,
                                          yogi_init_flat)
from repro_torch.core.apt import AdaptiveParticipantTarget
from repro_torch.core.availability import ForecasterBank
from repro_torch.learners import MODEL_TABLE, DataMeta, build_model
from repro_torch.selection import (SELECTOR_TABLE, LearnerView, build_selector,
                                   normalize_selector_params)
from repro_torch.sim import devices as dev
from repro_torch.sim import learner as ln
from repro_torch.sim import partition as part
from repro_torch.sim import traces as tr
from repro_torch.sim.metrics import Accounting, RoundRecord

HOUR = 3600.0


@dataclasses.dataclass
class SimConfig:
    """The reference's ``SimConfig``: same fields, same defaults."""
    benchmark: str = "speech"
    mapping: str = "uniform"          # uniform | fedscale | label_{balanced,uniform,zipf}
    n_learners: int = 200
    rounds: int = 200
    selector: str = "random"          # random | priority in this slice
    selector_params: tuple = ()
    server_opt: str = "fedavg"        # fedavg | yogi
    aggregator: str = "saa"
    trim_k: int = 1
    krum_f: int = 0
    multi_krum_m: Optional[int] = None
    attack: str = "none"
    attack_frac: float = 0.25
    attack_scale: float = 10.0
    attack_z: float = 1.5
    scaling_rule: str = "relay"       # equal | dynsgd | adasgd | relay
    beta: float = 0.35                # Eq. 2 averaging weight
    saa: bool = False                 # accept stale updates
    staleness_threshold: Optional[int] = None   # None = unbounded
    setting: str = "OC"               # OC | DL
    deadline: float = 100.0           # DL reporting deadline (seconds)
    n_target: int = 10
    overcommit: float = 1.3           # OC over-commit factor
    safa_target_ratio: float = 0.1
    apt: bool = False
    dynamic_availability: bool = True
    hardware_scenario: str = "HS1"
    local_steps: int = 5
    local_batch: int = 16
    local_lr: float = 0.05
    prox_mu: float = 0.0              # FedProx proximal term (0 = plain FedAvg)
    server_lr: float = 1.0
    model_mbits: float = 50.0         # update size on the wire
    eval_every: int = 10
    selection_window: float = 5.0
    seed: int = 0
    use_agg_kernel: bool = False      # SAA server step through the CUDA kernels
    fast_path: bool = True
    fused_rounds: bool = True
    target_accuracy: Optional[float] = None   # accuracy-target early stop
    stale_cache_capacity: int = 64    # initial device stale-cache slots (grows 2x)
    rounds_per_dispatch: int = 1
    shard_participants: int = 0
    guard: bool = False
    guard_clip: Optional[float] = None
    guard_reject_mult: Optional[float] = None
    quorum: int = 1
    telemetry: int = 0
    model: str = "mlp"
    model_params: tuple = ()

    def __post_init__(self):
        # older reference configs named the server optimizer `aggregator`
        if self.aggregator in ("fedavg", "yogi"):
            self.server_opt = self.aggregator
            self.aggregator = "saa"
        for unported, what, item in _UNPORTED:
            if unported(self):
                raise NotImplementedError(
                    f"{what} is not ported to repro_torch yet "
                    f"(ROADMAP.md queue 1 item {item})")
        self.selector_params = normalize_selector_params(
            self.selector, self.selector_params)
        self.model_params = MODEL_TABLE.normalize_params(self.model,
                                                         self.model_params)


# (predicate on a config, what it asks for, the ROADMAP queue 1 item that
# ports it)
_UNPORTED = (
    (lambda c: not c.fast_path, "the legacy pytree engine (fast_path=False)", 15),
    (lambda c: c.aggregator != "saa", "robust aggregators", 11),
    (lambda c: c.attack != "none", "coordinated attacks", 10),
    (lambda c: c.guard, "guarded aggregation / quorum", 10),
    (lambda c: c.telemetry != 0, "telemetry", 12),
    (lambda c: c.rounds_per_dispatch != 1, "K-round chunks (rounds_per_dispatch > 1)", 8),
    (lambda c: bool(c.shard_participants), "participant sharding", 14),
    (lambda c: c.benchmark in part.TOKEN_BENCHMARKS, "token benchmarks", 2),
    (lambda c: c.model not in MODEL_TABLE, "learner models other than mlp", 13),
    (lambda c: c.selector not in SELECTOR_TABLE,
     "selectors other than random and priority", 6),
)


def substrate_key(cfg: SimConfig) -> tuple:
    """The config fields that determine the seed-built world state."""
    return (cfg.benchmark, cfg.mapping, cfg.n_learners, cfg.seed,
            cfg.dynamic_availability, cfg.model,
            tuple(cfg.model_params or ()))


@dataclasses.dataclass
class Substrate:
    """Everything the config seed determines before the first round.

    Built with the reference's exact numpy draw order (dataset, partition,
    profiles, traces); the generator state is then captured so a Simulator
    starting from this Substrate consumes the stream the reference does.
    The initial model comes from a ``torch.Generator`` seeded with the
    config seed, or is injected as ``flat_params0`` (the reference draws
    it from ``jax.random``, which torch cannot reproduce).
    """
    key: tuple
    data: part.FederatedDataset
    base_profiles: list
    traces: list
    trace_bank: tr.TraceBank
    rng_state: dict
    params0: dict                      # initial model (CPU fp32 tensors)
    flat_params0: np.ndarray           # same model, flat fp32 (D,)
    flat_spec: object
    meta: object = None
    model_fns: object = None
    _warmed: Optional[tuple] = None

    @staticmethod
    def build(cfg: SimConfig, flat_params0: Optional[np.ndarray] = None
              ) -> "Substrate":
        rng = np.random.default_rng(cfg.seed)
        x_tr, y_tr, x_te, y_te = part.make_dataset(cfg.benchmark, rng)
        shards = part.partition(y_tr, cfg.n_learners, cfg.mapping, rng)
        data = part.FederatedDataset(cfg.benchmark, x_tr, y_tr, x_te, y_te,
                                     shards)
        meta = DataMeta(kind="classifier", feature_dim=int(x_tr.shape[1]),
                        n_classes=data.n_classes)
        base_profiles = dev.sample_profiles(cfg.n_learners, rng)   # HS1 base
        traces = tr.make_traces(cfg.n_learners, rng,
                                dynamic=cfg.dynamic_availability)
        model_fns = build_model(cfg.model, tuple(cfg.model_params), meta)
        params0 = model_fns.init(torch.Generator().manual_seed(cfg.seed))
        flat_spec = make_flat_spec(params0)
        if flat_params0 is None:
            flat0 = flatten_update(params0)[0].numpy()
        else:
            flat0 = np.asarray(flat_params0, np.float32)
            if flat0.shape != (flat_dim(flat_spec),):
                raise ValueError(f"flat_params0 has shape {flat0.shape}, the "
                                 f"model needs ({flat_dim(flat_spec)},)")
            params0 = {k: v.clone() for k, v in unflatten_update(
                torch.from_numpy(flat0), flat_spec).items()}
        return Substrate(key=substrate_key(cfg), data=data,
                         base_profiles=base_profiles, traces=traces,
                         trace_bank=tr.TraceBank(traces),
                         rng_state=rng.bit_generator.state,
                         params0=params0, flat_params0=flat0,
                         flat_spec=flat_spec, meta=meta, model_fns=model_fns)

    def warmed_fbank(self) -> tuple:
        """Pre-deployment forecaster history (paper App. A step 2):
        (counts, avail_counts, recent), computed once per substrate."""
        if self._warmed is None:
            fb = ForecasterBank(len(self.traces))
            for tt in np.arange(0, 3 * 24 * HOUR, 1800.0):
                fb.observe_all(tt, self.trace_bank.available_all(tt))
            self._warmed = (fb.counts, fb.avail_counts, fb.recent)
        return self._warmed


@dataclasses.dataclass
class _InFlight:
    learner_id: int
    origin_round: int
    arrival: float
    duration: float
    delta: object                     # fused: device stale-cache slot id;
                                      # flat: the cloned (D,) device row
    stat_util: float


@dataclasses.dataclass
class RoundPlan:
    """Host output of ``_begin_round``: the cohort and its sample indices
    (the pipeline gathers the batches on the device)."""
    t_now: float
    chosen: list
    n_t: int
    k: int                            # cohort size
    durs: np.ndarray                  # (k,)
    drop_at: np.ndarray               # (k,) mid-round dropout offsets (inf = none)
    bidx: np.ndarray                  # (k, steps*batch) sample indices


@dataclasses.dataclass
class RoundSchedule:
    """Host round outcome, decided before the device work: it depends only
    on durations, dropouts and the stale-cache metadata, never on update
    values.  ``landing``/``expired`` entries have left
    ``Simulator.stale_cache``; the pipeline frees their slots."""
    t_end: float
    fresh_rows: list                  # plan-row indices aggregated fresh, arrival order
    new_stale: list                   # (row, lid, arrival, duration) entering the cache
    landing: list                     # _InFlight entries landing this round, cache order
    landing_taus: list                # their staleness (rounds)
    expired: list                     # over-threshold entries (removed, marked wasted)
    feedback: list                    # (lid, row, duration) selector feedback, arrival order
    slots: list = dataclasses.field(default_factory=list)  # set by the pipeline


def resolve_device(device) -> torch.device:
    """The GPU unless the caller asks for another device; with no GPU and
    no explicit request this raises instead of running on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch path on the CPU")
    return torch.device("cuda")


class Simulator:
    def __init__(self, cfg: SimConfig, substrate: Optional[Substrate] = None,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if substrate is None:
            substrate = Substrate.build(cfg)
        elif substrate.key != substrate_key(cfg):
            raise ValueError("substrate built for a different config family")
        self.substrate = substrate
        self.rng = np.random.default_rng(cfg.seed)
        self.rng.bit_generator.state = substrate.rng_state
        self.data = substrate.data
        self.profiles = dev.apply_hardware_scenario(substrate.base_profiles,
                                                    cfg.hardware_scenario)
        self.traces = substrate.traces
        self.durations = np.array([
            p.round_duration(cfg.local_steps * cfg.local_batch, 1, cfg.model_mbits)
            for p in self.profiles])
        self.trace_bank = substrate.trace_bank
        self.fbank = ForecasterBank(cfg.n_learners)
        self._warmup_forecasters()
        self.selector = build_selector(cfg, substrate=substrate,
                                       durations=self.durations)
        self.apt = AdaptiveParticipantTarget(n0=cfg.n_target) if cfg.apt else None
        self.params = substrate.params0
        self._flat_spec = substrate.flat_spec
        self._model_fns = substrate.model_fns
        if self.device.type == "cuda":
            ln.fp32_matmuls()
        self.flat_params = torch.as_tensor(substrate.flat_params0,
                                           device=self.device).clone()
        self.flat_opt_state = (yogi_init_flat(len(substrate.flat_params0),
                                              device=self.device)
                               if cfg.server_opt == "yogi" else None)
        data = self.data      # device copies: batches are gathered there
        self.x_train = torch.as_tensor(data.x_train, device=self.device)
        self.y_train = torch.as_tensor(data.y_train, dtype=torch.int64,
                                       device=self.device)
        self.x_test = torch.as_tensor(data.x_test, device=self.device)
        self.y_test = torch.as_tensor(data.y_test, dtype=torch.int64,
                                      device=self.device)
        self.acct = Accounting()
        self.stale_cache: list[_InFlight] = []
        self.busy_until = np.zeros(cfg.n_learners)  # device busy training/uploading
        self.mu = cfg.deadline  # initial round-duration estimate
        self._t_now = 0.0

    def _warmup_forecasters(self):
        """Learners have pre-deployment local history (paper App. A step 2)."""
        counts, avail_counts, recent = self.substrate.warmed_fbank()
        self.fbank.counts = counts.copy()
        self.fbank.avail_counts = avail_counts.copy()
        self.fbank.recent = recent.copy()

    def _available_now(self, t_now: float):
        """Idle + available learner ids (ascending), forecasters updated."""
        mask = self.trace_bank.available_all(t_now) & (self.busy_until <= t_now)
        available = np.nonzero(mask)[0]
        if len(available):                  # devices log their own state
            self.fbank.observe_batch(available, t_now, 1.0)
        return available

    def _views(self, t_now: float, available_ids):
        t0, t1 = t_now + self.mu, t_now + 2 * self.mu
        probs = self.fbank.predict_window_batch(available_ids, t0, t1)
        return [LearnerView(lid, availability_prob=float(p),
                            est_duration=self.durations[lid])
                for lid, p in zip(available_ids, probs)]

    # ------------------------------------------------------------------
    # Round stages (RoundPipeline chains them)
    # ------------------------------------------------------------------

    def eval_due(self, r: int) -> bool:
        return (r + 1) % self.cfg.eval_every == 0 or r == self.cfg.rounds - 1

    def _begin_round(self, r: int) -> Optional[RoundPlan]:
        """Advance time, census availability, pick the cohort, sample its
        local batch indices.  None when the round is skipped."""
        cfg = self.cfg
        self._t_now += cfg.selection_window
        t_now = self._t_now
        available = self._available_now(t_now)
        if not len(available):
            self._t_now += 60.0
            return None

        n_t = cfg.n_target
        if self.apt is not None:
            rts = [f.arrival - t_now for f in self.stale_cache
                   if f.arrival > t_now]
            n_t = self.apt.target(rts)
        n_sel = (int(np.ceil(n_t * cfg.overcommit))
                 if cfg.setting == "OC" else n_t)
        if self.selector.needs_views:
            views = self._views(t_now, available)
            chosen = self.selector.select(r, views, n_sel, self.rng)
        else:
            chosen = self.selector.select_ids(r, available, n_sel, self.rng)
        if not chosen:
            self._t_now += 60.0
            return None
        return self._build_plan(chosen, t_now, n_t)

    def _build_plan(self, chosen, t_now, n_t) -> RoundPlan:
        cfg = self.cfg
        takes = [ln.sample_batch_indices(self.data.shards[lid], cfg.local_steps,
                                         cfg.local_batch, self.rng)
                 for lid in chosen]
        durs = self.durations[np.asarray(chosen)]
        nus = self.trace_bank.next_unavailable_after_batch(chosen, t_now)
        rel = nus - t_now
        drop_at = np.where(rel < durs, rel, np.inf)
        return RoundPlan(t_now, list(chosen), n_t, len(chosen), durs, drop_at,
                         np.asarray(takes, np.int64))

    def _schedule_round(self, r: int, plan: RoundPlan) -> RoundSchedule:
        """Arrival schedule, round end time, fresh/straggler split, stale
        landings, resource accounting — decided before training.  The
        accounting mutations happen in the reference's order (float
        accumulation order is part of the parity contract)."""
        cfg = self.cfg
        t_now, chosen, durs, drop_at = plan.t_now, plan.chosen, plan.durs, plan.drop_at
        n_t = plan.n_t

        arrivals = []   # (arrival_time, idx into chosen) for non-dropouts
        for i, lid in enumerate(chosen):
            if np.isfinite(drop_at[i]):
                # device went away mid-round: partial work, always wasted
                self.acct.charge(float(drop_at[i]), wasted=True)
                self.busy_until[lid] = t_now + float(drop_at[i])
            else:
                arrivals.append((t_now + durs[i], i))
                self.acct.charge(float(durs[i]), wasted=False)
                self.busy_until[lid] = t_now + float(durs[i])
        arrivals.sort()

        if cfg.setting == "OC":
            t_end = (arrivals[n_t - 1][0] if len(arrivals) >= n_t
                     else (arrivals[-1][0] if arrivals else t_now + cfg.deadline))
        else:  # DL
            t_end = t_now + cfg.deadline

        fresh_rows, new_stale, feedback = [], [], []
        for (arr, i) in arrivals:
            lid = chosen[i]
            feedback.append((lid, i, durs[i]))
            if arr <= t_end and (cfg.setting == "DL" or len(fresh_rows) < n_t):
                fresh_rows.append(i)
                self.acct.unique.add(lid)
            elif cfg.saa:
                new_stale.append((i, lid, arr, durs[i]))
            else:
                # already charged as used at dispatch; never aggregated
                self.acct.mark_wasted(float(durs[i]))

        landing, landing_taus, expired = [], [], []
        still_waiting = []
        for f in self.stale_cache:
            if f.arrival <= t_end:
                tau = r - f.origin_round
                if (cfg.staleness_threshold is None
                        or tau <= cfg.staleness_threshold):
                    landing.append(f)
                    landing_taus.append(tau)
                    self.acct.unique.add(f.learner_id)
                else:
                    expired.append(f)
                    self.acct.mark_wasted(f.duration)
            else:
                still_waiting.append(f)
        self.stale_cache = still_waiting
        return RoundSchedule(t_end, fresh_rows, new_stale, landing,
                             landing_taus, expired, feedback)

    def _apply_feedback(self, r: int, sched: RoundSchedule, l2s) -> None:
        """Selector feedback for every arrival, in arrival order; ``l2s``
        is None when no stats were fetched (stat_util reported as 0)."""
        for (lid, i, dur) in sched.feedback:
            self.selector.update_feedback(lid, stat_util=self._stat_util(i, l2s),
                                          duration=dur, round_idx=r)

    def _stat_util(self, row: int, l2s) -> float:
        return (float(self.cfg.local_steps * self.cfg.local_batch * l2s[row])
                if l2s is not None else 0.0)

    def train_cohort(self, flat_row: torch.Tensor, bidx: torch.Tensor,
                     out_dim=None):
        """Local training of a cohort from ``flat_row`` (read up to D) in
        one batched call: bidx (m, steps*batch) device int64 sample
        indices.  Both substrates train through here, on the same rows, so
        their deltas are bit-identical.  Returns (deltas (m, out_dim or D),
        losses (m,), l2 stats (m,))."""
        cfg = self.cfg
        m = bidx.shape[0]
        bx = self.x_train[bidx].view(m, cfg.local_steps, cfg.local_batch, -1)
        by = self.y_train[bidx].view(m, cfg.local_steps, cfg.local_batch)
        return ln.local_train_cohort(flat_row, bx, by, spec=self._flat_spec,
                                     lr=cfg.local_lr, prox_mu=cfg.prox_mu,
                                     loss=self._model_fns.loss,
                                     out_dim=out_dim)

    @staticmethod
    def survivors(plan: RoundPlan):
        """(plan rows that do not drop out, plan row -> trained row or -1).
        Only these rows are trained: a dropout's delta is never used."""
        surv = np.nonzero(~np.isfinite(plan.drop_at))[0]
        pos = np.full(plan.k, -1, np.int64)
        pos[surv] = np.arange(len(surv))
        return surv, pos

    def _train(self, plan: RoundPlan):
        """Device stage of the flat path: the surviving learners' local
        training.  Returns (deltas (m, D) or None, plan row -> delta row,
        l2 stats (k,) host fp32 by plan row).  The reference also trains
        the rows that drop out (bucket-padded); their deltas and stats are
        discarded, so the port skips them on both substrates (their stats
        stay 0 and are never read)."""
        surv, pos = self.survivors(plan)
        l2s = np.zeros(plan.k, np.float32)
        if not len(surv):
            return None, pos, l2s
        bidx = torch.as_tensor(plan.bidx[surv], device=self.device)
        deltas, _, l2 = self.train_cohort(self.flat_params, bidx)
        l2s[surv] = l2.cpu().numpy()
        return deltas, pos, l2s

    def _collect_updates(self, r: int, plan: RoundPlan, deltas, pos, l2s):
        """Schedule the round, apply selector feedback (stat utility from
        ``l2s``, by plan row), then take the scheduled rows out of the
        round's deltas.  New stragglers enter ``stale_cache`` with a cloned
        device row.  Returns (t_end, fresh_updates, stale_updates,
        stale_taus)."""
        sched = self._schedule_round(r, plan)
        self._apply_feedback(r, sched, l2s)
        fresh_updates = [deltas[pos[i]] for i in sched.fresh_rows]
        for (i, lid, arr, dur) in sched.new_stale:
            self.stale_cache.append(_InFlight(lid, r, arr, dur,
                                              deltas[pos[i]].clone(),
                                              self._stat_util(i, l2s)))
        stale_updates = [f.delta for f in sched.landing]
        return sched.t_end, fresh_updates, stale_updates, sched.landing_taus

    def _aggregate(self, fresh_updates, stale_updates, stale_taus):
        """The aggregated delta (D,) of the round's rows, fresh first."""
        cfg = self.cfg
        nf, ns = len(fresh_updates), len(stale_updates)
        stacked = torch.stack(fresh_updates + stale_updates)
        fresh = torch.arange(nf + ns, device=self.device) < nf
        tau = torch.as_tensor(np.asarray([0] * nf + list(stale_taus),
                                         np.int32), device=self.device)
        agg, _ = stale_synchronous_aggregate_flat(
            stacked, fresh, tau, rule=cfg.scaling_rule, beta=cfg.beta,
            use_kernel=cfg.use_agg_kernel)
        return agg

    def _apply_update(self, agg) -> None:
        """Server optimizer step on the aggregated delta."""
        if self.cfg.server_opt == "yogi":
            self.flat_params, self.flat_opt_state = yogi_apply_flat(
                self.flat_params, agg, self.flat_opt_state)
        else:
            self.flat_params = fedavg_apply(self.flat_params, agg,
                                            self.cfg.server_lr)

    def _evaluate(self):
        params = unflatten_update(self.flat_params, self._flat_spec)
        return self._model_fns.evaluate(params, self.x_test, self.y_test)

    def _advance_round_state(self, r: int, t_start: float, t_end: float,
                             n_selected: int, n_fresh: int, n_stale: int):
        """Round-duration estimate, the appended RoundRecord (accuracy NaN
        until an evaluation fills it), and the clock."""
        duration = t_end - t_start
        self.mu = (self.apt.update_round_duration(duration)
                   if self.apt is not None else
                   0.75 * duration + 0.25 * self.mu)
        rec = RoundRecord(r, t_end, n_selected, n_fresh, n_stale,
                          self.acct.resource_used, self.acct.resource_wasted,
                          len(self.acct.unique))
        self.acct.records.append(rec)
        self._t_now = t_end
        return rec

    def _fill_round_eval(self, rec, acc, loss, progress: bool = False):
        """Write an evaluation's metrics into an already-appended record."""
        rec.accuracy, rec.loss = float(acc), float(loss)
        if progress:
            print(f"  round {rec.round_idx:4d} t={rec.sim_time/60:7.1f}min "
                  f"acc={rec.accuracy:.3f} "
                  f"used={self.acct.resource_used/60:.0f}min "
                  f"wasted={100*self.acct.resource_wasted/max(self.acct.resource_used,1e-9):.0f}%")

    def _record_round(self, r: int, t_start: float, t_end: float,
                      n_selected: int, n_fresh: int, n_stale: int,
                      acc_loss=None, progress: bool = False):
        """Bookkeeping tail of a round plus the evaluation when due
        (``acc_loss`` supplies precomputed metrics)."""
        rec = self._advance_round_state(r, t_start, t_end, n_selected,
                                        n_fresh, n_stale)
        if self.eval_due(r):
            acc, loss = self._evaluate() if acc_loss is None else acc_loss
            self._fill_round_eval(rec, acc, loss, progress=progress)
        return rec

    def _target_reached(self) -> bool:
        """True once the latest recorded round's evaluation reached
        ``target_accuracy`` (only eval rounds carry an accuracy)."""
        target = self.cfg.target_accuracy
        if target is None or not self.acct.records:
            return False
        acc = self.acct.records[-1].accuracy
        return acc == acc and acc >= target

    def _finalize(self) -> Accounting:
        # updates still in flight at the end of training are wasted work
        for f in self.stale_cache:
            self.acct.mark_wasted(f.duration)
        self.params = unflatten_update(self.flat_params, self._flat_spec)
        return self.acct

    def run(self, progress: bool = False) -> Accounting:
        if self.cfg.fused_rounds:
            from repro_torch.sim.pipeline import RoundPipeline
            return RoundPipeline(self, progress=progress).run()
        self._t_now = 0.0
        return self._run_loop(progress)

    def _run_loop(self, progress: bool) -> Accounting:
        """The per-stage flat round loop."""
        for r in range(self.cfg.rounds):
            if self._flat_round(r, progress) is not None and \
                    self._target_reached():
                self.acct.stopped_early = True
                break
        return self._finalize()

    def _flat_round(self, r: int, progress: bool):
        """One round of the flat path; returns its RoundRecord, or None
        when the round was skipped.  The profiler spans carry the fused
        pipeline's names: host stages, device work, bookkeeping + eval."""
        with record_function("round.schedule"):
            plan = self._begin_round(r)
        if plan is None:
            return None
        with record_function("round.device"):
            deltas, pos, l2s = self._train(plan)
        with record_function("round.schedule"):
            t_end, fresh, stale, taus = self._collect_updates(r, plan, deltas,
                                                              pos, l2s)
        if fresh or stale:
            with record_function("round.device"):
                self._apply_update(self._aggregate(fresh, stale, taus))
        with record_function("round.eval"):
            return self._record_round(r, plan.t_now, t_end, len(plan.chosen),
                                      len(fresh), len(stale),
                                      progress=progress)
