"""Event-driven FL round engine (paper §5.1); port of ``repro.sim.engine``.

Supports the paper's settings: OC (over-commit selection by 30%, wait for
the first N_t updates) and DL (fixed reporting deadline).  RELAY (IPS + APT
+ SAA with Eq. 2 weights), random selection + FedAvg, and the reference's
other selectors (``repro_torch.selection``: oort, safa, flips, ucb,
contribution) are expressible; SAFA's round (every available learner
trains, the round ends at ``safa_target_ratio`` of its arrivals, capped by
the deadline) is the scheduler's ``select_all`` branch.
Simulated time is decoupled from wall-clock: device durations come from
the heterogeneity profiles, availability from the trace substrate.

Two substrates run a simulation: the fused device-resident pipeline
(``repro_torch.sim.pipeline``, ``fused_rounds=True``) and the per-stage
flat path below (``_run_loop``: train, collect, aggregate, apply, record),
which the fused pipeline is held against bit for bit.  Both serve FedAvg
and YoGi server steps, with or without the SAA kernels, and the robust
aggregators (``repro_torch.robust``) under coordinated attacks
(``repro_torch.faults``); both run a ``FaultPlan``'s update corruption,
post-training drops, replays and crash, the guard (``SimConfig.guard``:
rows screened before they are weighted, the apply skipped below
``quorum`` survivors) and crash-safe snapshots at round boundaries
(``run(checkpoint_path=, checkpoint_every=)``, resumed by
``repro_torch.checkpoint.resume_run``).  The host side —
the round stages below — is numpy with the reference's RNG draw order, so
for the same config, seed and initial weights every host decision (cohort,
arrival schedule, fresh/straggler split, stale landings, APT targets,
resource accounting) equals the reference's.  ``shard_participants``
runs the fused pipeline over a round mesh of the default process group's
ranks (``repro_torch.sim.participant_sharding``; one rank without a
group).  Configurations outside the slice raise ``NotImplementedError``
naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.aggregation import (bucket_block, fedavg_apply,
                                          flat_dim, flatten_update,
                                          guarded_aggregate_flat,
                                          make_flat_spec,
                                          stale_synchronous_aggregate_flat,
                                          unflatten_update, yogi_apply_flat,
                                          yogi_init_flat)
from repro_torch.core.apt import AdaptiveParticipantTarget
from repro_torch.core.availability import ForecasterBank
from repro_torch.device import resolve_device  # noqa: F401  (re-exported)
from repro_torch.faults import (ATTACK_KINDS, AttackSpec, FaultPlan,
                                attack_key)
from repro_torch.learners import MODEL_TABLE, DataMeta, build_model
from repro_torch.robust import ROBUST_AGGREGATORS, robust_key
from repro_torch.robust.aggregators import robust_host_aggregate
from repro_torch.selection import (SELECTOR_TABLE, LearnerView, build_selector,
                                   normalize_selector_params)
from repro_torch.sim import devices as dev
from repro_torch.sim import learner as ln
from repro_torch.sim import partition as part
from repro_torch.sim import traces as tr
from repro_torch.sim.metrics import Accounting, RoundRecord
from repro_torch.telemetry import TelemetrySession

HOUR = 3600.0


@dataclasses.dataclass
class SimConfig:
    """The reference's ``SimConfig``: same fields, same defaults."""
    benchmark: str = "speech"
    mapping: str = "uniform"          # uniform | fedscale | label_{balanced,uniform,zipf}
    n_learners: int = 200
    rounds: int = 200
    selector: str = "random"          # random | oort | priority | safa | flips | ucb | contribution
    selector_params: tuple = ()
    server_opt: str = "fedavg"        # fedavg | yogi
    aggregator: str = "saa"           # robust aggregator (repro_torch.robust)
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
    telemetry: int = 0                # 0 off, 1 host spans + the metrics
                                      # registry, 2 also the round-stats
                                      # lane and the per-round event log
    model: str = "mlp"
    model_params: tuple = ()

    def __post_init__(self):
        # older reference configs named the server optimizer `aggregator`
        if self.aggregator in ("fedavg", "yogi"):
            self.server_opt = self.aggregator
            self.aggregator = "saa"
        if self.shard_participants and not (self.fast_path
                                            and self.fused_rounds):
            # the reference raises this at run(); here before the
            # unported legacy engine's error, so the flag is never dropped
            raise ValueError(
                "shard_participants requires the fused fast path "
                "(fast_path=True, fused_rounds=True): the per-stage and "
                "legacy substrates have no sharded round")
        for unported, what, item in _UNPORTED:
            if unported(self):
                raise NotImplementedError(
                    f"{what} is not ported to repro_torch yet "
                    f"(ROADMAP.md queue 1 item {item})")
        if self.aggregator not in ROBUST_AGGREGATORS:
            raise ValueError(f"unknown aggregator {self.aggregator!r} "
                             f"(choose from {ROBUST_AGGREGATORS})")
        if self.attack not in ATTACK_KINDS:
            raise ValueError(f"unknown attack {self.attack!r} "
                             f"(choose from {ATTACK_KINDS})")
        self.selector_params = normalize_selector_params(
            self.selector, self.selector_params)
        self.model_params = MODEL_TABLE.normalize_params(self.model,
                                                         self.model_params)


# (predicate on a config, what it asks for, the ROADMAP queue 1 item that
# ports it)
_UNPORTED = (
    (lambda c: not c.fast_path, "the legacy pytree engine (fast_path=False)", 15),
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
    params0: object                    # initial model tree (CPU fp32 tensors)
    flat_params0: np.ndarray           # same model, flat fp32 (D,)
    flat_spec: object
    meta: object = None
    model_fns: object = None
    _warmed: Optional[tuple] = None
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False)

    @staticmethod
    def build(cfg: SimConfig, flat_params0: Optional[np.ndarray] = None
              ) -> "Substrate":
        rng = np.random.default_rng(cfg.seed)
        if part.benchmark_kind(cfg.benchmark) == "tokens":
            # token data derives from the seed alone and draws nothing from
            # ``rng``: profiles and traces take the fresh generator's first
            # draws, as in the reference
            data = part.make_token_dataset(cfg.benchmark, cfg.n_learners,
                                           cfg.seed)
            meta = DataMeta(kind="tokens", vocab=data.vocab,
                            seq_len=int(data.x_train.shape[1]))
        else:
            x_tr, y_tr, x_te, y_te = part.make_dataset(cfg.benchmark, rng)
            shards = part.partition(y_tr, cfg.n_learners, cfg.mapping, rng)
            data = part.FederatedDataset(cfg.benchmark, x_tr, y_tr, x_te,
                                         y_te, shards)
            meta = DataMeta(kind="classifier",
                            feature_dim=int(x_tr.shape[1]),
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
            params0 = unflatten_update(torch.from_numpy(flat0.copy()),
                                       flat_spec)
        return Substrate(key=substrate_key(cfg), data=data,
                         base_profiles=base_profiles, traces=traces,
                         trace_bank=tr.TraceBank(traces),
                         rng_state=rng.bit_generator.state,
                         params0=params0, flat_params0=flat0,
                         flat_spec=flat_spec, meta=meta, model_fns=model_fns)

    def device_data(self, device) -> tuple:
        """(x_train, y_train, x_test, y_test) on ``device`` (labels int64;
        classifier features fp32, token sequences int32), uploaded once per
        substrate and device: every Simulator built on this substrate, and
        every cell of a sweep batch, shares the copy."""
        key = str(torch.device(device))
        if key not in self._on_device:
            d = self.data
            self._on_device[key] = tuple(
                torch.as_tensor(a, dtype=dt, device=device)
                for a, dt in ((d.x_train, None), (d.y_train, torch.int64),
                              (d.x_test, None), (d.y_test, torch.int64)))
        return self._on_device[key]

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


def agg_lids(plan: RoundPlan, sched: RoundSchedule) -> list:
    """Learner ids behind a round's aggregation rows: fresh in arrival
    order, then the landing stale rows in cache order."""
    return ([int(plan.chosen[i]) for i in sched.fresh_rows]
            + [f.learner_id for f in sched.landing])


def _attach_attack(cfg: SimConfig, fault_plan):
    """The run's fault plan: ``fault_plan``, with ``cfg``'s coordinated
    attack attached when it has none (the reference's auto-attach; a
    restored plan already carries its attack)."""
    if attack_key(cfg) is None:
        return fault_plan
    plan = fault_plan
    if plan is None:
        plan = FaultPlan(cfg.n_learners, cfg.rounds, specs=(), seed=cfg.seed)
    if plan.attack is None:
        plan = plan.with_attack(AttackSpec(cfg.attack, cfg.attack_frac,
                                           cfg.attack_scale, cfg.attack_z))
    return plan


def evaluate_rows(model_fns, spec, rows, x_test, y_test):
    """(accuracy (L,), loss (L,)) of the L flat models ``rows`` (L, D'),
    read up to D, on one test set: the one evaluation every path runs (a
    serial run is its L = 1 case)."""
    n_rows = rows.shape[0]
    return model_fns.evaluate(
        unflatten_update(rows, spec), x_test.expand(n_rows, *x_test.shape),
        y_test.expand(n_rows, *y_test.shape))


class SharedData:
    """One device copy of each distinct substrate's dataset, shared by a
    batch's cells.  With one substrate its own copy serves (the copy its
    Simulators hold); with several, their training sets are concatenated
    once and a row's sample indices are offset to its substrate's block."""

    def __init__(self, sims, device):
        subs, self.sub_idx = [], []
        for sim in sims:
            if not any(sim.substrate is sb for sb in subs):
                subs.append(sim.substrate)
            self.sub_idx.append(next(j for j, sb in enumerate(subs)
                                     if sb is sim.substrate))
        self.tests = [sb.device_data(device)[2:] for sb in subs]
        if len(subs) == 1:
            self.x_train, self.y_train = subs[0].device_data(device)[:2]
            offs = [0]
        else:
            self.x_train = torch.as_tensor(
                np.concatenate([sb.data.x_train for sb in subs]), device=device)
            self.y_train = torch.as_tensor(
                np.concatenate([sb.data.y_train for sb in subs]),
                dtype=torch.int64, device=device)
            offs = np.cumsum([0] + [len(sb.data.y_train) for sb in subs[:-1]])
        self.row_off = [int(offs[j]) for j in self.sub_idx]

    def batches(self, bidx: torch.Tensor, steps: int, batch: int):
        """(bx (R, steps, batch, *sample), by (R, steps, batch, *label)) of
        the packed, already offset sample indices ``bidx`` (R, steps *
        batch): a classifier's x rows are (dim,) and its labels scalars, a
        token benchmark's x and y rows both (S,)."""
        r = bidx.shape[0]
        return (self.x_train[bidx].view(r, steps, batch,
                                        *self.x_train.shape[1:]),
                self.y_train[bidx].view(r, steps, batch,
                                        *self.y_train.shape[1:]))

    def evaluate(self, sims, params, cells):
        """Host (accuracy, loss) arrays of ``cells`` (indices into
        ``sims`` and the rows of ``params``), one batched evaluation per
        substrate and one device-to-host copy."""
        sim0 = sims[0]
        parts, order = [], []
        for j, (x_te, y_te) in enumerate(self.tests):
            mine = [i for i in cells if self.sub_idx[i] == j]
            if not mine:
                continue
            rows = params[mine] if len(sims) > 1 else params
            parts.append(torch.stack(evaluate_rows(
                sim0._model_fns, sim0._flat_spec, rows, x_te, y_te)))
            order += mine
        both = torch.cat(parts, dim=1).cpu().numpy()
        at = {i: k for k, i in enumerate(order)}
        pick = [at[i] for i in cells]
        return both[0, pick], both[1, pick]


# training rows a round: a power of two up to ROW_BLOCK, then multiples of
# it (``bucket_block``); the padding rows repeat row 0 and are discarded
ROW_BLOCK = 64


def pack_rows(sims, data: SharedData, plans, order):
    """The packed training rows of a round: every surviving learner of the
    cells ``order`` (with their ``plans``), cell by cell.  Returns (sample
    indices (R_b, steps*batch) offset to each row's substrate block, the
    rows' cells (R_b,), {cell: its survivors' first packed row}, R): R
    real rows padded to R_b = ``bucket_block(R, ROW_BLOCK)`` by repeating
    row 0 (None, None, ... when R = 0).  Every path pads alike: cuBLAS's
    batched GEMM may give a row other bits at another row count."""
    bidx, cell_of, first = [], [], {}
    for i in order:
        surv = sims[i].survivors(plans[i])[0]
        first[i] = len(cell_of)
        bidx.append(plans[i].bidx[surv] + data.row_off[i])
        cell_of += [i] * len(surv)
    n = len(cell_of)
    if not n:
        return None, None, first, 0
    pad = bucket_block(n, ROW_BLOCK) - n
    b = np.concatenate(bidx)
    return (np.concatenate([b, np.repeat(b[:1], pad, axis=0)]),
            np.asarray(cell_of + cell_of[:1] * pad, np.int64), first, n)


def train_rows(sims, data: SharedData, params, bidx, cells):
    """The batched local training of packed rows: sample indices ``bidx``
    (R, steps*batch), each row from its cell's row ``cells`` (R,) of
    ``params`` (S', D'), read up to D; a one-cell batch broadcasts row 0.
    Returns (deltas (R, D') zero past D, l2 stats (R,))."""
    cfg = sims[0].cfg
    bx, by = data.batches(bidx, cfg.local_steps, cfg.local_batch)
    p0 = params[0] if len(sims) == 1 else params[cells]
    deltas, _, l2 = ln.local_train_cohort(
        p0, bx, by, spec=sims[0]._flat_spec, lr=cfg.local_lr,
        prox_mu=cfg.prox_mu, loss=sims[0]._model_fns.loss,
        out_dim=params.shape[1])
    return deltas, l2


def train_packed(sims, data: SharedData, params, plans, order):
    """The packed training of a round (``pack_rows``, ``train_rows``) in
    one host-to-device copy.  Returns (deltas (R, D') zero past D, l2
    stats (R,), {cell: its survivors' first packed row}), R = 0 giving
    (None, None, ...)."""
    b, cells, first, n = pack_rows(sims, data, plans, order)
    if not n:
        return None, None, first
    r_b = len(cells)
    ints = torch.as_tensor(np.concatenate([b.ravel(), cells]),
                           device=params.device)
    deltas, l2 = train_rows(sims, data, params,
                            ints[:-r_b].view(r_b, -1), ints[-r_b:])
    return deltas[:n], l2[:n], first


class Simulator:
    def __init__(self, cfg: SimConfig, substrate: Optional[Substrate] = None,
                 device=None, fault_plan=None):
        self.cfg = cfg
        self.fault_plan = _attach_attack(cfg, fault_plan)
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
        self._sel_spec = SELECTOR_TABLE[cfg.selector]
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
        # the dataset's device copy, shared through the substrate: batches
        # are gathered there
        (self.x_train, self.y_train, self.x_test,
         self.y_test) = substrate.device_data(self.device)
        self.acct = Accounting()
        # the attack / robust descriptors (None: the plain path), and the
        # robust counters [rejected, trimmed] summed on the device and read
        # once by _finalize
        self._attack, self._robust = attack_key(cfg), robust_key(cfg)
        self.robust_counts = torch.zeros(2, dtype=torch.int32,
                                         device=self.device)
        # the fused pipeline's device guard counters [rejected non-finite,
        # rejected norm, quorum skips] (the flat path notes its own on the
        # host, one aggregation at a time)
        self.guard_counts = torch.zeros(3, dtype=torch.int32,
                                        device=self.device)
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

        fp = self.fault_plan
        arrivals = []   # (arrival_time, idx into chosen) for non-dropouts
        for i, lid in enumerate(chosen):
            if np.isfinite(drop_at[i]):
                # device went away mid-round: partial work, always wasted
                self.acct.charge(float(drop_at[i]), wasted=True)
                self.busy_until[lid] = t_now + float(drop_at[i])
            elif fp is not None and fp.post_drop(r, lid):
                # injected fault: trained, lost before upload; the full
                # duration is charged and wasted, no arrival, no feedback
                self.acct.charge(float(durs[i]), wasted=True)
                self.busy_until[lid] = t_now + float(durs[i])
            else:
                arrivals.append((t_now + durs[i], i))
                self.acct.charge(float(durs[i]), wasted=False)
                self.busy_until[lid] = t_now + float(durs[i])
        arrivals.sort()

        if self._sel_spec.select_all:
            # SAFA: the round ends at the ceil(ratio * cohort)-th arrival,
            # capped by the deadline
            need = max(1, int(np.ceil(cfg.safa_target_ratio * len(chosen))))
            t_end = (arrivals[need - 1][0] if len(arrivals) >= need
                     else t_now + cfg.deadline)
            t_end = min(t_end, t_now + cfg.deadline)
        elif cfg.setting == "OC":
            t_end = (arrivals[n_t - 1][0] if len(arrivals) >= n_t
                     else (arrivals[-1][0] if arrivals else t_now + cfg.deadline))
        else:  # DL
            t_end = t_now + cfg.deadline

        fresh_rows, new_stale, feedback = [], [], []
        for (arr, i) in arrivals:
            lid = chosen[i]
            feedback.append((lid, i, durs[i]))
            if arr <= t_end and (cfg.setting == "DL" or self._sel_spec.select_all
                                 or len(fresh_rows) < n_t):
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
                    if fp is not None and fp.replay(r, f.learner_id):
                        # injected fault: the same stale delivery lands
                        # twice, a duplicate row in the operand
                        landing.append(f)
                        landing_taus.append(tau)
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
        deltas, l2, _ = train_packed([self], SharedData([self], self.device),
                                     self.flat_params[None], {0: plan}, [0])
        if deltas is None:
            return None, pos, l2s
        l2s[surv] = l2.cpu().numpy()
        return deltas, pos, l2s

    def _corrupt_deltas(self, r: int, plan: RoundPlan, deltas):
        """The fault plan's update corruption of a round's trained rows
        ``deltas`` (the plan's survivors, in plan order): one fp32 multiply
        a row after training and before caching or aggregation, the
        operation the fused pipeline runs on its packed rows.  Losses and
        l2 stats stay those of the clean rows."""
        fp = self.fault_plan
        if deltas is None or fp is None or not fp.has_corruption:
            return deltas
        scale = fp.scale_for(r, plan.chosen)[self.survivors(plan)[0]]
        return deltas * torch.as_tensor(scale, device=deltas.device)[:, None]

    def _collect_updates(self, r: int, plan: RoundPlan, deltas, pos, l2s):
        """Schedule the round, apply selector feedback (stat utility from
        ``l2s``, by plan row), then take the scheduled rows out of the
        round's deltas.  New stragglers enter ``stale_cache`` with a cloned
        device row.  Returns (t_end, fresh_updates, stale_updates,
        stale_taus, agg_lids): ``agg_lids`` are the learner ids behind the
        aggregation rows, fresh first, then landing stale."""
        sched = self._schedule_round(r, plan)
        self._apply_feedback(r, sched, l2s)
        fresh_updates = [deltas[pos[i]] for i in sched.fresh_rows]
        for (i, lid, arr, dur) in sched.new_stale:
            self.stale_cache.append(_InFlight(lid, r, arr, dur,
                                              deltas[pos[i]].clone(),
                                              self._stat_util(i, l2s)))
        stale_updates = [f.delta for f in sched.landing]
        return (sched.t_end, fresh_updates, stale_updates, sched.landing_taus,
                agg_lids(plan, sched))

    def _aggregate(self, r, lids, fresh_updates, stale_updates, stale_taus):
        """The aggregated delta (D,) of round ``r``'s rows, fresh first, or
        None when the guard's quorum check rejects the round (the caller
        keeps its params).  Attacked or robust rounds take
        ``robust_host_aggregate`` (attack, guard screen, robust mask,
        weights), with the attacker flags of the rows' learner ids
        ``lids`` (a stale row is flagged for the round it lands); guarded
        ones ``guarded_aggregate_flat``.  Guard counts are noted here."""
        cfg = self.cfg
        nf, ns = len(fresh_updates), len(stale_updates)
        stacked = torch.stack(fresh_updates + stale_updates)
        guard = (cfg.guard_clip, cfg.guard_reject_mult) if cfg.guard else None
        quorum = max(int(cfg.quorum), 1)
        if self._attack is not None or self._robust is not None:
            agg, counts = robust_host_aggregate(
                stacked, [True] * nf + [False] * ns, [0] * nf + list(stale_taus),
                self.attack_flags(r, lids), attack=self._attack,
                robust=self._robust, use_kernel=cfg.use_agg_kernel,
                beta=cfg.beta, rule=cfg.scaling_rule, guard=guard)
            self.robust_counts += counts[:2]
            if guard is None:
                return agg
            n_nf, n_out, survivors = counts[2:].tolist()
            self.acct.note_guard(n_nf, n_out, survivors >= quorum)
            return agg if survivors >= quorum else None
        fresh = torch.arange(nf + ns, device=self.device) < nf
        tau = torch.as_tensor(np.asarray([0] * nf + list(stale_taus),
                                         np.int32), device=self.device)
        if guard is not None:
            agg, _, info = guarded_aggregate_flat(
                stacked, fresh, tau, rule=cfg.scaling_rule, beta=cfg.beta,
                use_kernel=cfg.use_agg_kernel, clip=guard[0],
                reject_mult=guard[1], quorum=quorum)
            self.acct.note_guard(info["nonfinite"], info["norm"],
                                 info["applied"])
            return agg if info["applied"] else None
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
        acc, loss = evaluate_rows(self._model_fns, self._flat_spec,
                                  self.flat_params[None], self.x_test,
                                  self.y_test)
        return acc[0], loss[0]

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

    def attack_flags(self, r: int, lids):
        """Which of ``lids`` are in round ``r``'s attacker set (None when
        no attack is armed)."""
        if self._attack is None:
            return None
        return self.fault_plan.attack_flags(r, lids)

    def _finalize(self, telemetry=None) -> Accounting:
        """The run's end: in-flight work charged as wasted, and the device
        counters noted through ``telemetry`` (the session's registry and
        the accounting; a directory-less session when None)."""
        if telemetry is None:
            telemetry = TelemetrySession()
        # updates still in flight at the end of training are wasted work
        for f in self.stale_cache:
            self.acct.mark_wasted(f.duration)
        if self._robust is not None:       # the run's one read of the counts
            telemetry.note_robust(self.acct, *self.robust_counts.tolist())
        if self.cfg.guard:                 # the fused pipeline's counters
            n_nf, n_out, skips = self.guard_counts.tolist()
            telemetry.note_guard(self.acct, n_nf, n_out, skips=skips)
        self.params = unflatten_update(self.flat_params, self._flat_spec)
        return self.acct

    # ------------------------------------------------------------------
    # Snapshots (crash-safe resume at round and chunk boundaries)
    # ------------------------------------------------------------------

    def capture_state(self, stale_rows=None, robust_counts=None,
                      guard_counts=None) -> dict:
        """Everything mutable the round loop reads, as host objects that
        pickle: RNG stream, selector, APT, accounting, forecasters, busy
        clocks, the stale cache's entries with their rows (``stale_rows``,
        aligned with ``stale_cache``: the fused pipeline gathers them from
        its device cache, where an entry's ``delta`` is a slot id) and the
        device counters not yet noted in the accounting (the pipeline
        passes its own rows of them)."""
        fb = self.fbank
        entries = []
        for k, f in enumerate(self.stale_cache):
            row = f.delta if stale_rows is None else stale_rows[k]
            entries.append((f.learner_id, f.origin_round, f.arrival,
                            f.duration, f.stat_util,
                            torch.as_tensor(row).cpu().numpy()))
        counts = {"robust": (self.robust_counts if robust_counts is None
                             else robust_counts),
                  "guard": (self.guard_counts if guard_counts is None
                            else guard_counts)}
        return {"rng": self.rng.bit_generator.state,
                "selector": copy.deepcopy(self.selector),
                "apt": copy.deepcopy(self.apt),
                "busy_until": self.busy_until.copy(), "mu": self.mu,
                "t_now": self._t_now, "acct": copy.deepcopy(self.acct),
                "fbank": (fb.counts.copy(), fb.avail_counts.copy(),
                          fb.recent.copy()),
                "counts": {k: v.cpu().numpy() for k, v in counts.items()},
                "stale": entries}

    def restore_state(self, st: dict) -> None:
        """Inverse of ``capture_state``.  Stale entries come back with
        their rows as device tensors in ``delta``; a fused pipeline
        re-seats them into its device cache
        (``repro_torch.checkpoint.state``)."""
        self.rng.bit_generator.state = st["rng"]
        self.selector = copy.deepcopy(st["selector"])
        self.apt = copy.deepcopy(st["apt"])
        self.busy_until = np.array(st["busy_until"])
        self.mu = st["mu"]
        self._t_now = st["t_now"]
        self.acct = copy.deepcopy(st["acct"])
        self.fbank.counts, self.fbank.avail_counts, self.fbank.recent = (
            np.array(a) for a in st["fbank"])
        self.robust_counts = torch.as_tensor(st["counts"]["robust"],
                                             device=self.device).clone()
        self.guard_counts = torch.as_tensor(st["counts"]["guard"],
                                            device=self.device).clone()
        self.stale_cache = [
            _InFlight(lid, orig, arr, dur,
                      torch.as_tensor(row, device=self.device), su)
            for (lid, orig, arr, dur, su, row) in st["stale"]]

    def run(self, progress: bool = False, *,
            checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 0, telemetry=None) -> Accounting:
        """Run every round; with ``checkpoint_path`` and
        ``checkpoint_every``, a snapshot every ``checkpoint_every`` rounds
        (the fused pipeline: at the first chunk boundary past each).
        ``telemetry``: the run's ``TelemetrySession`` (spans, registry and,
        on the fused pipeline at level 2, the round log)."""
        if self.cfg.fused_rounds:
            from repro_torch.sim.pipeline import RoundPipeline
            return RoundPipeline([self], progress=progress,
                                 checkpoint_path=checkpoint_path,
                                 checkpoint_every=checkpoint_every,
                                 telemetry=telemetry).run()[0]
        self._t_now = 0.0
        return self._run_loop(0, progress, checkpoint_path, checkpoint_every,
                              telemetry=telemetry)

    def _run_loop(self, start_round: int, progress: bool,
                  checkpoint_path: Optional[str] = None,
                  checkpoint_every: int = 0, telemetry=None) -> Accounting:
        """The per-stage flat round loop from ``start_round`` (a restored
        Simulator resumes here without resetting its clock), with the
        snapshot and crash hooks after each round.  Its stages are
        ``telemetry``'s spans (no lane, no round log on this route, as in
        the reference)."""
        if telemetry is None:
            telemetry = TelemetrySession()
        fp, rounds = self.fault_plan, self.cfg.rounds
        for r in range(start_round, rounds):
            if self._flat_round(r, progress, telemetry) is not None and \
                    self._target_reached():
                self.acct.stopped_early = True
                break
            if checkpoint_path and checkpoint_every and \
                    (r + 1) % checkpoint_every == 0 and r + 1 < rounds:
                from repro_torch.checkpoint.state import save_engine_snapshot
                with telemetry.span("checkpoint", round=r + 1):
                    save_engine_snapshot(checkpoint_path, self, r + 1)
            if fp is not None and fp.crash_due(r):
                telemetry.event("crash", round=r, mode=fp.crash_mode)
                telemetry.flush()
                fp.trigger_crash(r)
        return self._finalize(telemetry)

    def _flat_round(self, r: int, progress: bool, telemetry=None):
        """One round of the flat path; returns its RoundRecord, or None
        when the round was skipped.  The telemetry spans are the
        reference's (schedule, dispatch, fetch, eval); the profiler ranges
        carry the fused pipeline's names: host stages, device work,
        bookkeeping + eval."""
        if telemetry is None:
            telemetry = TelemetrySession()
        with telemetry.span("schedule", round=r), \
                record_function("round.schedule"):
            plan = self._begin_round(r)
        if plan is None:
            return None
        with telemetry.span("dispatch", round=r), \
                record_function("round.device"):
            deltas, pos, l2s = self._train(plan)
            deltas = self._corrupt_deltas(r, plan, deltas)
        with telemetry.span("fetch", round=r):
            with record_function("round.schedule"):
                t_end, fresh, stale, taus, lids = self._collect_updates(
                    r, plan, deltas, pos, l2s)
            if fresh or stale:
                with record_function("round.device"):
                    agg = self._aggregate(r, lids, fresh, stale, taus)
                    if agg is not None:
                        self._apply_update(agg)
        with telemetry.span("eval", round=r), record_function("round.eval"):
            return self._record_round(r, plan.t_now, t_end, len(plan.chosen),
                                      len(fresh), len(stale),
                                      progress=progress)
