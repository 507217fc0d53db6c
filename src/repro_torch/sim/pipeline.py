"""Device-resident round pipeline for S >= 1 lockstep simulations, in
K-round chunks (port of the unsharded case of ``repro.sim.pipeline``).

``RoundPipeline`` drives one Simulator (``Simulator.run()`` passes
``[self]``) or a sweep batch of compatible ones (``pipeline_key``) in
chunks of up to K = ``SimConfig.rounds_per_dispatch`` rounds, broken at
``eval_every`` boundaries.  A chunk is:

  1. the host half of each of its rounds, in order (``_schedule``): every
     live cell's plan, schedule, stale-cache slots (the slots freed by a
     round's landings are quarantined for one round, so a round's scatter
     slots never collide with its gather slots), selector feedback and
     record.  Nothing in it reads an update value, so K rounds are
     scheduled before any of their device work runs;
  2. one packed int64 index block a round (``_pack``), laid out by the
     round's padded shape (``graphs.Bucket``), and one host-to-device copy
     of the chunk's blocks;
  3. each round's device work (``_device_round``), from its block alone:
     the survivors' local batches gathered from one copy of each distinct
     substrate's dataset and trained in one batched call, each row from
     its cell's model; under a fault plan's update corruption each trained
     row times its fp32 multiplier (carried in the block as bit
     patterns); every trained row scattered into the batch's one
     device stale cache (a straggler into its slot, any other row into the
     trash slot) *before* the operand gathers its landing rows; the
     round's groups (the cells with fresh or landing rows) as one (G, n, D)
     operand, a group's rows first, then invalid zero rows; under the
     guard (``SimConfig.guard``) the operand's rows screened
     (``core.aggregation.screen_rows``: non-finite and norm-outlier rows
     rejected and zeroed, survivors clipped), the survivor mask in place
     of the valid one; and the server step: under ``use_agg_kernel``
     FedAvg is ONE launch of
     ``sweep_fused_staleness_apply`` (kernel 1) with per-cell ``(beta,
     server_lr)`` rows, YoGi one launch of ``sweep_fused_staleness_aggregate``
     (kernel 2) before its batched elementwise step; an attacked or robust
     batch runs ``robust.aggregators.robust_sweep`` (the coordinate-wise
     kinds under ``use_agg_kernel``: ONE launch of kernel 7 for the G
     groups); without the kernels each group runs ``core.aggregation``'s
     torch path on its own rows.  A round in which no cell aggregates runs
     no server step; under the guard a group whose survivors fall below
     ``quorum`` keeps its params and YoGi state (its step is computed and
     discarded, as in the reference);
  4. at an ``eval_every`` boundary, the evaluation of every live cell in
     one batched call per substrate, and the early stops;
  5. at the chunk's end, a snapshot when one is due
     (``checkpoint_path``, ``checkpoint_every``), then the fault plans'
     crash.  Snapshots and crashes come only at chunk boundaries, so a
     resumed run (``start_round``, ``repro_torch.checkpoint``) walks the
     chunks the uninterrupted run walks.

On the card a round of a non-robust batch under the SAA kernels is
replayed from a CUDA graph captured once per bucket (``graphs.py``): one
copy of its block into the graph's input and one graph launch.  The graphs
and the buffers they read outlive the run: the next pipeline of the same
static structure refills the buffers and replays them.  Attacked,
robust and ``use_agg_kernel=False`` batches run the same rounds eagerly
(``stats.as_dict()["graphed"]`` says which).  On the CPU every round runs
eagerly on the same padded blocks.

Padding (``bucket_block``): training rows to a power of two up to 64,
then multiples of 64 (``engine.ROW_BLOCK``, shared with the per-stage
paths); under the SAA kernels, groups to a power of two up to 64, then
multiples of 64 (``G_BLOCK``), and a group's operand rows to a power of
two up to 8, then multiples of 8 (``N_BLOCK``).  The other routes keep the
round's exact groups and rows, which their per-group steps read.  A padding
training row repeats row 0 and scatters into the trash slot; a padding
group is all-invalid and reads and writes the params' scratch row (S), so
results do not depend on the block sizes.  A round's shape depends only on
that round, so K-round chunks run the very rounds K = 1 runs.

Every decision of a round depends only on durations and dropouts, never on
update values, so the host side equals the reference's.  Per-cell results
are bit-identical to serial runs because no reduction a cell's numbers go
through depends on the batch: training rows never mix, the CUDA SAA
kernels and kernel 7 reduce each cell apart (padding adds exact zeros, or
``+inf`` rows past the band), and the torch steps whose blocking follows
their shape (row norms and sums over D, a mean over an (L, N) block) run
per group on the group's own rows.

A ``needs_feedback`` selector (oort, ucb, contribution) reads each
arrival's statistical utility from the training's per-row l2 stats before
the next round's selection, so its batch runs one-round chunks: the
round's stats are copied to the host once, after its device round (span
``round.feedback``), then each cell's feedback is applied and its
stragglers cached, cell by cell in batch order.  Any other selector gets
its feedback (utility 0) in the host half.

A cell whose evaluation reaches its ``target_accuracy`` leaves the live
set: no host stage, no rows, no group, no evaluation.

Every pipeline has a ``TelemetrySession`` (``repro_torch.telemetry``): its
registry holds the ``PipelineStats`` counters, and its spans time the
chunk's stages (``schema.SPAN_NAMES``).  At ``SimConfig.telemetry >= 2``
each round's device work also writes the round-stats lane of its groups
(``schema.LANE_FIELDS``: the host fields, packed into the index block as
fp32 bits; the operand's l2 statistics before the screen; the guard and
robust counts) into its slot of the chunk's (K, G, 16) lane buffer, inside
the round's graph on the card.  After the chunk (and its evaluation) the
buffer is copied to the host once and each live cell's round becomes one
event of the session's round log, which snapshots carry by byte offset.
The lane only reads the operand: level 2 moves no bit of a run.

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
from collections import Counter

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.aggregation import (bucket_block, flat_dim,
                                          no_stale_aggregate, screen_rows,
                                          weights_and_aggregate_by_id,
                                          yogi_apply_flat, yogi_init_flat)
from repro_torch.core.stale_cache import DeviceStaleCache
from repro_torch.core.staleness import RULE_ID
from repro_torch.faults import InjectedCrash, attack_key, apply_attack
from repro_torch.kernels.staleness_agg import ops as saa_ops
from repro_torch.kernels.staleness_agg.ref import row_order_sum
from repro_torch.learners import model_key
from repro_torch.robust import robust_key
from repro_torch.robust.aggregators import robust_sweep
from repro_torch.selection.registry import selector_key
from repro_torch.sim.engine import (SharedData, _InFlight, agg_lids,
                                   pack_rows, train_rows)
from repro_torch.sim.graphs import (Bucket, RoundGraphs, acquire, release,
                                   upload)
from repro_torch.telemetry import TelemetrySession
from repro_torch.telemetry.registry import CounterView, MetricsRegistry
from repro_torch.telemetry.schema import (DISPATCH_KINDS, GUARD_COUNTERS,
                                          LANE_WIDTH, N_LANE_HOST,
                                          PIPELINE_COUNTERS)

G_BLOCK = 64      # aggregation groups a round under the SAA kernels
N_BLOCK = 8       # operand rows a group under the SAA kernels


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


def _registry_counter(name: str) -> property:
    """A ``PipelineStats`` attribute stored in its registry's counter
    ``pipeline_<name>``."""
    return property(
        lambda s: s.registry.counter("pipeline_" + name).value,
        lambda s, v: setattr(s.registry.counter("pipeline_" + name),
                             "value", v))


class PipelineStats:
    """Dispatch, transfer, guard and graph counters of a pipeline run (the
    reference's ``PipelineStats``): a view over a telemetry
    ``MetricsRegistry``, the one storage of every counter, so
    ``as_dict()``, the Prometheus snapshot and the cells' guard accounting
    cannot disagree.  ``dispatches`` and ``guard`` are dict-like
    ``CounterView``s.  When pipelines share one session (a sweep given a
    ``TelemetrySession``), the registry's counters run on across batches
    and ``as_dict()`` holds the totals so far.  The graph counters are the
    pipeline's own: ``graphed``, ``graph_captures``, ``graph_replays``,
    ``graph_capture_s`` (host seconds in warm-ups and captures) and
    ``warmup_launches``.  ``cross_shard_landings`` stays 0: the port runs
    unsharded."""

    GUARD_KEYS = tuple(k[len("guard_"):] for k in GUARD_COUNTERS)

    rounds = _registry_counter("rounds")
    h2d_bytes = _registry_counter("h2d_bytes")
    d2h_bytes = _registry_counter("d2h_bytes")
    init_h2d_bytes = _registry_counter("init_h2d_bytes")
    cross_shard_landings = _registry_counter("cross_shard_landings")
    feedback_fetches = _registry_counter("feedback_fetches")

    def __init__(self, registry: MetricsRegistry = None,
                 rounds_per_dispatch: int = 1, graphed: bool = False):
        self.registry = (registry if registry is not None
                         else MetricsRegistry())
        for name in PIPELINE_COUNTERS:
            self.registry.counter(name)
        self.dispatches = CounterView(self.registry, "pipeline_dispatches_",
                                      DISPATCH_KINDS)
        self.guard = CounterView(self.registry, "guard_", self.GUARD_KEYS)
        self.rounds_per_dispatch = rounds_per_dispatch
        self.graphed = graphed
        self.graph_captures = 0
        self.graph_replays = 0
        self.graph_capture_s = 0.0
        self.warmup_launches = Counter()

    def as_dict(self) -> dict:
        return {"rounds": self.rounds,
                "dispatches": dict(self.dispatches),
                "rounds_per_dispatch": self.rounds_per_dispatch,
                "feedback_fetches": self.feedback_fetches,
                "h2d_bytes": self.h2d_bytes,
                "d2h_bytes": self.d2h_bytes,
                "init_h2d_bytes": self.init_h2d_bytes,
                "cross_shard_landings": self.cross_shard_landings,
                "guard": dict(self.guard),
                "graphed": self.graphed,
                "graph_captures": self.graph_captures,
                "graph_replays": self.graph_replays,
                "graph_capture_s": self.graph_capture_s,
                "warmup_launches": dict(self.warmup_launches)}


@dataclasses.dataclass
class RoundWork:
    """One scheduled round of a chunk: the host state machines have run
    past it (plans, schedules, slots, records); ``_pack`` adds its index
    block, the device round and the evaluation remain."""
    r: int
    order: list          # cells with a plan this round, in batch order
    plans: dict
    scheds: dict
    recs: dict
    occ: dict = None     # cell -> its stale-cache entries after scheduling
    pos: int = 0         # its position in the chunk (its lane slot)
    first: dict = None   # cell -> its survivors' first packed row
    n_rows: int = 0      # trained rows (before padding)
    groups: list = None  # cells that aggregate, in batch order
    sizes: list = None   # their operand rows
    bucket: Bucket = None
    block: object = None  # the packed indices (host numpy, then device)


def _quarantine_frees(order, scheds) -> list:
    """Cache slots released by a round's landings and expiries (every
    cell's), one per in-flight entry: a replay fault lands an entry twice,
    and its slot is freed once.  The pipeline frees them one round
    later."""
    out, seen = [], set()
    for i in order:
        for f in scheds[i].landing + scheds[i].expired:
            if id(f) not in seen:
                seen.add(id(f))
                out.append(f.delta)
    return out


def lane_norms(u, valid, d: int) -> torch.Tensor:
    """The lane's device statistics of a (G, n, D) operand before the
    screen (``LANE_FIELDS`` 6-9): l2 min, mean and max over each group's
    finite valid rows (0 when it has none), from the leading ``d`` (true)
    columns, and the count of non-finite valid rows; (G, 4) fp32.  The
    mean sums the norms in row order, so padding rows move no bit."""
    u_t = u[..., :d] if u.shape[-1] != d else u
    finite = torch.isfinite(u_t).all(dim=-1)
    norms = torch.sqrt((u_t * u_t).sum(dim=-1))
    ok = valid & finite
    cnt = ok.sum(dim=1)
    l2_min = torch.where(ok, norms, torch.inf).amin(dim=1)
    l2_max = torch.where(ok, norms, -torch.inf).amax(dim=1)
    l2_sum = row_order_sum(torch.where(ok, norms, 0.0))[:, 0]
    l2_mean = l2_sum / torch.clamp(cnt, min=1).to(torch.float32)
    stats = torch.stack([l2_min, l2_mean, l2_max], dim=1)
    return torch.cat([torch.where((cnt > 0)[:, None], stats, 0.0),
                      (valid & ~finite).sum(dim=1)[:, None].to(
                          torch.float32)], dim=1)


def _fp32_bits(x) -> np.ndarray:
    """fp32 values as int32 bit patterns (the int64 block carries them)."""
    return np.asarray(x, np.float32).view(np.int32)


class RoundPipeline:
    def __init__(self, sims, progress: bool = False, *,
                 checkpoint_path=None, checkpoint_every: int = 0,
                 checkpoint_wrap=None, start_round: int = 0, telemetry=None,
                 labels=None):
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
        # every pipeline has a telemetry session (a directory-less one costs
        # nothing but still backs PipelineStats with a live registry); the
        # round-stats lane and the round log at level >= 2
        self.telemetry = (telemetry if telemetry is not None
                          else TelemetrySession())
        self._labels = (list(labels) if labels is not None
                        else [f"sim{i}" for i in range(len(sims))])
        self._lane = int(cfg0.telemetry) >= 2
        # snapshots every ``checkpoint_every`` rounds at chunk boundaries;
        # ``checkpoint_wrap`` wraps each payload (a sweep's envelope)
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = int(checkpoint_every or 0)
        self.checkpoint_wrap = checkpoint_wrap
        self.start_round = int(start_round)
        self._next_ckpt = self.start_round + self.checkpoint_every
        self.device = dev = sims[0].device
        self.spec = sims[0]._flat_spec
        self.d = flat_dim(self.spec)
        self.attack, self.robust = attack_key(cfg0), robust_key(cfg0)
        robust = self.attack is not None or self.robust is not None
        # the guard (clip, reject_mult, quorum) and whether any cell's plan
        # corrupts updates: both fix the round's device work
        self.guard = ((cfg0.guard_clip, cfg0.guard_reject_mult,
                       max(int(cfg0.quorum), 1)) if cfg0.guard else None)
        self.faulty = any(sim.fault_plan is not None
                          and sim.fault_plan.has_corruption for sim in sims)
        # the SAA kernels' route: padded shapes, graphed on the card
        self.kernel_route = cfg0.use_agg_kernel and not robust
        self.d_pad = (self.d + (-self.d) % saa_ops.D_BLK
                      if self.kernel_route else self.d)
        self.s = s = len(sims)
        # (S + 1, d_pad): the kernels' (S, D) params operand, a row a cell,
        # and the scratch row that padding groups read and write
        self.params = torch.zeros((s + 1, self.d_pad), dtype=torch.float32,
                                  device=dev)
        for i, sim in enumerate(sims):
            self.params[i, :self.d] = sim.flat_params
        self.cache = DeviceStaleCache(
            self.d_pad, capacity=max(sim.cfg.stale_cache_capacity
                                     for sim in sims), device=dev)
        self.yogi = cfg0.server_opt == "yogi"
        if self.yogi:
            # each cell's YoGi state (a resumed run's restored one), the
            # scratch row a fresh state
            st = yogi_init_flat(self.d, device=dev, width=self.d_pad)
            self.opt_state = {"m": st["m"].repeat(s + 1, 1),
                              "v": st["v"].repeat(s + 1, 1),
                              "t": torch.zeros(s + 1, dtype=torch.int32,
                                               device=dev)}
            for i, sim in enumerate(sims):
                for k in ("m", "v"):
                    self.opt_state[k][i, :self.d] = sim.flat_opt_state[k]
                self.opt_state["t"][i] = sim.flat_opt_state["t"]
        else:
            self.opt_state = None
        # per-cell (beta, server_lr) rows, the scratch row a copy of cell
        # 0's: the kernel's scal operand
        self._scal = torch.tensor([[sim.cfg.beta, sim.cfg.server_lr]
                                   for sim in sims + sims[:1]],
                                  dtype=torch.float32, device=dev)
        # device counters, from each cell's own (a resumed run's restored
        # ones): robust [rejected, trimmed]; guard [rejected non-finite,
        # rejected norm, quorum skips], with the scratch row padding
        # groups add to
        self.robust_counts = torch.stack([sim.robust_counts
                                          for sim in sims])
        self.guard_counts = torch.cat([
            torch.stack([sim.guard_counts for sim in sims]),
            torch.zeros((1, 3), dtype=torch.int32, device=dev)])
        self.data = SharedData(sims, dev)
        self.fetch_l2s = sims[0]._sel_spec.needs_feedback
        # a feedback selector's stats are device data the next round's
        # selection reads: its batch runs one-round chunks
        self.k_rounds = (1 if self.fetch_l2s
                         else max(1, int(cfg0.rounds_per_dispatch)))
        graphed = dev.type == "cuda" and self.kernel_route
        self.stats = PipelineStats(self.telemetry.registry,
                                   rounds_per_dispatch=self.k_rounds,
                                   graphed=graphed)
        self.stats.init_h2d_bytes += self.params.numel() * 4 + sum(
            t.numel() * t.element_size() for t in (
                self.data.x_train, self.data.y_train,
                *(a for pair in self.data.tests for a in pair)))
        # the lane: a (G, LANE_WIDTH) fp32 row block a round, each round's
        # at its position in the chunk, copied to the host once a chunk
        self.lane = (torch.zeros(
            (self.k_rounds, bucket_block(s, G_BLOCK) if self.kernel_route
             else s, LANE_WIDTH), dtype=torch.float32, device=dev)
            if self._lane else None)
        # the buffers the graphs read, and the graphs (None: eager rounds)
        self._ws = self._workspace(cfg0) if graphed else None
        self.graphs = self._ws
        self.done = [False] * s
        self._pending_free = []   # freed slots quarantined for one round

    def _workspace(self, cfg0) -> RoundGraphs:
        """The graphed route's static buffers and graphs: an idle
        ``RoundGraphs`` of this pipeline's static structure, refilled with
        this run's params, optimizer state, scalars and data, or a new one;
        the pipeline then reads and writes its buffers."""
        static = {"params": self.params, "scal": self._scal,
                  "x": self.data.x_train, "y": self.data.y_train,
                  **(self.opt_state or {}),
                  **({"gcount": self.guard_counts} if self.guard else {}),
                  **({"lane": self.lane} if self._lane else {})}
        # the guard, the corruption multiplier and the lane change the
        # round's work: a guarded, faulted or level-2 run never replays
        # another's graphs
        key = (str(self.device), self.s, self.d, self.d_pad, self.yogi,
               cfg0.scaling_rule, self.spec, cfg0.local_lr, cfg0.prox_mu,
               cfg0.local_steps, cfg0.local_batch, model_key(cfg0),
               self.guard, self.faulty, self._lane) + tuple(
            (k, tuple(t.shape), t.dtype) for k, t in static.items())
        ws = acquire(key)
        if ws is None:     # its own copies: the data may be a substrate's
            ws = RoundGraphs(self.device, key,
                             {k: t.clone() for k, t in static.items()})
        else:
            for k, t in static.items():
                ws.buffers[k].copy_(t)
        b = ws.buffers
        self.params, self._scal = b["params"], b["scal"]
        self.data.x_train, self.data.y_train = b["x"], b["y"]
        if self.yogi:
            self.opt_state = {k: b[k] for k in ("m", "v", "t")}
        if self.guard:
            self.guard_counts = b["gcount"]
        if self._lane:
            self.lane = b["lane"]
        self.cache.rows = ws.cache_rows(self.cache.rows)
        return ws

    def run(self):
        """Drive every round from ``start_round`` in chunks of up to K,
        broken at evaluation rounds, then finalize; returns the cells'
        Accountings, in batch order.  After each chunk: a snapshot when
        one is due, then any scheduled crash (a soft crash hands the
        graphs back before it propagates)."""
        if self.start_round == 0:
            for sim in self.sims:
                sim._t_now = 0.0
        r, rounds = self.start_round, self.sims[0].cfg.rounds
        plans = [sim.fault_plan for sim in self.sims
                 if sim.fault_plan is not None]
        try:
            while r < rounds and not all(self.done):
                chunk = []
                while len(chunk) < self.k_rounds:
                    chunk.append(r)
                    if self.sims[0].eval_due(r):
                        break
                    r += 1
                r = chunk[-1] + 1
                self._run_chunk(chunk)
                if (self.checkpoint_path and self.checkpoint_every
                        and r >= self._next_ckpt and r < rounds):
                    with self.telemetry.span("checkpoint", round=r):
                        self.checkpoint(r)
                    self._next_ckpt = r + self.checkpoint_every
                for fp in plans:
                    if fp.crash_due(r - 1):
                        # logged and flushed first: a hard crash is a
                        # SIGKILL
                        self.telemetry.event("crash", round=r - 1,
                                             mode=fp.crash_mode)
                        self.telemetry.flush()
                        fp.trigger_crash(r - 1)
        except InjectedCrash:
            self._release()
            raise
        return self.finalize()

    def step(self, r: int) -> list:
        """Round ``r`` alone, as a one-round chunk: the host state
        machines, the device round, the evaluation when due, the early
        stops.  Returns each cell's RoundRecord (None for a cell that
        skipped the round or had stopped)."""
        works = self._run_chunk([r])
        recs = works[0].recs if works else {}
        return [recs.get(i) for i in range(self.s)]

    def _run_chunk(self, rounds) -> list:
        """Schedule the chunk's rounds, upload their blocks in one copy,
        run their device rounds, then evaluate if the chunk ends on an
        evaluation round; at level 2, copy the chunk's lane to the host
        and log its round events.  Returns the scheduled rounds'
        RoundWork.  Each stage is a telemetry span (``SPAN_NAMES``) and a
        ``round.*`` profiler range."""
        tel = self.telemetry
        with tel.span("schedule", rounds=len(rounds)), \
                record_function("round.schedule"):
            works = [w for w in map(self._schedule, rounds) if w is not None]
        if not works:
            return works
        with tel.span("pack", rounds=len(works)), \
                record_function("round.pack"):
            for k, w in enumerate(works):
                w.pos = k
            blocks = [self._pack(w) for w in works]
            chunk = upload(np.concatenate(blocks), self.device)
            off = 0
            for w, b in zip(works, blocks):
                w.block = chunk[off:off + b.size]
                off += b.size
        self.stats.h2d_bytes += chunk.numel() * chunk.element_size()
        self.stats.dispatches["round"] += 1
        self.stats.rounds += len(works)
        with tel.span("dispatch", rounds=len(works)):
            for w in works:
                with record_function("round.device"):
                    l2 = self._device_round(w.r, w)
        if self.fetch_l2s:          # one-round chunks: ``l2`` is works[0]'s
            with tel.span("fetch"), record_function("round.feedback"):
                self._fetch_feedback(works[0], l2)
        last = works[-1]
        if self.sims[last.order[0]].eval_due(last.r):
            with tel.span("eval", round=last.r), \
                    record_function("round.eval"):
                self._eval(last)
        if self._lane:
            with tel.span("fetch"), record_function("round.lane"):
                self._log_rounds(works)
        return works

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
        capacity = self.cache.capacity
        for i in order:
            if scheds[i].new_stale:
                scheds[i].slots = self.cache.alloc(len(scheds[i].new_stale))
        if self.cache.capacity != capacity:
            self.stats.dispatches["cache_grow"] += 1
            if self._ws is not None:
                self.cache.rows = self._ws.cache_rows(self.cache.rows)
        if not self.fetch_l2s:
            for i in order:
                self._feedback(sims[i], r, scheds[i], None)
        recs = {i: sims[i]._advance_round_state(
            r, plans[i].t_now, scheds[i].t_end, len(plans[i].chosen),
            len(scheds[i].fresh_rows), len(scheds[i].landing))
            for i in order}
        # the lane's cache occupancy, read now: the chunk's later rounds
        # change the host cache before this round's device work runs (a
        # feedback selector's new stragglers enter it after the round)
        occ = ({i: len(sims[i].stale_cache) + (
            len(scheds[i].new_stale) if self.fetch_l2s else 0)
            for i in order} if self._lane else None)
        return RoundWork(r, order, plans, scheds, recs, occ)

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
        self.stats.feedback_fetches += 1
        l2_host = None if l2 is None else l2.cpu().numpy()
        for i in work.order:
            sim, plan = self.sims[i], work.plans[i]
            l2s = np.zeros(plan.k, np.float32)      # by plan row
            surv = sim.survivors(plan)[0]
            if l2_host is not None and len(surv):
                l2s[surv] = l2_host[work.first[i]:work.first[i] + len(surv)]
            self._feedback(sim, work.r, work.scheds[i], l2s)

    def _log_rounds(self, works) -> None:
        """The chunk's one device-to-host copy of its lane, then one round
        event a live cell and round (``TelemetrySession.round_event``),
        into the session's round log and the cell's ``round_events``.  A
        cell without a group that round gets its host fields and zeros."""
        lane = self.lane[:len(works)].cpu().numpy()
        self.stats.d2h_bytes += lane.nbytes
        for k, w in enumerate(works):
            rows = dict(zip(w.groups, lane[k]))
            for i in w.order:
                row = rows.get(i)
                if row is None:
                    row = np.zeros(LANE_WIDTH, np.float32)
                    row[:N_LANE_HOST] = self._lane_host(w, i)
                ev = self.telemetry.round_event(self._labels[i], row,
                                                w.recs[i])
                self.sims[i].acct.round_events.append(ev)
        self.telemetry.flush()

    @staticmethod
    def _lane_host(work, i) -> tuple:
        """Cell ``i``'s host fields of round ``work`` (``N_LANE_HOST``)."""
        sc = work.scheds[i]
        return (work.r, sc.t_end, len(work.plans[i].chosen),
                len(sc.fresh_rows), len(sc.landing), work.occ[i])

    def _eval(self, work) -> None:
        """The batched evaluation of the round's cells, their records'
        fill, and the accuracy-target early stops."""
        self.stats.dispatches["eval"] += 1
        acc, loss = self.data.evaluate(self.sims, self.params[:self.s],
                                       work.order)
        for k, i in enumerate(work.order):
            sim = self.sims[i]
            sim._fill_round_eval(work.recs[i], acc[k], loss[k],
                                 progress=self.progress)
            if sim._target_reached():
                sim.acct.stopped_early = True
                self.done[i] = True

    # ------------------------------------------------------------------
    # A round's index block and its device work
    # ------------------------------------------------------------------

    def _layout(self, b: Bucket) -> dict:
        """Segment -> (start, stop) of a block of bucket ``b``: sample
        indices, row cells, scatter slots, fresh and stale gather rows,
        the (fresh, valid, tau) masks, the groups' params rows, the
        attacker flags of an attacked batch, the trained rows'
        corruption multipliers (fp32 bits) of a faulted one, and at level
        2 the round's position in its chunk and its groups' lane host
        fields (fp32 bits)."""
        cfg = self.sims[0].cfg
        gn = b.groups * b.n
        sizes = (("bidx", b.rows * cfg.local_steps * cfg.local_batch),
                 ("cell", b.rows), ("scat", b.rows), ("fidx", gn),
                 ("sidx", gn), ("meta", 3 * gn), ("agg", b.groups),
                 ("att", gn if self.attack is not None else 0),
                 ("fscale", b.rows if self.faulty else 0),
                 ("lane_k", 1 if self._lane else 0),
                 ("lane_host", N_LANE_HOST * b.groups if self._lane else 0))
        out, off = {}, 0
        for name, size in sizes:
            out[name] = (off, off + size)
            off += size
        return out

    def _pack(self, work) -> np.ndarray:
        """Round ``work``'s int64 index block (``_layout``), on the final
        cache capacity of its chunk; sets its bucket, packed-row offsets,
        groups and their sizes.  Logs each cell's surviving corrupted rows
        as a ``fault`` event."""
        sims = self.sims
        bidx, cells, work.first, work.n_rows = pack_rows(
            sims, self.data, work.plans, work.order)
        groups = [i for i in work.order if work.scheds[i].fresh_rows
                  or work.scheds[i].landing]
        sizes = [len(work.scheds[i].fresh_rows) + len(work.scheds[i].landing)
                 for i in groups]
        g, n = len(groups), max(sizes, default=0)
        if self.kernel_route and g:
            g, n = bucket_block(g, G_BLOCK), bucket_block(n, N_BLOCK)
        b = Bucket(0 if cells is None else len(cells), g, n,
                   self.cache.capacity)
        work.groups, work.sizes, work.bucket = groups, sizes, b
        lay = self._layout(b)
        block = np.zeros(lay["lane_host"][1], np.int64)

        def seg(name):
            lo, hi = lay[name]
            return block[lo:hi]
        trash, scratch = self.cache.trash_slot, self.s
        if b.rows:
            seg("bidx")[:] = bidx.ravel()
            seg("cell")[:] = cells
            scat = seg("scat")
            scat[:] = trash
            for i in work.order:
                sc = work.scheds[i]
                pos = sims[i].survivors(work.plans[i])[1]
                for (row, _l, _a, _d), slot in zip(sc.new_stale, sc.slots):
                    scat[work.first[i] + pos[row]] = slot
            if self.faulty:
                fscale = seg("fscale")
                fscale[:] = _fp32_bits(1.0)
                for i in work.order:
                    fp, plan = sims[i].fault_plan, work.plans[i]
                    if fp is not None and fp.has_corruption:
                        surv = sims[i].survivors(plan)[0]
                        lo = work.first[i]
                        scale = fp.scale_for(work.r, plan.chosen)[surv]
                        fscale[lo:lo + len(surv)] = _fp32_bits(scale)
                        bad = int(np.count_nonzero(scale != 1.0))
                        if bad:
                            self.telemetry.event(
                                "fault", cell=self._labels[i],
                                round=int(work.r), corrupt_rows=bad)
        if self._lane:
            seg("lane_k")[:] = work.pos
        if not g:
            return block
        fidx = seg("fidx").reshape(g, n)
        sidx = seg("sidx").reshape(g, n)
        sidx[:] = trash
        meta = seg("meta").reshape(3, g, n)      # fresh, valid, tau
        agg = seg("agg")
        agg[:] = scratch
        att = seg("att").reshape(g, n) if self.attack is not None else None
        for k, i in enumerate(groups):
            sc, plan = work.scheds[i], work.plans[i]
            nf, size = len(sc.fresh_rows), sizes[k]
            pos = sims[i].survivors(plan)[1]
            fidx[k, :nf] = [work.first[i] + pos[row] for row in sc.fresh_rows]
            sidx[k, nf:size] = [f.delta for f in sc.landing]
            meta[0, k, :nf] = 1
            meta[1, k, :size] = 1
            meta[2, k, nf:size] = sc.landing_taus
            agg[k] = i
            if att is not None:
                att[k, :size] = sims[i].attack_flags(work.r,
                                                     agg_lids(plan, sc))
        if self._lane:
            host = np.zeros((g, N_LANE_HOST), np.float32)
            for k, i in enumerate(groups):
                host[k] = self._lane_host(work, i)
            seg("lane_host")[:] = _fp32_bits(host).ravel()
        return block

    def _views(self, b: Bucket, block) -> dict:
        """Block ``block`` of bucket ``b`` cut into its segments."""
        cfg = self.sims[0].cfg
        v = {name: block[lo:hi] for name, (lo, hi) in self._layout(b).items()}
        v["bidx"] = v["bidx"].view(b.rows, cfg.local_steps * cfg.local_batch)
        return v

    def _redirect(self, b: Bucket, block):
        """A copy of ``block`` whose every write goes to the trash slot and
        the scratch row: the warm-up round of a new graph."""
        lay, out = self._layout(b), block.clone()
        out[slice(*lay["scat"])] = self.cache.trash_slot
        out[slice(*lay["agg"])] = self.s
        return out

    def _device_round(self, r: int, work: RoundWork):
        """The round's training and server step on the device, replayed
        from its bucket's graph on the card's kernel route, else run
        eagerly; returns the survivors' l2 stats (device, packed in batch
        order; None when no learner survived)."""
        b = work.bucket
        if self.graphs is not None:
            l2 = self.graphs.run(b, work.block, self._round(b),
                                 lambda: self._redirect(b, work.block),
                                 self.stats)
        else:
            l2 = self._round(b, work)(work.block)
        return None if l2 is None else l2[:work.n_rows]

    def _round(self, b: Bucket, work: RoundWork = None):
        """The device round of bucket ``b`` as a function of its index
        block; the kernel route reads nothing else of the round, the eager
        routes read ``work``'s groups, sizes and landings."""
        def fn(block):
            v = self._views(b, block)
            deltas = l2 = None
            if b.rows:
                deltas, l2 = train_rows(self.sims, self.data, self.params,
                                        v["bidx"], v["cell"])
                if self.faulty:          # the uplink's corruption, per row
                    deltas = deltas * v["fscale"].to(torch.int32).view(
                        torch.float32)[:, None]
                # the stragglers into their slots (the rest into the trash
                # slot) before the operand gathers this round's landings
                self.cache.rows[v["scat"]] = deltas
            if b.groups:
                self._server_step(b, v, deltas, work)
            return l2
        return fn

    def _server_step(self, b: Bucket, v, deltas, work) -> None:
        """The round's (G, n, D) operand and its server step, in place on
        the groups' params rows (and YoGi state, robust and guard
        counters)."""
        cfg0 = self.sims[0].cfg
        meta = v["meta"].view(3, b.groups, b.n)
        fresh, valid = meta[0].bool(), meta[1].bool()
        tau = meta[2].to(torch.int32)
        u = self.cache.rows[v["sidx"]]
        if deltas is not None:
            u = torch.where(fresh.view(-1, 1), deltas[v["fidx"]], u)
        u = torch.where(valid.view(-1, 1), u, 0.0).view(b.groups, b.n,
                                                        self.d_pad)
        cells, rule = v["agg"], cfg0.scaling_rule
        has = valid.any(dim=1)
        if self._lane and self.attack is None:
            lane = lane_norms(u, valid, self.d)
        screened = None      # (G, 3) [rejected non-finite, norm, survivors]
        if self.kernel_route and self.guard is not None:
            # the whole padded operand at once (its true D columns), the
            # survivors as the kernels' valid mask; ``fresh`` stays
            # unmasked, as the reference passes it
            with record_function("round.screen"):
                u, valid, n_nf, n_out, _ = screen_rows(
                    u, valid, clip=self.guard[0], reject_mult=self.guard[1],
                    norm_d=self.d if self.d_pad != self.d else None)
                screened = torch.stack(
                    [n_nf, n_out, valid.sum(dim=1, dtype=torch.int32)], 1)
        if self.kernel_route:
            gate = self._note_guard(cells, has, screened)
            if self._lane:
                self._lane_write(b, v, lane, has, gate, screened, valid)
            if not self.yogi:
                old = self.params[cells]
                rows = old if gate is None else old.clone()
                saa_ops.sweep_fused_staleness_apply(
                    rows, u, fresh, tau, valid, self._scal[cells], rule=rule)
                self.params[cells] = (rows if gate is None else
                                      torch.where(gate[:, None], rows, old))
                return
            agg, _ = saa_ops.sweep_fused_staleness_aggregate(
                u, fresh, tau, self._scal[cells, 0].contiguous(), valid,
                rule=rule)
        elif self.attack is not None or self.robust is not None:
            sims, groups = self.sims, work.groups
            att = (None if self.attack is None
                   else v["att"].view(b.groups, b.n).bool())
            if self._lane and att is not None:
                lane = lane_norms(self._attacked(u, att, valid, work), valid,
                                  self.d)
            agg, counts = robust_sweep(
                u, fresh, tau, valid, att, work.sizes,
                attack=self.attack, robust=self.robust,
                betas=[sims[i].cfg.beta for i in groups],
                rule_ids=[RULE_ID[sims[i].cfg.scaling_rule] for i in groups],
                use_kernel=cfg0.use_agg_kernel,
                no_stale=[not work.scheds[i].landing for i in groups],
                guard=None if self.guard is None else self.guard[:2])
            self.robust_counts[cells] += counts[:, :2]
            gate = self._note_guard(cells, has,
                                    counts[:, 2:] if self.guard else None)
            if self._lane:
                self._lane_write(b, v, lane, has, gate,
                                 counts[:, 2:] if self.guard else None,
                                 valid, counts[:, :2])
        else:
            aggs, stats = [], []
            for k, (i, m) in enumerate(zip(work.groups, work.sizes)):
                uk, vk = u[k, :m], valid[k, :m]
                if self.guard is not None:    # each group on its own rows
                    uk, vk, n_nf, n_out, _ = screen_rows(
                        uk, vk, clip=self.guard[0],
                        reject_mult=self.guard[1])
                    stats.append(torch.stack(
                        [n_nf, n_out, vk.sum(dtype=torch.int32)]))
                aggs.append(self._plain_aggregate(
                    self.sims[i].cfg, uk, fresh[k, :m], tau[k, :m], vk,
                    not work.scheds[i].landing))
            agg = torch.stack(aggs)
            screened = torch.stack(stats) if stats else None
            gate = self._note_guard(cells, has, screened)
            if self._lane:
                self._lane_write(b, v, lane, has, gate, screened, valid)
        old = self.params[cells]
        if self.yogi:
            st = {key: s[cells] for key, s in self.opt_state.items()}
            new, st_new = yogi_apply_flat(old, agg, st)
            for key, s in st_new.items():
                if gate is not None:        # a quorum skip keeps the state
                    s = torch.where(gate.view((-1,) + (1,) * (s.dim() - 1)),
                                    s, st[key])
                self.opt_state[key][cells] = s
        else:
            new = old + self._scal[cells, 1:2] * agg
        self.params[cells] = (new if gate is None
                              else torch.where(gate[:, None], new, old))

    def _attacked(self, u, att, valid, work):
        """The operand with each group's attacker rows rewritten as the
        robust step rewrites them (``apply_attack`` on the group's own
        rows): what the server sees, which the lane's norms read."""
        kind, scale, z = self.attack
        out = u.clone()
        for g, m in enumerate(work.sizes):
            out[g, :m] = apply_attack(u[g, :m], att[g, :m], valid[g, :m],
                                      kind=kind, scale=scale, z=z)
        return out

    def _lane_write(self, b: Bucket, v, norms, has, gate, screened, valid,
                    robust=None) -> None:
        """The round's (G, LANE_WIDTH) lane rows into its slot of the
        chunk's lane buffer: the host fields from the block, the operand's
        ``norms`` (``lane_norms``), the guard's counts (``screened``:
        rejected non-finite, norm, survivors after the robust mask; None
        when unguarded, the survivors then the valid rows less the robust
        rejections), the robust counts (``robust``: rejected, trimmed) and
        whether the update was applied."""
        g = b.groups
        host = v["lane_host"].to(torch.int32).view(torch.float32).view(
            g, N_LANE_HOST)
        zero = torch.zeros(g, dtype=torch.int32, device=norms.device)
        rob = torch.stack([zero, zero], 1) if robust is None else robust
        if screened is None:
            screened = torch.stack(
                [zero, zero, valid.sum(dim=1, dtype=torch.int32) - rob[:, 0]],
                1)
        applied = has if gate is None else has & gate
        tail = torch.cat([screened[:, :2], rob, screened[:, 2:],
                          applied[:, None]], dim=1).to(torch.float32)
        self.lane[v["lane_k"], :g] = torch.cat([host, norms, tail],
                                               dim=1)[None]

    def _note_guard(self, cells, has, screened):
        """Add a round's guard counts to its groups' device counters (the
        padding groups' to the scratch row; ``finalize`` notes each cell's
        totals through the session) and return the quorum gate (G,) bool,
        or None when the guard is off."""
        if screened is None:
            return None
        gate = screened[:, 2] >= self.guard[2]
        skips = (has & ~gate).to(torch.int32)
        self.guard_counts.index_add_(
            0, cells, torch.cat([screened[:, :2], skips[:, None]], dim=1))
        return gate

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
        """Write each cell's device model (and YoGi state, robust and guard
        counters) back to its Simulator and finalize it (the session notes
        its counters, the registry's one write of them), and hand the
        graphs back for the next pipeline of this structure; returns the
        Accountings."""
        accts = []
        for i, sim in enumerate(self.sims):
            sim.flat_params = self.params[i, :self.d].clone()
            if self.yogi:
                sim.flat_opt_state = {
                    "m": self.opt_state["m"][i, :self.d].clone(),
                    "v": self.opt_state["v"][i, :self.d].clone(),
                    "t": self.opt_state["t"][i].clone()}
            sim.robust_counts = self.robust_counts[i].clone()
            sim.guard_counts = self.guard_counts[i].clone()
            accts.append(sim._finalize(self.telemetry))
        self._release()
        return accts

    def _release(self) -> None:
        """Hand the graphs and their buffers back (``graphs.release``)."""
        if self._ws is not None:
            release(self._ws)
            self._ws = self.graphs = None

    # ------------------------------------------------------------------
    # Crash-safe snapshots at chunk boundaries
    # ------------------------------------------------------------------

    def snapshot(self, r_next: int) -> dict:
        """Every cell's state as host objects, ``r_next`` the first round a
        resume runs (``repro_torch.checkpoint.state.build_resumed_pipeline``
        rebuilds the pipeline from it).  Read from the buffers the rounds
        write (the graphs' static ones on the graphed route): params and
        YoGi rows at the true D, each cell's stale-cache rows in its
        cache order (slot ids never reach a value, a resume re-seats the
        rows), and the device counters that reach the accounting only at
        ``finalize``.  Each cell's accounting carries its round log; the
        payload carries the cells' labels and the session's round-log byte
        offset, to which a resume into the same directory truncates the
        log (``TelemetrySession.restore``)."""
        d = self.d
        params = self.params[:, :d].cpu().numpy()
        opt = ({k: t.cpu().numpy() for k, t in self.opt_state.items()}
               if self.yogi else None)
        robust = self.robust_counts.cpu()
        guard = self.guard_counts.cpu()
        payload_sims = []
        for i, sim in enumerate(self.sims):
            slots = [f.delta for f in sim.stale_cache]
            rows = (self.cache.rows[torch.as_tensor(
                slots, dtype=torch.int64, device=self.device)].cpu()
                if slots else [])
            payload_sims.append({
                "cfg": dataclasses.asdict(sim.cfg),
                "state": sim.capture_state(stale_rows=rows,
                                           robust_counts=robust[i],
                                           guard_counts=guard[i]),
                "flat_params": params[i],
                "flat_opt_state": None if opt is None else {
                    "m": opt["m"][i, :d], "v": opt["v"][i, :d],
                    "t": opt["t"][i]},
                "fault_plan": sim.fault_plan})
        return {"version": 1, "kind": "pipeline", "next_round": int(r_next),
                "done": list(self.done), "sims": payload_sims,
                "cache_capacity": self.cache.capacity,
                "labels": list(self._labels),
                "telemetry": self.telemetry.state()}

    def checkpoint(self, r_next: int) -> None:
        """Write ``snapshot(r_next)`` (wrapped by ``checkpoint_wrap``) to
        ``checkpoint_path``, atomically."""
        from repro_torch.checkpoint.state import save_snapshot
        payload = self.snapshot(r_next)
        if self.checkpoint_wrap is not None:
            payload = self.checkpoint_wrap(payload)
        save_snapshot(self.checkpoint_path, payload)
