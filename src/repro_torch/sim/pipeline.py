"""Device-resident round pipeline for S >= 1 lockstep simulations, in
K-round chunks, optionally sharded over a round mesh of ranks (port of
``repro.sim.pipeline``).

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

Sharding (``mesh=``, or ``SimConfig.shard_participants``): one process a
shard of a ``("s", "p")`` round mesh of ranks
(``repro_torch.sim.participant_sharding``).  Every rank runs every cell's
host stages; then

  sweep axis "s": the cells are placed in balanced contiguous blocks
  (``repro_torch.sweeps.sharding.Placement``), and a rank holds and steps
  only its block's params, YoGi rows and counters (rows ``slot``, its
  scratch row the last);
  participant axis "p": each s-block's packed survivor rows split into
  balanced contiguous blocks (``split_balanced``; ``RoundWork.rowq``), and
  a rank trains only its own, scatters its stragglers into its own slot
  space of the sharded cache (``ShardedSlotAccounts``, a slot a
  ``(flat shard, slot)`` pair) and gathers only the operand columns it
  owns: a fresh column whose row it trained, a landing whose slot it
  holds.  Its other columns take ``-0.0`` and ONE ``all_reduce(SUM)`` over
  its p-group rebuilds the operand.  ``x + (-0.0)`` is ``x`` for every
  fp32 ``x``, signed zeros included, so the reduced operand is bitwise
  the unsharded gather in any summation order (the reference fills with
  ``+0.0``, which turns an owned ``-0.0`` into ``+0.0``); the invalid
  columns then take ``+0.0`` as on the unsharded route.  Everything after
  the reduction (attack, lane, screen, weights, kernels 1, 2 or 7, the
  apply) runs identically on the p-group's ranks.

That reduction is the round's one collective (``stats.collectives``
counts every collective by kind).  The others come at chunk boundaries
and are pure data movement: ``eval`` (an all-gather of the s-blocks'
accuracies), ``feedback`` (of the trained rows' l2 stats, for a
``needs_feedback`` selector), ``lane`` (level 2's lane rows), ``repack``
(rows moving between s-ranks when early stops shrink the placement),
``snapshot`` and ``finalize`` (params, YoGi state, counters, and for a
snapshot the cache rows); every rank enters them in the same order.  A
one-rank s-axis or grid exchanges nothing; the round's reduction is made
on any process group, a one-rank one included; without a process group
nothing is exchanged at all.  A rank's tensors keep their first shape through a
repack (the live cells move, in place), so a graphed round reads the
buffers its graphs were captured on.  Rounds are graphed under NCCL (a
one-rank group included: the reduction is captured in the graph) and
run eagerly under gloo, which cannot be captured.  After ``finalize``
every rank's Simulators hold every cell's params.
"""
from __future__ import annotations

import dataclasses
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.core.aggregation import (bucket_block, flat_dim,
                                          no_stale_aggregate, screen_rows,
                                          weights_and_aggregate_by_id,
                                          yogi_apply_flat, yogi_init_flat)
from repro_torch.core.stale_cache import (DeviceStaleCache,
                                          ShardedSlotAccounts)
from repro_torch.core.staleness import RULE_ID
from repro_torch.faults import InjectedCrash, attack_key, apply_attack
from repro_torch.kernels.staleness_agg import ops as saa_ops
from repro_torch.kernels.staleness_agg.ref import row_order_sum
from repro_torch.learners import model_key
from repro_torch.robust import robust_key
from repro_torch.robust.aggregators import robust_sweep
from repro_torch.selection.registry import selector_key
from repro_torch.sim.engine import (ROW_BLOCK, SharedData, _InFlight,
                                   agg_lids, pack_rows, train_rows)
from repro_torch.sim.graphs import (Bucket, RoundGraphs, acquire, release,
                                   upload)
from repro_torch.sim.participant_sharding import (all_gather, as_round_mesh,
                                                  participant_mesh,
                                                  split_balanced)
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
    ``warmup_launches``; so are ``collectives`` (a ``Counter`` by kind:
    ``all_reduce``, the round's, one a round that aggregates on this
    rank's s-block; ``eval``, ``feedback``, ``lane``, ``repack``,
    ``snapshot``, ``finalize``) and the mesh's ``n_shards`` ("s") and
    ``n_pshards`` ("p").  ``cross_shard_landings`` counts the landings
    whose slot lies on another p-shard than some other column of its
    group: operand rows the reduction really merges across ranks."""

    GUARD_KEYS = tuple(k[len("guard_"):] for k in GUARD_COUNTERS)

    rounds = _registry_counter("rounds")
    h2d_bytes = _registry_counter("h2d_bytes")
    d2h_bytes = _registry_counter("d2h_bytes")
    init_h2d_bytes = _registry_counter("init_h2d_bytes")
    cross_shard_landings = _registry_counter("cross_shard_landings")
    feedback_fetches = _registry_counter("feedback_fetches")

    def __init__(self, registry: MetricsRegistry = None,
                 rounds_per_dispatch: int = 1, graphed: bool = False,
                 n_shards: int = 1, n_pshards: int = 1):
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
        self.collectives = Counter()
        self.n_shards, self.n_pshards = n_shards, n_pshards

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
                "warmup_launches": dict(self.warmup_launches),
                "n_shards": self.n_shards, "n_pshards": self.n_pshards,
                "collectives": dict(self.collectives)}


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
    # sharded: (cell, plan row) -> (p-shard, local row) of every survivor,
    # the trained rows of each flat shard, and each s-shard's groups
    rowq: dict = None
    shard_rows: list = None
    shard_groups: list = None


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
                 labels=None, mesh=None):
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
        # the round mesh (None: unsharded); an explicit mesh and the
        # config's flag together are ambiguous, as in the reference
        if mesh is not None and cfg0.shard_participants:
            raise ValueError(
                "ambiguous participant sharding: an explicit mesh was passed "
                "while SimConfig.shard_participants is set; configure one or "
                "the other (SweepRunner callers: use "
                "SweepRunner(shard_participants=))")
        if mesh is None and cfg0.shard_participants:
            mesh = participant_mesh(cfg0.shard_participants)
        self.mesh = mesh = None if mesh is None else as_round_mesh(mesh)
        if mesh is None:
            self.placement, self.accounts = None, None
            mine, slot = range(s), (lambda i: i)
            self.scratch = s
        else:
            from repro_torch.sweeps.sharding import Placement
            self.placement = Placement.build(range(s), mesh.n_s)
            mine = self.placement.shards[mesh.s_index]
            slot = self.placement.slot_of.__getitem__
            self.scratch = self.placement.s_loc
            self._saved = {}       # early-stopped cells' rows after a repack
        rows = self.scratch + 1
        # (rows, d_pad): a row a cell of this rank's block (every cell
        # unsharded), then the scratch row that padding groups read and
        # write; the kernels' (S, D) params operand
        self.params = torch.zeros((rows, self.d_pad), dtype=torch.float32,
                                  device=dev)
        for i in mine:
            self.params[slot(i), :self.d] = sims[i].flat_params
        capacity = max(sim.cfg.stale_cache_capacity for sim in sims)
        # this rank's cache rows; sharded, every shard's slot accounts
        self.cache = DeviceStaleCache(self.d_pad, capacity=capacity,
                                      device=dev)
        if mesh is not None:
            self.accounts = ShardedSlotAccounts(mesh.size, capacity)
        self.yogi = cfg0.server_opt == "yogi"
        if self.yogi:
            # each cell's YoGi state (a resumed run's restored one), the
            # other rows a fresh state
            st = yogi_init_flat(self.d, device=dev, width=self.d_pad)
            self.opt_state = {"m": st["m"].repeat(rows, 1),
                              "v": st["v"].repeat(rows, 1),
                              "t": torch.zeros(rows, dtype=torch.int32,
                                               device=dev)}
            for i in mine:
                for k in ("m", "v"):
                    self.opt_state[k][slot(i), :self.d] = \
                        sims[i].flat_opt_state[k]
                self.opt_state["t"][slot(i)] = sims[i].flat_opt_state["t"]
        else:
            self.opt_state = None
        # per-cell (beta, server_lr) rows, the other rows a copy of cell
        # 0's: the kernel's scal operand
        self._scal = torch.tensor(self._scal_rows(rows, mine, slot),
                                  dtype=torch.float32, device=dev)
        # device counters, from each cell's own (a resumed run's restored
        # ones): robust [rejected, trimmed]; guard [rejected non-finite,
        # rejected norm, quorum skips]; padding groups add to the scratch
        # row
        self.robust_counts = torch.zeros((rows, 2), dtype=torch.int32,
                                         device=dev)
        self.guard_counts = torch.zeros((rows, 3), dtype=torch.int32,
                                        device=dev)
        for i in mine:
            self.robust_counts[slot(i)] = sims[i].robust_counts
            self.guard_counts[slot(i)] = sims[i].guard_counts
        self.data = SharedData(sims, dev)
        self.fetch_l2s = sims[0]._sel_spec.needs_feedback
        # a feedback selector's stats are device data the next round's
        # selection reads: its batch runs one-round chunks
        self.k_rounds = (1 if self.fetch_l2s
                         else max(1, int(cfg0.rounds_per_dispatch)))
        graphed = (dev.type == "cuda" and self.kernel_route
                   and (mesh is None or mesh.graphable))
        self.stats = PipelineStats(
            self.telemetry.registry, rounds_per_dispatch=self.k_rounds,
            graphed=graphed, n_shards=1 if mesh is None else mesh.n_s,
            n_pshards=1 if mesh is None else mesh.n_p)
        self.stats.init_h2d_bytes += self.params.numel() * 4 + sum(
            t.numel() * t.element_size() for t in (
                self.data.x_train, self.data.y_train,
                *(a for pair in self.data.tests for a in pair)))
        # the lane: a (G, LANE_WIDTH) fp32 row block a round, each round's
        # at its position in the chunk, copied to the host once a chunk
        self.lane = (torch.zeros(
            (self.k_rounds, bucket_block(self.scratch, G_BLOCK)
             if self.kernel_route else self.scratch, LANE_WIDTH),
            dtype=torch.float32, device=dev) if self._lane else None)
        # the buffers the graphs read, and the graphs (None: eager rounds)
        self._ws = self._workspace(cfg0) if graphed else None
        self.graphs = self._ws
        self.done = [False] * s
        self._pending_free = []   # freed slots quarantined for one round

    def _scal_rows(self, rows: int, cells, slot) -> list:
        """(beta, server_lr) of each of ``rows`` params rows: cell ``i``'s
        at ``slot(i)`` for ``i`` in ``cells``, cell 0's elsewhere."""
        out = [[self.sims[0].cfg.beta, self.sims[0].cfg.server_lr]] * rows
        for i in cells:
            out[slot(i)] = [self.sims[i].cfg.beta, self.sims[i].cfg.server_lr]
        return out

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
        # a sharded round's graphs hold its p-group's reduction
        mesh = self.mesh
        shard = None if mesh is None else (mesh.n_s, mesh.n_p, mesh.rank,
                                           id(mesh.p_group))
        key = (str(self.device), self.s, shard, self.d, self.d_pad, self.yogi,
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
        if self.mesh is not None:
            self._maybe_repack()
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
        capacity = self.cache.capacity
        rowq = shard_rows = None
        if self.mesh is None:
            if self._pending_free:
                self.cache.free(self._pending_free)
            self._pending_free = _quarantine_frees(order, scheds)
            for i in order:
                if scheds[i].new_stale:
                    scheds[i].slots = self.cache.alloc(
                        len(scheds[i].new_stale))
        else:
            rowq, shard_rows = self._place_rows(order, plans)
            self._alloc_sharded(order, scheds, rowq)
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
        return RoundWork(r, order, plans, scheds, recs, occ, rowq=rowq,
                         shard_rows=shard_rows)

    def _place_rows(self, order, plans) -> tuple:
        """The round's participant-row placement: each s-shard's packed
        survivor rows (its cells in batch order, each cell's survivors in
        plan order, as the unsharded packing) split into balanced
        contiguous blocks over the p-shards.  Returns ((cell, plan row) ->
        (p-shard, local row), each flat shard's rows in local order)."""
        mesh, shard_of = self.mesh, self.placement.shard_of
        rowq, shard_rows = {}, []
        for j in range(mesh.n_s):
            rows_j = [(i, int(row)) for i in order if shard_of[i] == j
                      for row in self.sims[i].survivors(plans[i])[0]]
            off = 0
            for q, size in enumerate(split_balanced(len(rows_j), mesh.n_p)):
                block = rows_j[off:off + size]
                for loc, key in enumerate(block):
                    rowq[key] = (q, loc)
                shard_rows.append(block)
                off += size
        return rowq, shard_rows

    def _alloc_sharded(self, order, scheds, rowq) -> None:
        """Free the previous round's quarantined slots, quarantine this
        round's, and give each new straggler a slot on the flat shard that
        trains its row this round (later rounds gather it there, wherever
        its cell's rows are then); a grown capacity grows this rank's
        rows."""
        acc, n_p = self.accounts, self.mesh.n_p
        for flat, slot in self._pending_free:
            acc.free(flat, [slot])
        self._pending_free = _quarantine_frees(order, scheds)
        for i in order:
            sc, j = scheds[i], self.placement.shard_of[i]
            sc.slots = []
            for row, _l, _a, _d in sc.new_stale:
                flat = j * n_p + rowq[(i, int(row))][0]
                sc.slots.append((flat, acc.alloc(flat, 1)[0][0]))
        self.cache.reserve(acc.capacity)

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
        mesh = self.mesh
        if l2 is not None and mesh is not None:
            # every rank's trained rows, (flat shard, local row)
            if mesh.group is not None:
                self.stats.collectives["feedback"] += 1
            l2 = torch.stack(all_gather(l2, mesh.group))
        l2_host = None if l2 is None else l2.cpu().numpy()
        for i in work.order:
            sim, plan = self.sims[i], work.plans[i]
            l2s = np.zeros(plan.k, np.float32)      # by plan row
            surv = sim.survivors(plan)[0]
            if l2_host is not None and len(surv):
                if mesh is None:
                    lo = work.first[i]
                    l2s[surv] = l2_host[lo:lo + len(surv)]
                else:
                    j = self.placement.shard_of[i] * mesh.n_p
                    at = [work.rowq[(i, int(row))] for row in surv]
                    l2s[surv] = l2_host[[j + q for q, _ in at],
                                        [loc for _, loc in at]]
            self._feedback(sim, work.r, work.scheds[i], l2s)

    def _log_rounds(self, works) -> None:
        """The chunk's one device-to-host copy of its lane, then one round
        event a live cell and round (``TelemetrySession.round_event``),
        into the session's round log and the cell's ``round_events``.  A
        cell without a group that round gets its host fields and zeros."""
        lane = self.lane[:len(works)]
        mesh = self.mesh
        if mesh is not None and mesh.s_group is not None:
            # the other s-blocks' groups' rows come from their ranks
            self.stats.collectives["lane"] += 1
            lanes = [t.cpu().numpy() for t in all_gather(lane, mesh.s_group)]
        else:
            lanes = [lane.cpu().numpy()]
        self.stats.d2h_bytes += sum(t.nbytes for t in lanes)
        for k, w in enumerate(works):
            rows = {}
            for j, groups in enumerate(w.shard_groups or [w.groups]):
                rows.update(zip(groups, lanes[j if len(lanes) > 1 else 0][k]))
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
        if self.mesh is None:
            acc, loss = self.data.evaluate(self.sims, self.params[:self.s],
                                           work.order)
        else:
            acc, loss = self._eval_sharded(work.order)
        for k, i in enumerate(work.order):
            sim = self.sims[i]
            sim._fill_round_eval(work.recs[i], acc[k], loss[k],
                                 progress=self.progress)
            if sim._target_reached():
                sim.acct.stopped_early = True
                self.done[i] = True

    def _eval_sharded(self, order) -> tuple:
        """(accuracy, loss) host arrays of ``order``: each s-rank evaluates
        its block's cells (the unsharded call on those cells), then the
        s-group's all-gather brings every block's values to every rank."""
        mesh, pl, dev = self.mesh, self.placement, self.device
        mine = [i for i in order if pl.shard_of[i] == mesh.s_index]
        both = None
        if mine:
            rows = self.params[torch.as_tensor(
                [pl.slot_of.get(i, self.scratch) for i in range(self.s)],
                device=dev)]
            acc, loss = self.data.evaluate(self.sims, rows, mine)
            both = torch.zeros((2, self.s), dtype=torch.float64)
            both[:, mine] = torch.as_tensor(np.stack([acc, loss]),
                                            dtype=torch.float64)
            dtype = acc.dtype
        if mesh.s_group is None:
            return acc, loss
        # float64 staging holds the fp32 values exactly
        self.stats.collectives["eval"] += 1
        if both is None:
            both = torch.zeros((2, self.s), dtype=torch.float64)
            dtype = np.float32
        blocks = all_gather(both.to(dev), mesh.s_group)
        host = torch.stack(blocks).cpu().numpy()
        pick = [pl.shard_of[i] for i in order]
        return (host[pick, 0, order].astype(dtype),
                host[pick, 1, order].astype(dtype))

    # ------------------------------------------------------------------
    # A round's index block and its device work
    # ------------------------------------------------------------------

    def _layout(self, b: Bucket) -> dict:
        """Segment -> (start, stop) of a block of bucket ``b``: sample
        indices, row cells, scatter slots, fresh and stale gather rows,
        the (fresh, valid, tau) masks, the groups' params rows, a sharded
        round's ownership mask of the operand's columns, the attacker
        flags of an attacked batch, the trained rows'
        corruption multipliers (fp32 bits) of a faulted one, and at level
        2 the round's position in its chunk and its groups' lane host
        fields (fp32 bits)."""
        cfg = self.sims[0].cfg
        gn = b.groups * b.n
        sizes = (("bidx", b.rows * cfg.local_steps * cfg.local_batch),
                 ("cell", b.rows), ("scat", b.rows), ("fidx", gn),
                 ("sidx", gn), ("meta", 3 * gn), ("agg", b.groups),
                 ("own", gn if self.mesh is not None else 0),
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
        if self.mesh is not None:
            return self._pack_sharded(work)
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
        trash = self.cache.trash_slot
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
        if g:
            def columns(k, i, sc, fidx, sidx, own):
                pos = sims[i].survivors(work.plans[i])[1]
                nf = len(sc.fresh_rows)
                fidx[k, :nf] = [work.first[i] + pos[row]
                                for row in sc.fresh_rows]
                sidx[k, nf:nf + len(sc.landing)] = [f.delta
                                                    for f in sc.landing]
            self._pack_groups(work, seg, g, n, lambda i: i, columns)
        return block

    def _pack_groups(self, work, seg, g, n, row_of, columns) -> None:
        """The group segments of round ``work``'s block (``g`` x ``n``
        padded): the (fresh, valid, tau) masks, each group's params row
        (``row_of(cell)``; padding groups the scratch row), the attacker
        flags and the lane's host fields; ``columns(k, cell, sched, fidx,
        sidx, own)`` writes group k's gather columns (``own`` None
        unsharded).  A padding column gathers the trash slot."""
        fidx = seg("fidx").reshape(g, n)
        sidx = seg("sidx").reshape(g, n)
        sidx[:] = self.cache.trash_slot
        own = seg("own").reshape(g, n) if self.mesh is not None else None
        meta = seg("meta").reshape(3, g, n)      # fresh, valid, tau
        agg = seg("agg")
        agg[:] = self.scratch
        att = seg("att").reshape(g, n) if self.attack is not None else None
        for k, (i, size) in enumerate(zip(work.groups, work.sizes)):
            sc, plan = work.scheds[i], work.plans[i]
            nf = len(sc.fresh_rows)
            columns(k, i, sc, fidx, sidx, own)
            meta[0, k, :nf] = 1
            meta[1, k, :size] = 1
            meta[2, k, nf:size] = sc.landing_taus
            agg[k] = row_of(i)
            if att is not None:
                att[k, :size] = self.sims[i].attack_flags(work.r,
                                                          agg_lids(plan, sc))
        if self._lane:
            host = np.zeros((g, N_LANE_HOST), np.float32)
            for k, i in enumerate(work.groups):
                host[k] = self._lane_host(work, i)
            seg("lane_host")[:] = _fp32_bits(host).ravel()

    def _pack_sharded(self, work) -> np.ndarray:
        """This rank's index block of round ``work`` (``_layout``): its
        flat shard's training rows (padded to the bucket of the round's
        largest shard, so every rank's round has one shape), their scatter
        slots in its own slot space, and its s-block's groups with the
        gather columns it owns (``own``); the group metadata is the same
        on every p-rank.  Counts the cross-shard landings and logs every
        cell's ``fault`` events, as the unsharded round does."""
        sims, mesh, pl = self.sims, self.mesh, self.placement
        me, q, n_p = mesh.rank, mesh.p_index, mesh.n_p
        mine = work.shard_rows[me]
        r_max = max(len(rows) for rows in work.shard_rows)
        r_b = bucket_block(r_max, ROW_BLOCK) if r_max else 0
        work.n_rows = len(mine)
        work.shard_groups = [
            [i for i in work.order if pl.shard_of[i] == j
             and (work.scheds[i].fresh_rows or work.scheds[i].landing)]
            for j in range(mesh.n_s)]
        groups = work.shard_groups[mesh.s_index]
        sizes = [len(work.scheds[i].fresh_rows) + len(work.scheds[i].landing)
                 for i in groups]
        g, n = len(groups), max(sizes, default=0)
        if self.kernel_route and g:
            g, n = bucket_block(g, G_BLOCK), bucket_block(n, N_BLOCK)
        b = Bucket(r_b, g, n, self.cache.capacity)
        work.groups, work.sizes, work.bucket = groups, sizes, b
        self._count_cross_shard(work)
        lay = self._layout(b)
        block = np.zeros(lay["lane_host"][1], np.int64)

        def seg(name):
            lo, hi = lay[name]
            return block[lo:hi]
        trash, scratch = self.cache.trash_slot, self.scratch
        if r_b:
            bidx, cell = seg("bidx").reshape(r_b, -1), seg("cell")
            cell[:] = scratch      # a rank with no row trains discarded rows
            for loc, (i, row) in enumerate(mine):
                bidx[loc] = work.plans[i].bidx[row] + self.data.row_off[i]
                cell[loc] = pl.slot_of[i]
            if mine:                               # padding repeats row 0
                bidx[len(mine):], cell[len(mine):] = bidx[0], cell[0]
            scat = seg("scat")
            scat[:] = trash
            for i in work.order:
                sc = work.scheds[i]
                for (row, _l, _a, _d), (flat, slot) in zip(sc.new_stale,
                                                           sc.slots):
                    if flat == me:
                        scat[work.rowq[(i, int(row))][1]] = slot
            if self.faulty:
                seg("fscale")[:] = _fp32_bits(1.0)
        for i in work.order:
            fp, plan = sims[i].fault_plan, work.plans[i]
            if not (self.faulty and fp is not None and fp.has_corruption):
                continue
            surv = sims[i].survivors(plan)[0]
            scale = fp.scale_for(work.r, plan.chosen)
            for row in surv:
                qq, loc = work.rowq[(i, int(row))]
                if pl.shard_of[i] * n_p + qq == me:
                    seg("fscale")[loc] = _fp32_bits(scale[row])
            bad = int(np.count_nonzero(scale[surv] != 1.0))
            if bad:
                self.telemetry.event("fault", cell=self._labels[i],
                                     round=int(work.r), corrupt_rows=bad)
        if self._lane:
            seg("lane_k")[:] = work.pos
        if g:
            def columns(k, i, sc, fidx, sidx, own):
                for col, row in enumerate(sc.fresh_rows):
                    qq, loc = work.rowq[(i, int(row))]
                    if qq == q:
                        fidx[k, col], own[k, col] = loc, 1
                for col, f in enumerate(sc.landing, len(sc.fresh_rows)):
                    if f.delta[0] == me:
                        sidx[k, col], own[k, col] = f.delta[1], 1
            self._pack_groups(work, seg, g, n, pl.slot_of.__getitem__,
                              columns)
        return block

    def _count_cross_shard(self, work) -> None:
        """Landings whose slot lies on another p-shard than some other
        column of its group (the reference's diagnostic): rows the round's
        reduction really merges across ranks.  Every rank counts every
        group."""
        n_p = self.mesh.n_p
        for i in work.order:
            sc = work.scheds[i]
            if not sc.landing:
                continue
            col_q = ([work.rowq[(i, int(row))][0] for row in sc.fresh_rows]
                     + [f.delta[0] % n_p for f in sc.landing])
            self.stats.cross_shard_landings += sum(
                1 for f in sc.landing
                if any(qc != f.delta[0] % n_p for qc in col_q))

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
        out[slice(*lay["agg"])] = self.scratch
        return out

    def _device_round(self, r: int, work: RoundWork):
        """The round's training and server step on the device, replayed
        from its bucket's graph on the card's kernel route, else run
        eagerly; returns the survivors' l2 stats (device, packed in batch
        order; None when no learner survived).  Sharded: this rank's
        padded rows' stats (None on every rank when no learner survived),
        and the round's reduction counted."""
        b = work.bucket
        if self.graphs is not None:
            l2 = self.graphs.run(b, work.block, self._round(b),
                                 lambda: self._redirect(b, work.block),
                                 self.stats)
        else:
            l2 = self._round(b, work)(work.block)
        if self.mesh is None:
            return None if l2 is None else l2[:work.n_rows]
        if b.groups and self.mesh.p_group is not None:
            self.stats.collectives["all_reduce"] += 1
        return l2           # this rank's rows, padded as every rank's

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
        if self.mesh is not None:
            # the columns this rank does not own take -0.0, the identity
            # of fp32 addition (signed zeros included), so the sum over
            # the p-group is bitwise the unsharded gather
            u = torch.where(v["own"].view(-1, 1).bool(), u, -0.0)
            if self.mesh.p_group is not None:
                dist.all_reduce(u, group=self.mesh.p_group)
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
        Accountings.  Sharded, every rank's Simulators get every cell's
        rows (``_cell_rows``)."""
        accts, d = [], self.d
        rows = self._cell_rows("finalize")
        for i, sim in enumerate(self.sims):
            sim.flat_params = rows["params"][i][:d].clone()
            if self.yogi:
                sim.flat_opt_state = {"m": rows["m"][i][:d].clone(),
                                      "v": rows["v"][i][:d].clone(),
                                      "t": rows["t"][i].clone()}
            sim.robust_counts = rows["robust"][i].clone()
            sim.guard_counts = rows["guard"][i].clone()
            accts.append(sim._finalize(self.telemetry))
        self._release()
        return accts

    def _row_state(self) -> dict:
        """The per-cell device rows, by name: params, robust and guard
        counters, and the YoGi state."""
        return {"params": self.params, "robust": self.robust_counts,
                "guard": self.guard_counts, **(self.opt_state or {})}

    def _cell_rows(self, kind: str) -> dict:
        """name -> {cell: its row} over every cell of the batch.
        Sharded, each state tensor's blocks come from the s-group's
        all-gather (one collective of ``kind`` a tensor), and the cells a
        repack evicted from their saved rows."""
        state = self._row_state()
        if self.mesh is None:
            return {k: {i: t[i] for i in range(self.s)}
                    for k, t in state.items()}
        pl, group = self.placement, self.mesh.s_group
        out = {}
        for name, t in state.items():
            if group is not None:
                self.stats.collectives[kind] += 1
            blocks = all_gather(t, group)
            out[name] = {i: blocks[j][pl.slot_of[i]]
                         for i, j in pl.shard_of.items()}
            for i, saved in self._saved.items():
                out[name][i] = saved[name]
        return out

    # ------------------------------------------------------------------
    # Shard-aware repacking: early-stopped cells leave the placement, live
    # cells compact across s-shards
    # ------------------------------------------------------------------

    def _maybe_repack(self) -> None:
        """After a chunk: when the live cells' bucketed per-shard capacity
        has dropped, repack them (the reference's trigger)."""
        from repro_torch.sweeps.sharding import Placement
        live = [i for i in range(self.s) if not self.done[i]]
        if not live:
            return
        new_pl = Placement.build(live, self.mesh.n_s)
        if new_pl.s_loc >= self.placement.s_loc:
            return
        with self.telemetry.span("repack", live=len(live)):
            self._repack(new_pl, live)

    def _repack(self, new_pl, live) -> None:
        """Move every live cell's rows to its place in ``new_pl`` and
        every in-flight straggler's cache row to a slot on its cell's new
        s-shard (on the same p-shard, so the participant partition
        survives), saving the early-stopped cells' rows first.  Pure row
        movement between the s-group's ranks (``reshard_rows``), written
        in place: each tensor keeps its shape, so a graphed round still
        reads the buffers its graphs hold."""
        from repro_torch.sweeps.sharding import reshard_rows
        old_pl, mesh = self.placement, self.mesh
        j, n_p, group = mesh.s_index, mesh.n_p, mesh.s_group
        rows = self.scratch + 1
        self.stats.dispatches["repack"] += 1

        # 1. params, YoGi rows and counters: this shard's new block (a row
        #    no live cell takes keeps its content), then the evicted cells
        def flat(pl, i):
            return pl.shard_of[i] * rows + pl.slot_of[i]
        pmap = np.arange(mesh.n_s * rows)
        for i in live:
            pmap[flat(new_pl, i)] = flat(old_pl, i)
        evict = [i for i in old_pl.shard_of if self.done[i]]
        idx = np.concatenate([pmap[j * rows:(j + 1) * rows],
                              [flat(old_pl, i) for i in evict]])
        for name, t in self._row_state().items():
            if group is not None:
                self.stats.collectives["repack"] += 1
            out = reshard_rows(t, idx, group)
            t.copy_(out[:rows])
            for k, i in enumerate(evict):
                self._saved.setdefault(i, {})[name] = out[rows + k].clone()
        cells = new_pl.shards[j]
        self._scal.copy_(torch.tensor(
            self._scal_rows(rows, cells, new_pl.slot_of.__getitem__),
            dtype=torch.float32))

        # 2. the cache: fresh accounts, every live entry a slot on its
        #    cell's new s-shard (allocation may grow the capacity), then
        #    this rank's rows gathered from the s-group's blocks
        old_rows = self.accounts.capacity + 1
        acc = ShardedSlotAccounts(mesh.size, capacity=self.accounts.capacity)
        moves = []                      # (new slot, old row in the group)
        for i in live:
            shard = new_pl.shard_of[i]
            for f in self.sims[i].stale_cache:
                old_flat, old_slot = f.delta
                new_flat = shard * n_p + old_flat % n_p
                slot = acc.alloc(new_flat, 1)[0][0]
                f.delta = (new_flat, slot)
                if new_flat == mesh.rank:
                    moves.append((slot, (old_flat // n_p) * old_rows
                                  + old_slot))
        cmap = np.full(acc.capacity + 1, j * old_rows + old_rows - 1)
        for slot, old in moves:
            cmap[slot] = old
        if group is not None:
            self.stats.collectives["repack"] += 1
        moved = reshard_rows(self.cache.rows, cmap, group)
        if acc.capacity != self.cache.capacity:
            self.stats.dispatches["cache_grow"] += 1
            self.cache.reserve(acc.capacity)
            if self._ws is not None:
                self.cache.rows = self._ws.cache_rows(self.cache.rows)
        self.cache.rows.copy_(moved)
        self.accounts = acc
        self._pending_free = []   # the old slot ids mean nothing now
        self.placement = new_pl

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
        log (``TelemetrySession.restore``).

        Sharded, every rank takes part (the s-group's gathers of the rows,
        the grid's gather of the cache rows; collectives of kind
        ``snapshot``) and gets the same payload, which also names each
        stale row's flat shard (``stale_shards``) and the mesh's shape;
        rank 0 alone writes it (``checkpoint``)."""
        d, mesh = self.d, self.mesh
        rows = {k: {i: t.to("cpu", copy=True) for i, t in by_cell.items()}
                for k, by_cell in self._cell_rows("snapshot").items()}
        if mesh is None:
            row = lambda slot: self.cache.rows[slot]
        else:
            if mesh.group is not None:
                self.stats.collectives["snapshot"] += 1
            caches = all_gather(self.cache.rows, mesh.group)
            row = lambda slot: caches[slot[0]][slot[1]]
        payload_sims = []
        for i, sim in enumerate(self.sims):
            stale = [row(f.delta).cpu() for f in sim.stale_cache]
            payload_sims.append({
                "cfg": dataclasses.asdict(sim.cfg),
                "state": sim.capture_state(
                    stale_rows=torch.stack(stale) if stale else [],
                    robust_counts=rows["robust"][i],
                    guard_counts=rows["guard"][i]),
                "flat_params": rows["params"][i][:d].numpy(),
                "flat_opt_state": None if not self.yogi else {
                    "m": rows["m"][i][:d].numpy(),
                    "v": rows["v"][i][:d].numpy(),
                    "t": rows["t"][i].numpy()},
                "fault_plan": sim.fault_plan,
                **({} if mesh is None else {
                    "stale_shards": [f.delta[0] for f in sim.stale_cache]})})
        return {"version": 1, "kind": "pipeline", "next_round": int(r_next),
                "done": list(self.done), "sims": payload_sims,
                "cache_capacity": self.cache.capacity,
                "mesh": None if mesh is None else (mesh.n_s, mesh.n_p),
                "labels": list(self._labels),
                "telemetry": self.telemetry.state()}

    def checkpoint(self, r_next: int) -> None:
        """Write ``snapshot(r_next)`` (wrapped by ``checkpoint_wrap``) to
        ``checkpoint_path``, atomically; sharded, every rank builds it and
        rank 0 writes it."""
        from repro_torch.checkpoint.state import save_snapshot
        payload = self.snapshot(r_next)
        if self.checkpoint_wrap is not None:
            payload = self.checkpoint_wrap(payload)
        if self.mesh is None or self.mesh.rank == 0:
            save_snapshot(self.checkpoint_path, payload)
