"""Participant-axis sharding: the 2-D round mesh of ranks and row placement
(port of ``repro.sim.participant_sharding`` onto ``torch.distributed``).

The reference runs one program over a 2-D device mesh; the port runs one
process per shard (SPMD over several controllers).  The round mesh is a
grid of the default process group's ranks with axes ``("s", "p")``:

  ``"s"`` — the sweep axis.  Cells are placed in balanced contiguous
      blocks over it (``repro_torch.sweeps.sharding.Placement``); each
      s-shard runs its own cells' server steps, with no cross-cell
      communication;
  ``"p"`` — the participant axis.  Each round's packed cohort rows (of an
      s-shard's cells) split into balanced contiguous blocks over it
      (``split_balanced``): every p-shard trains its block of rows and
      holds the stale-cache slots of the stragglers it trained.

Flat shard id ``f = j * n_p + q`` (s-major, the reference's ``cache_spec``
and ``chunk_spec`` layout) is the rank.  The p-groups are the grid's rows
(ranks ``j * n_p .. j * n_p + n_p - 1``), the s-groups its columns (ranks
``q, n_p + q, ...``); they are explicit ``torch.distributed.new_group``s
(with local synchronization), not a ``DeviceMesh``, because ranks that
share one card under gloo would not map onto a device mesh's one device a
rank.  Each rank names its device itself.

Which rank holds what (the reference's four ``NamedSharding`` specs):

- cell params, YoGi state and per-cell counters: the rows of its s-block's
  cells, replicated along "p" — every p-rank applies the identical server
  step after the round's reduction, so the replicas stay bitwise equal;
- stale-cache rows: its own flat shard's slot space
  (``core.stale_cache.ShardedSlotAccounts``);
- the round's index block: its own training rows, its own cache slots,
  its own columns of the aggregation operand (the ownership mask), and its
  s-block's group metadata, replicated along "p";
- datasets and test sets: replicated on every rank.

The host state machine (plans, schedules, selection, slot accounts,
records) is replicated, not communicated: nothing in it reads an update
value, so every rank takes every decision alike.  The round's one
collective is the sum over "p" of the masked aggregation operand
(``repro_torch.sim.pipeline``).

Without a process group there is one shard: ``participant_mesh`` clamps
its request to the ranks there are, as the reference clamps to the local
devices, so a plain process runs the sharded code path at ``n_p = 1``.
``run_ranks`` spawns a group of ranks on one host (the tests and
``chip_smoke.py`` use it).
"""
from __future__ import annotations

import datetime
import pickle
import queue as queue_mod
import socket
import time
import traceback

import torch
import torch.distributed as dist

SWEEP_AXIS = "s"
PART_AXIS = "p"

_GROUPS: dict = {}       # (world group, ranks) -> its process group


def _world() -> tuple:
    """(size, rank, backend) of the default process group; (1, 0, None)
    when none is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), dist.get_backend()
    return 1, 0, None


def n_ranks() -> int:
    """Ranks of the default process group (1 without one): what a mesh
    request is clamped to, as the reference clamps to its local devices."""
    return _world()[0]


def _group(ranks: list):
    """The process group of ``ranks`` (the default group when they are all
    of its ranks), made once a default group."""
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    key = (id(dist.group.WORLD), tuple(ranks))
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(ranks, use_local_synchronization=True)
    return _GROUPS[key]


class RoundMesh:
    """The ``(n_sweep, n_participant)`` grid over ranks ``0 ..
    n_sweep * n_participant - 1`` of the default process group, seen from
    this rank: its flat shard ``rank``, its ``s_index`` and ``p_index``,
    and the groups of its row (``p_group``), column (``s_group``) and the
    whole grid (``group``).

    A group is None where nothing is exchanged: everywhere without a
    process group, ``s_group`` on an s-axis of one shard and ``group`` on
    a grid of one rank.  ``p_group`` exists whenever a process group
    does, one rank included, so the round's reduction is the same call on
    a one-rank group as on a larger one."""

    def __init__(self, n_sweep: int = 1, n_participant: int = 1):
        world, rank, backend = _world()
        need = n_sweep * n_participant
        if n_sweep < 1 or n_participant < 1:
            raise ValueError("mesh axes must have at least one shard")
        if need > world:
            raise ValueError(f"round_mesh needs {n_sweep} x {n_participant} "
                             f"= {need} ranks, have {world}")
        if rank >= need:
            raise ValueError(f"rank {rank} is outside the {n_sweep} x "
                             f"{n_participant} round mesh")
        self.n_s, self.n_p = int(n_sweep), int(n_participant)
        self.rank = rank
        self.s_index, self.p_index = divmod(rank, self.n_p)
        self.backend = backend
        self.p_group = self.s_group = self.group = None
        if backend is not None:
            j, q = self.s_index, self.p_index
            self.p_group = _group(list(range(j * self.n_p, (j + 1) * self.n_p)))
            if self.n_s > 1:
                self.s_group = _group(list(range(q, need, self.n_p)))
            if need > 1:
                self.group = _group(list(range(need)))

    @property
    def shape(self) -> dict:
        return {SWEEP_AXIS: self.n_s, PART_AXIS: self.n_p}

    @property
    def size(self) -> int:
        return self.n_s * self.n_p

    @property
    def graphable(self) -> bool:
        """Whether a round holding the reduction can be captured in a CUDA
        graph: NCCL's collectives can, gloo's cannot (gloo stages a CUDA
        tensor through the host)."""
        return self.backend in (None, "nccl")


def round_mesh(n_sweep: int = 1, n_participant: int = 1) -> RoundMesh:
    """2-D ``("s", "p")`` mesh over ``n_sweep * n_participant`` ranks."""
    return RoundMesh(n_sweep, n_participant)


def participant_mesh(n_participant=True) -> RoundMesh:
    """Participant-only round mesh (``n_s = 1``) for single simulations.

    ``n_participant=True`` takes every rank of the default group; an int
    takes that many, clamped to the ranks there are (one without a process
    group), so a config asking for 4-way sharding still runs on one."""
    world = n_ranks()
    n_p = world if n_participant is True else min(int(n_participant), world)
    return RoundMesh(1, max(n_p, 1))


def as_round_mesh(mesh) -> RoundMesh:
    """Normalize an accepted mesh into a ``RoundMesh``: a ``RoundMesh`` as
    is, or a ``{"s": n_s, "p": n_p}`` shape (either key may be missing,
    meaning one shard), built over the default group's ranks."""
    if isinstance(mesh, RoundMesh):
        return mesh
    if isinstance(mesh, dict) and set(mesh) <= {SWEEP_AXIS, PART_AXIS}:
        return RoundMesh(int(mesh.get(SWEEP_AXIS, 1)),
                         int(mesh.get(PART_AXIS, 1)))
    raise ValueError(f"expected a RoundMesh or an {{'s': n, 'p': n}} shape, "
                     f"got {mesh!r}")


def split_balanced(n: int, parts: int) -> list:
    """Balanced contiguous split sizes: ``parts`` blocks covering ``n`` rows,
    sizes differing by at most one (larger blocks first) — the participant
    analogue of ``Placement.build``'s cell split."""
    return [n // parts + (1 if j < n % parts else 0) for j in range(parts)]


def all_gather(t: torch.Tensor, group) -> list:
    """Every rank's ``t`` in ``group``, in group-rank order (``[t]`` when
    ``group`` is None).  Pure data movement."""
    if group is None:
        return [t]
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


# ---------------------------------------------------------------------------
# A group of ranks on one host
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, backend, timeout, fn, args, out):
    try:
        torch.set_num_threads(1)
        if backend == "nccl":            # NCCL wants the rank's card first
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        # by value: a tensor put on the queue as is would be shared through
        # a descriptor this rank's exit closes
        out.put((rank, True, pickle.dumps(result)))
    except BaseException:            # the parent reports it and stops the rest
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, *args, backend: str = "gloo",
              timeout: float = 120.0) -> list:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes joined into
    one ``backend`` process group over ``tcp://127.0.0.1`` (each NCCL
    rank on card ``rank % device_count``); returns the ranks' results in
    rank order.  Each rank runs one thread of torch's CPU ops.  ``fn`` and its results must pickle.
    The group's collectives time out after ``timeout`` seconds, and the
    whole run is given twice that: a rank that fails, or a run past its
    limit, stops every rank and raises ``RuntimeError``, so a rank that
    raises never leaves its peers waiting in a collective."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, port, backend, timeout, fn, args,
                               out))
             for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + 2 * timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"ranks timed out after {2 * timeout:.0f} "
                                   f"s; done: {sorted(results)}")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in results]
                if dead and out.empty():
                    time.sleep(0.5)
                    if out.empty():
                        raise RuntimeError(f"rank(s) {dead} exited without a "
                                           "result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = pickle.loads(value)
    finally:
        for p in procs:
            if p.is_alive() and len(results) < world:
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]
