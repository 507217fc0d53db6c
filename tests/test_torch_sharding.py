"""Participant-axis sharding (``repro_torch.sim.participant_sharding``, the
sharded round of ``repro_torch.sim.pipeline``) held against the port's
unsharded run and against the reference.

- Host structures against the reference's own functions: the balanced
  split, ``Placement``, ``local_capacity``, ``ShardedSlotAccounts``' slot
  discipline and growth, and the mesh builders' clamp.
- One rank, in this process (no process group: the sharded code path at
  n_p = 1): port sharded == port unsharded bit for bit, and against the
  reference's ``shard_participants=True`` on its one CPU device, host
  records and ``cross_shard_landings`` ``==``, params within the pipeline
  tests' atol 1e-5.
- Gloo on the CPU in spawned ranks (``run_ranks``) at n_p = 2, 3 and 4:
  every rank's summary, records and params bit for bit the unsharded run's
  (batched training equals serial training bitwise on the CPU, and the
  reduction's -0.0 fill keeps every operand bit), one ``all_reduce`` a
  round that aggregates and none in an unsharded run, stragglers landing
  across p-shards.
- The errors: the flag never dropped silently, and ``shard_hints``'
  identity, state and raise.

Each spawned group runs its cases in one go (a rank pays its torch import
once); a group's collectives time out after 60 s, and a failing rank stops
the others.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import _shard_cases as C
from repro.core.stale_cache import ShardedSlotAccounts as JAccounts
from repro.sim import SimConfig as JConfig
from repro.sim import Simulator as JSimulator
from repro.sim.participant_sharding import split_balanced as jsplit
from repro.sim.pipeline import RoundPipeline as JPipeline
from repro.sweeps.sharding import Placement as JPlacement
from repro.sweeps.sharding import local_capacity as jlocal_capacity
from repro_torch.core.stale_cache import ShardedSlotAccounts
from repro_torch.models import shard_hints
from repro_torch.sim import SimConfig, Simulator, Substrate
from repro_torch.sim.participant_sharding import (RoundMesh, as_round_mesh,
                                                  participant_mesh,
                                                  round_mesh, run_ranks,
                                                  split_balanced)
from repro_torch.sim.pipeline import RoundPipeline
from repro_torch.sweeps import SweepRunner, SweepSpec
from repro_torch.sweeps.sharding import (Placement, local_capacity,
                                         reshard_rows)
from repro_torch.weights import from_flat

torch.set_num_threads(1)

BASE = C.BASE
STRAGGLER = dict(n_learners=60, rounds=16, eval_every=4, n_target=8,
                 mapping="label_uniform", selector="priority", saa=True)
CASES = {
    "random": dict(BASE, selector="random", deadline=60.0, seed=1),
    "priority": dict(BASE, selector="priority", saa=True, deadline=60.0),
    "safa": dict(BASE, selector="safa", saa=True, seed=2),
    "oort": dict(BASE, selector="oort", saa=True, seed=1),
    "yogi_apt": dict(BASE, selector="priority", saa=True, apt=True,
                     aggregator="yogi", seed=1),
    "threshold": dict(BASE, selector="safa", saa=True, staleness_threshold=1),
    "kernel_route": dict(BASE, selector="priority", saa=True,
                         use_agg_kernel=True),
    "kernel_yogi": dict(BASE, selector="priority", saa=True, apt=True,
                        use_agg_kernel=True, server_opt="yogi"),
    "chunked": dict(BASE, selector="priority", saa=True,
                    rounds_per_dispatch=4),
    "early_stop": dict(BASE, selector="priority", saa=True,
                       target_accuracy=0.15),
    "straggler": STRAGGLER,
    "trimmed_kernel": dict(BASE, selector="priority", saa=True,
                           aggregator="trimmed_mean", use_agg_kernel=True,
                           dynamic_availability=False),
    "attacked_guard": dict(BASE, selector="priority", saa=True,
                           aggregator="coord_median",
                           attack="collude_signflip", guard=True,
                           dynamic_availability=False),
    "telemetry": dict(BASE, selector="priority", saa=True, telemetry=2,
                      rounds_per_dispatch=4),
}
INDIVISIBLE = dict(BASE, selector="priority", saa=True, n_target=5)
N1000 = dict(selector="priority", saa=True, n_target=16, n_learners=1000,
             rounds=4, eval_every=2, mapping="label_uniform")
# the cases each spawned group runs: n_p -> case names
GROUPS = {2: list(CASES),
          3: ["priority", "oort", "kernel_yogi", "early_stop", "indivisible",
              "n1000"],
          4: ["straggler", "chunked", "attacked_guard", "unsharded"]}
ALL = {**CASES, "indivisible": INDIVISIBLE, "n1000": N1000,
       "unsharded": CASES["priority"]}


@functools.lru_cache(maxsize=None)
def unsharded(name):
    """The port's unsharded run of case ``name`` in this process."""
    sim = Simulator(SimConfig(**ALL[name]), device="cpu")
    pipe = RoundPipeline([sim])
    acct = pipe.run()[0]
    return C._sim_result(pipe, sim, acct, 0)


@functools.lru_cache(maxsize=None)
def gloo_group(n_p):
    """Every case of ``GROUPS[n_p]`` run by n_p spawned gloo ranks."""
    cases = [(ALL[name], 0 if name == "unsharded" else True, None)
             for name in GROUPS[n_p]]
    per_rank = run_ranks(C.run_sims, n_p, cases, timeout=60)
    return {name: [rank[k] for rank in per_rank]
            for k, name in enumerate(GROUPS[n_p])}


def assert_bitwise(got, want):
    assert got["summary"] == want["summary"]
    assert C.same_records(got["records"], want["records"])
    assert np.array_equal(C.bits(got["params"]), C.bits(want["params"]))
    if want["opt"] is not None:
        for k in ("m", "v"):
            assert np.array_equal(C.bits(got["opt"][k]),
                                  C.bits(want["opt"][k]))
        assert got["opt"]["t"] == want["opt"]["t"]


# ---------------------------------------------------------------------------
# Host structures against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("parts", [1, 2, 3, 4, 7])
def test_split_balanced_matches_reference(parts):
    for n in (0, 1, 2, 5, 16, 17, 63, 1000):
        got = split_balanced(n, parts)
        assert got == jsplit(n, parts)
        assert sum(got) == n and max(got) - min(got) <= 1


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_placement_and_capacity_match_reference(n_shards):
    for cells in (range(10), range(1), [7], [0, 3, 5, 9, 11], range(64)):
        got, want = Placement.build(cells, n_shards), JPlacement.build(
            cells, n_shards)
        assert (got.s_loc, got.shard_of, got.slot_of, got.shards) == \
            (want.s_loc, want.shard_of, want.slot_of, want.shards)
        assert [got.flat_row(i) for i in cells] == \
            [want.flat_row(i) for i in cells]
        assert got.scratch_flat(n_shards - 1) == \
            want.scratch_flat(n_shards - 1)
        assert local_capacity(len(cells), n_shards) == \
            jlocal_capacity(len(cells), n_shards)


def test_sharded_slot_accounts_discipline():
    acc = ShardedSlotAccounts(2, capacity=2)
    s0, grew = acc.alloc(0, 2)
    assert s0 == [0, 1] and not grew
    s1, _ = acc.alloc(1, 1)                 # shard 1's space is its own
    assert s1 == [0]
    assert acc.shard_len(0) == 2 and acc.shard_len(1) == 1
    s2, grew = acc.alloc(0, 1)              # growth doubles every shard
    assert grew and acc.capacity == 4 and s2 == [2]
    assert acc.trash_slot == 4
    acc.free(0, [1])                        # LIFO reuse within a shard
    assert acc.alloc(0, 1)[0] == [1]
    with pytest.raises(KeyError):
        acc.free(0, [0, 0])
    assert acc.flat_index(1, 3) == 1 * (acc.capacity + 1) + 3
    acc.reserve(16)
    assert acc.capacity == 16 and acc.occupied(1) == [0]


def test_sharded_slot_accounts_growth_preserves_ids():
    acc = ShardedSlotAccounts(3, capacity=1)
    assert [acc.alloc(j, 1)[0][0] for j in range(3)] == [0, 0, 0]
    acc.alloc(0, 2)
    assert acc.capacity == 4
    assert acc.occupied(0) == [0, 1, 2] and acc.occupied(1) == [0]


def test_sharded_slot_accounts_match_reference_on_a_random_walk():
    rng = np.random.default_rng(0)
    got, want = ShardedSlotAccounts(4, 2), JAccounts(4, 2)
    held = {j: [] for j in range(4)}
    for _ in range(400):
        j = int(rng.integers(4))
        if held[j] and rng.random() < 0.45:
            k = int(rng.integers(1, len(held[j]) + 1))
            free = [held[j].pop(int(rng.integers(len(held[j]))))
                    for _ in range(k)]
            got.free(j, free)
            want.free(j, free)
        else:
            k = int(rng.integers(1, 4))
            a, b = got.alloc(j, k), want.alloc(j, k)
            assert a == b
            held[j] += a[0]
        assert got.capacity == want.capacity and len(got) == len(want)
        assert [got.occupied(x) for x in range(4)] == \
            [want.occupied(x) for x in range(4)]
    assert got.grow_events == want.grow_events > 0


def test_mesh_builders_clamp_to_the_ranks_there_are():
    """Without a process group there is one rank: a request clamps to it
    (the reference clamps to its local devices), a grid that needs more
    raises."""
    for n in (True, 1, 4):
        mesh = participant_mesh(n)
        assert mesh.shape == {"s": 1, "p": 1} and mesh.rank == 0
        assert mesh.p_group is None and mesh.s_group is None
        assert mesh.graphable
    assert round_mesh().size == 1
    with pytest.raises(ValueError):
        round_mesh(2, 1)
    with pytest.raises(ValueError):
        RoundMesh(1, 0)
    assert as_round_mesh({"s": 1}).shape == {"s": 1, "p": 1}
    mesh = participant_mesh(2)
    assert as_round_mesh(mesh) is mesh
    with pytest.raises(ValueError):
        as_round_mesh(object())


def test_reshard_rows_is_row_movement():
    local = torch.arange(12, dtype=torch.float32).view(4, 3)
    out = reshard_rows(local, [3, 0, 0, 2], None)
    assert torch.equal(out, local[[3, 0, 0, 2]])
    assert out.data_ptr() != local.data_ptr()


# ---------------------------------------------------------------------------
# One rank, in this process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["priority", "oort", "kernel_yogi",
                                  "chunked", "straggler", "attacked_guard",
                                  "telemetry"])
def test_one_rank_sharded_equals_unsharded(name):
    """``shard_participants=4`` in a plain process is the sharded code path
    at n_p = 1 (the request clamped, as in the reference): bit for bit the
    unsharded run, and no collective."""
    sim = Simulator(SimConfig(**ALL[name], shard_participants=4),
                    device="cpu")
    pipe = RoundPipeline([sim])
    assert pipe.mesh is not None and pipe.mesh.shape == {"s": 1, "p": 1}
    with C.CountAllReduce() as c:
        acct = pipe.run()[0]
    assert_bitwise(C._sim_result(pipe, sim, acct, 0), unsharded(name))
    assert c.calls == 0 and not pipe.stats.collectives
    assert pipe.stats.as_dict()["n_pshards"] == 1


@pytest.mark.parametrize("name", ["priority", "straggler", "kernel_route"])
def test_one_rank_sharded_matches_reference(name):
    """Against the reference's ``shard_participants=True`` on its one CPU
    device, from its initial weights: host records and
    ``cross_shard_landings`` ``==``, params within atol 1e-5."""
    kw = ALL[name]
    ref_sim = JSimulator(JConfig(**kw, shard_participants=True))
    ref_pipe = JPipeline([ref_sim])
    ref = ref_pipe.run()[0]
    cfg = SimConfig(**kw, shard_participants=True)
    sim = Simulator(cfg, Substrate.build(cfg, flat_params0=from_flat(
        ref_sim.substrate.flat_params0)), device="cpu")
    pipe = RoundPipeline([sim])
    port = pipe.run()[0]
    host = lambda recs: [dataclasses.astuple(r)[:8] for r in recs]
    assert host(port.records) == host(ref.records)
    assert pipe.stats.cross_shard_landings == \
        ref_pipe.stats.cross_shard_landings
    np.testing.assert_allclose(sim.flat_params.numpy(),
                               np.asarray(ref_sim.flat_params), atol=1e-5)


# ---------------------------------------------------------------------------
# Gloo ranks on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_p,name", [(n_p, name) for n_p, names in
                                      GROUPS.items() for name in names])
def test_gloo_sharded_equals_unsharded(n_p, name):
    """Every rank of an n_p-rank gloo group ends with the unsharded run's
    summary, records and params (and YoGi state), bit for bit."""
    for got in gloo_group(n_p)[name]:
        assert_bitwise(got, unsharded(name))
        assert got["stats"]["n_pshards"] == (1 if name == "unsharded"
                                             else n_p)


@pytest.mark.parametrize("n_p", list(GROUPS))
def test_one_all_reduce_per_aggregating_round(n_p):
    """A rank calls ``all_reduce`` exactly once a round that aggregates
    (its stats count the same), and an unsharded run in the same group
    none; the other collectives are the feedback selector's gathers."""
    for name, ranks in gloo_group(n_p).items():
        for got in ranks:
            coll = got["stats"]["collectives"]
            if name == "unsharded":
                assert got["all_reduce_calls"] == 0 and not coll
                continue
            assert got["all_reduce_calls"] == got["aggregated"] > 0
            assert coll["all_reduce"] == got["aggregated"]
            assert set(coll) <= {"all_reduce", "feedback"}
            assert ("feedback" in coll) == (ALL[name]["selector"] == "oort")


def test_stragglers_land_across_p_shards():
    """A straggler's row stays on the p-shard that trained it; rounds
    later its cell's rows lie elsewhere, and the landing crosses shards
    through the reduction: counted on every rank, the same count."""
    for n_p in (2, 4):
        ranks = gloo_group(n_p)["straggler"]
        assert sum(r[4] for r in ranks[0]["records"]) > 0
        got = {r["stats"]["cross_shard_landings"] for r in ranks}
        assert len(got) == 1 and got.pop() >= 1


# ---------------------------------------------------------------------------
# Errors, never a silent fallback
# ---------------------------------------------------------------------------


def test_shard_participants_never_silently_dropped():
    """The per-stage and legacy substrates have no sharded round, and an
    explicit mesh with the config's flag is ambiguous: each raises the
    reference's ValueError."""
    with pytest.raises(ValueError):
        Simulator(SimConfig(shard_participants=2, fused_rounds=False,
                            **BASE), device="cpu").run()
    with pytest.raises(ValueError):
        Simulator(SimConfig(shard_participants=2, fast_path=False, **BASE),
                  device="cpu").run()
    with pytest.raises(ValueError):
        RoundPipeline([Simulator(SimConfig(shard_participants=2, **BASE),
                                 device="cpu")], mesh=participant_mesh(True))


def test_runner_rejects_bad_composition():
    cells = SweepSpec(axes={"saa": [False, True]}, base=BASE,
                      seeds=(0,)).expand()
    with pytest.raises(ValueError):
        SweepRunner(cells, device="cpu", shard=True, shard_participants=True)
    flat = [dataclasses.replace(c, config=dataclasses.replace(
        c.config, fused_rounds=False)) for c in cells]
    with pytest.raises(ValueError):
        SweepRunner(flat, device="cpu", shard=True)


def test_shard_hints_identity_state_and_raise():
    x = torch.ones(2, 3, 4)
    assert shard_hints.constrain_activations(x) is x
    assert shard_hints.constrain_expert_dim(x, 1) is x
    with shard_hints.hints(batch_axes=("data",), model_axis="model"):
        assert shard_hints._STATE == {"batch_axes": ("data",),
                                      "model_axis": "model"}
        with pytest.raises(NotImplementedError,
                           match=r"ROADMAP\.md queue 1 item 15\)"):
            shard_hints.constrain_activations(x)
        with pytest.raises(NotImplementedError,
                           match=r"ROADMAP\.md queue 1 item 15\)"):
            shard_hints.constrain_expert_dim(x, 1)
    assert shard_hints._STATE == {"batch_axes": None, "model_axis": None}
    shard_hints.configure(model_axis="model")
    try:
        assert shard_hints.constrain_activations(x) is x
    finally:
        shard_hints.reset()
    assert shard_hints._STATE == {"batch_axes": None, "model_axis": None}
