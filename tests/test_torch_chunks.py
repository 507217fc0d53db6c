"""K-round chunks (``SimConfig.rounds_per_dispatch``) of the port's fused
round pipeline, on the CPU, where every round runs eagerly on the padded
index blocks the card's CUDA graphs replay.

Contracts:

- **K chunks == K = 1, bit for bit**: summaries, every RoundRecord's
  fields by ``repr``, final params as int32 views, for Random, RELAY,
  RELAY+YoGi, SAFA and early stop at K in {2, 4, 8}; a 4-cell sweep batch
  at K in {2, 4}; an attacked coord_median batch and the plain server path
  (``use_agg_kernel=False``), which run eagerly on the card too, at K = 4.
- **Against the reference's K = 4 run** (``repro.sim`` on the CPU, from
  its initial weights): host fields of every RoundRecord ``==``, final
  params within atol 1e-5, eval loss within rtol 1e-5 and accuracy within
  one test sample (``tests/test_torch_pipeline.py``'s free-running
  tolerances), and as many chunks as the reference's
  ``stats["dispatches"]["round"]``.
- oort forces one-round chunks; chunks break at evaluation rounds.
- Two sets of bucket sizes (every shape exact, and the defaults) give the
  same bits; a one-slot cache that grows inside a chunk changes nothing.
- A new graph's warm-up block writes only the trash slot and the scratch
  row; ``graphs.RoundGraphs`` counts a replay's launches and moves the
  warm-up's aside (torch's CUDA graph API stood in for).
"""
import contextlib
import dataclasses
import functools
from collections import Counter

import numpy as np
import pytest
import torch

from repro.sim import SimConfig as JConfig
from repro.sim import Simulator as JSimulator
from repro.sim.pipeline import RoundPipeline as JRoundPipeline
from repro_torch.kernels import LAUNCHES
from repro_torch.sim import SimConfig, Simulator, Substrate
from repro_torch.sim import engine
from repro_torch.sim import graphs as tgraphs
from repro_torch.sim import pipeline as pl
from repro_torch.sweeps import SweepRunner, SweepSpec
from repro_torch.sweeps import __main__ as cli
from repro_torch.weights import from_flat

torch.set_num_threads(1)

BASE = dict(n_learners=30, rounds=12, eval_every=4, seed=2, n_target=4,
            mapping="label_uniform", use_agg_kernel=True)
RELAY = dict(selector="priority", saa=True, apt=True, scaling_rule="relay")
CONFIGS = {
    "random": dict(selector="random"),
    "relay": RELAY,
    "relay_yogi": dict(RELAY, server_opt="yogi"),
    "safa": dict(selector="safa", saa=True, staleness_threshold=2),
    "early_stop": dict(RELAY, target_accuracy=0.05),
}
EAGER = {            # the routes that run eagerly on the card too
    "coord_median_attacked": dict(
        RELAY, aggregator="coord_median", attack="collude_signflip",
        attack_frac=0.25, attack_scale=10.0),
    "plain_server_path": dict(RELAY, use_agg_kernel=False),
}
HOST = ("round_idx", "sim_time", "n_selected", "n_fresh", "n_stale",
        "resource_used", "resource_wasted", "unique_participants")
# one batch of 4 cells, stragglers under a short deadline: the saa cells
# share the stale cache
SWEEP = dict(axes={"saa": [False, True], "hardware": ["HS1", "HS3"]},
             base=dict(n_learners=30, rounds=8, eval_every=4, n_target=4,
                       mapping="label_uniform", setting="DL", deadline=15.0,
                       selector="priority", apt=True, use_agg_kernel=True),
             seeds=(0,))
_SUBSTRATES = {}


def _bits(rec):
    return tuple(repr(v) for v in dataclasses.astuple(rec))


def _host(rec):
    return tuple(getattr(rec, f) for f in HOST)


def _int_view(t):
    return t.contiguous().view(torch.int32)


def _substrate(cfg):
    key = engine.substrate_key(cfg)
    if key not in _SUBSTRATES:
        _SUBSTRATES[key] = Substrate.build(cfg)
    return _SUBSTRATES[key]


def _port(kw):
    """A fused run of ``kw`` on the CPU: (accounting, simulator, the
    pipeline's stats)."""
    cfg = SimConfig(**kw)
    sim = Simulator(cfg, _substrate(cfg), device="cpu")
    pipe = pl.RoundPipeline([sim])
    acct, = pipe.run()
    return acct, sim, pipe.stats.as_dict()


def _chunks(acct, k):
    """The chunks of k rounds (k divides eval_every) holding a round."""
    return len({r.round_idx // k for r in acct.records})


@functools.lru_cache(maxsize=None)
def _k1(name):
    return _port({**BASE, **CONFIGS.get(name, EAGER.get(name))})


def _assert_same_run(a, sim_a, b, sim_b):
    assert repr(a.summary()) == repr(b.summary())
    assert [_bits(r) for r in a.records] == [_bits(r) for r in b.records]
    assert torch.equal(_int_view(sim_a.flat_params), _int_view(sim_b.flat_params))
    if sim_a.flat_opt_state is not None:
        for k in ("m", "v", "t"):
            assert torch.equal(sim_a.flat_opt_state[k], sim_b.flat_opt_state[k])
    assert torch.equal(sim_a.robust_counts, sim_b.robust_counts)


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_chunks_equal_one_round_dispatches(name, k):
    a, sim_a, _ = _k1(name)
    b, sim_b, stats = _port({**BASE, **CONFIGS[name], "rounds_per_dispatch": k})
    _assert_same_run(a, sim_a, b, sim_b)
    assert stats["rounds_per_dispatch"] == k and not stats["graphed"]
    # chunks of min(k, 4) rounds: evaluation rounds end a chunk
    assert stats["dispatches"]["round"] == _chunks(b, min(k, 4))
    if name == "early_stop":
        assert b.stopped_early and len(b.records) < BASE["rounds"]


@pytest.mark.parametrize("name", list(EAGER))
def test_eager_routes_chunk_too(name):
    a, sim_a, _ = _k1(name)
    b, sim_b, stats = _port({**BASE, **EAGER[name], "rounds_per_dispatch": 4})
    _assert_same_run(a, sim_a, b, sim_b)
    assert stats["dispatches"]["round"] == _chunks(b, 4)
    if name == "coord_median_attacked":
        assert b.summary()["robust_trimmed"] > 0


@pytest.mark.parametrize("k", [2, 4])
def test_sweep_batch_chunks_equal_one_round_dispatches(k):
    cells = SweepSpec(**SWEEP).expand()
    chunked = [dataclasses.replace(c, config=dataclasses.replace(
        c.config, rounds_per_dispatch=k)) for c in cells]
    a = SweepRunner(cells, device="cpu", substrate_cache=_SUBSTRATES)
    b = SweepRunner(chunked, device="cpu", substrate_cache=_SUBSTRATES)
    res_a, res_b = a.run(), b.run()
    assert len(a.batches()) == 1 == len(b.batches())
    assert [st["rounds_per_dispatch"] for st in b.batch_stats] == [k]
    assert sum(r.summary["unique_participants"] for r in res_a) > 0
    assert sum(x.n_stale for r in res_a for x in r.acct.records) > 0
    for i in range(len(cells)):
        _assert_same_run(res_a[i].acct, a.sims[i], res_b[i].acct, b.sims[i])


@pytest.mark.parametrize("name", ["random", "relay", "relay_yogi"])
def test_k4_matches_reference_k4(name):
    kw = {**BASE, **CONFIGS[name], "rounds_per_dispatch": 4}
    ref_sim = JSimulator(JConfig(**kw))
    ref_pipe = JRoundPipeline([ref_sim])
    ref, = ref_pipe.run()
    cfg = SimConfig(**kw)
    sim = Simulator(cfg, Substrate.build(cfg, flat_params0=from_flat(
        ref_sim.substrate.flat_params0)), device="cpu")
    pipe = pl.RoundPipeline([sim])
    port, = pipe.run()
    assert [_host(r) for r in port.records] == [_host(r) for r in ref.records]
    assert sim.rng.bit_generator.state == ref_sim.rng.bit_generator.state
    evals = [(a, b) for a, b in zip(port.records, ref.records)
             if b.accuracy == b.accuracy]
    assert len(evals) == 3
    for a, b in evals:
        assert abs(a.accuracy - b.accuracy) <= 1.0 / len(sim.data.y_test)
        np.testing.assert_allclose(a.loss, b.loss, rtol=1e-5)
    np.testing.assert_allclose(sim.flat_params.numpy(),
                               np.asarray(ref_sim.flat_params), atol=1e-5)
    ref_stats, stats = ref_pipe.stats.as_dict(), pipe.stats.as_dict()
    assert stats["dispatches"]["round"] == ref_stats["dispatches"]["round"]
    assert stats["rounds"] == ref_stats["rounds"]
    assert stats["rounds_per_dispatch"] == ref_stats["rounds_per_dispatch"] == 4


def test_oort_forces_one_round_chunks():
    acct, _, stats = _port({**BASE, "selector": "oort", "saa": True,
                            "rounds_per_dispatch": 8})
    assert stats["rounds_per_dispatch"] == 1
    assert stats["dispatches"]["round"] == stats["rounds"] == len(acct.records)
    assert stats["feedback_fetches"] == stats["rounds"]


def test_bucket_sizes_do_not_change_results(monkeypatch):
    """Every shape exact (blocks of 1) against the default buckets, on a
    serial RELAY run at K = 4 and on the 4-cell sweep batch (padded
    groups)."""
    cells = SweepSpec(**SWEEP).expand()
    kw = {**BASE, **RELAY, "rounds_per_dispatch": 4}
    runs = []
    for blocks in ((64, 64, 8), (1, 1, 1)):
        monkeypatch.setattr(engine, "ROW_BLOCK", blocks[0])
        monkeypatch.setattr(pl, "G_BLOCK", blocks[1])
        monkeypatch.setattr(pl, "N_BLOCK", blocks[2])
        seen = Counter()
        pack = pl.RoundPipeline._pack

        def counting(self, work):
            block = pack(self, work)
            seen[work.bucket[:3] == (work.n_rows, len(work.groups),
                                     max(work.sizes, default=0))] += 1
            return block
        monkeypatch.setattr(pl.RoundPipeline, "_pack", counting)
        runner = SweepRunner(cells, device="cpu", substrate_cache=_SUBSTRATES)
        runs.append((_port(kw), runner, runner.run(), seen))
        monkeypatch.setattr(pl.RoundPipeline, "_pack", pack)
    (a, sim_a, _), run_a, res_a, seen_a = runs[0]
    (b, sim_b, _), run_b, res_b, seen_b = runs[1]
    assert seen_a[False] > 0 and seen_b[False] == 0   # padded, then exact
    _assert_same_run(a, sim_a, b, sim_b)
    for i in range(len(cells)):
        _assert_same_run(res_a[i].acct, run_a.sims[i], res_b[i].acct,
                         run_b.sims[i])


def test_cache_growth_inside_a_chunk_keeps_results(monkeypatch):
    """A one-slot cache grows while a chunk's later rounds are scheduled,
    before any of the chunk's device work has run."""
    kw = {**BASE, **RELAY, "dynamic_availability": False, "setting": "DL",
          "deadline": 15.0}
    a, sim_a, _ = _port(kw)
    cfg = SimConfig(**kw, rounds_per_dispatch=4, stale_cache_capacity=1)
    sim_b = Simulator(cfg, _substrate(cfg), device="cpu")
    pipe = pl.RoundPipeline([sim_b])
    scheduled, grown_at = [], []
    schedule, grow = pipe._schedule, pipe.cache._grow

    def scheduling(r):
        scheduled.append(r)
        return schedule(r)

    def growing():
        grown_at.append(scheduled[-1])
        grow()
    monkeypatch.setattr(pipe, "_schedule", scheduling)
    monkeypatch.setattr(pipe.cache, "_grow", growing)
    b, = pipe.run()
    assert any(r % 4 for r in grown_at)     # not a chunk's first round
    assert pipe.stats.as_dict()["dispatches"]["cache_grow"] == len(grown_at)
    _assert_same_run(a, sim_a, b, sim_b)


def test_warmup_block_writes_only_trash_and_scratch():
    """A new graph's warm-up runs the round on a block whose every write
    goes to the trash slot and the scratch row: run eagerly here, it leaves
    every cell's params and every data slot of the cache as they were."""
    cells = SweepSpec(**SWEEP).expand()
    sims = [Simulator(c.config, _substrate(c.config), device="cpu")
            for c in cells]
    pipe = pl.RoundPipeline(sims)
    for sim in sims:
        sim._t_now = 0.0
    for r in range(SWEEP["base"]["rounds"]):
        works = pipe._run_chunk([r])
        if works and works[0].bucket.rows and works[0].bucket.groups:
            break
    w = works[0]
    params, rows = pipe.params.clone(), pipe.cache.rows.clone()
    pipe._round(w.bucket)(pipe._redirect(w.bucket, w.block))
    s, trash = pipe.s, pipe.cache.trash_slot
    assert torch.equal(pipe.params[:s], params[:s])
    assert torch.equal(pipe.cache.rows[:trash], rows[:trash])
    assert not torch.equal(pipe.params[s], params[s])


class _Stream:
    def wait_stream(self, other):
        pass


class _Graph:
    def __init__(self):
        self.replays = 0

    def capture_begin(self, pool):
        self.pool = pool

    def capture_end(self):
        pass

    def replay(self):
        self.replays += 1


def test_round_graphs_count_replayed_launches(monkeypatch):
    """One capture (a warm-up, then the capture) and three replays: the
    path counts three launches per kernel and variant key, the warm-up's
    one goes to the run's ``warmup_launches``, the capture's call counts
    nowhere.  A released ``RoundGraphs`` serves the next run of its
    structure, which replays without capturing."""
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    LAUNCHES.clear()
    LAUNCHES["other"] = 5
    calls = []

    def fn(block):
        calls.append(block.clone())
        LAUNCHES["k"] += 1
        LAUNCHES["k:cluster"] += 1
        return block * 2
    structure = ("cuda", 1, 12835)
    g = tgraphs.RoundGraphs("cuda", structure, {"params": torch.zeros(3)})
    key = tgraphs.Bucket(16, 1, 16, 64)
    stats = pl.PipelineStats()
    for step in range(3):
        block = torch.full((4,), step)
        out = g.run(key, block, fn, lambda: torch.full((4,), -1), stats)
        assert torch.equal(g._graphs[key].block, block)
    assert len(calls) == 2 and all((c == -1).all() for c in calls)
    assert torch.equal(out, torch.full((4,), -2))   # captured output
    assert dict(LAUNCHES) == {"other": 5, "k": 3, "k:cluster": 3}
    assert dict(stats.warmup_launches) == {"k": 1, "k:cluster": 1}
    assert (stats.graph_captures, stats.graph_replays,
            g._graphs[key].graph.replays) == (1, 3, 3)
    # the next run of the structure: no capture, its own counts
    tgraphs.release(g)
    assert tgraphs.acquire(("cuda", 2, 12835)) is None
    again = tgraphs.acquire(structure)
    assert again is g and tgraphs.acquire(structure) is None
    stats = pl.PipelineStats()
    again.run(key, torch.full((4,), 7), fn, lambda: 1 / 0, stats)
    assert (len(calls), stats.graph_captures, stats.graph_replays) == (2, 0, 1)
    assert dict(LAUNCHES) == {"other": 5, "k": 4, "k:cluster": 4}
    # a capacity's rows tensor is kept, and refilled
    rows = again.cache_rows(torch.ones((65, 8)))
    assert again.cache_rows(torch.full((65, 8), 2.0)) is rows
    assert (rows == 2).all() and again.cache_rows(torch.ones((129, 8))) is not rows
    LAUNCHES.clear()


def test_cli_runs_chunked_batches_against_serial_k1(capsys):
    cli.main(["--smoke", "--device", "cpu", "--rounds-per-dispatch", "2"])
    assert "per-cell metrics equal" in capsys.readouterr().out
