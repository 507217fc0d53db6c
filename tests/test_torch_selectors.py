"""The selector zoo in the port (``repro_torch.selection``, the engine's
SAFA round end, the fused pipeline's feedback fetch) against the JAX
package on the CPU.

Contracts:

- **Policies.**  Every registered selector's ``select`` / ``select_ids`` /
  ``update_feedback`` is ``==`` the reference's, driven with the same
  ``np.random.Generator`` state, the same views and the same feedback
  sequence; the generators end in the same state.  FLIPS's label
  histograms and k-means assignment on one substrate are ``==`` too.
- **Spec surface.**  The table's names and order, each spec's
  ``needs_feedback`` / ``select_all`` / knobs, ``selector_key`` and
  ``describe_selectors`` equal the reference's.
- **Simulations.**  For ``safa``, ``oort``, ``ucb``, ``contribution`` and
  ``flips``, the port's fused pipeline on the CPU against the reference's
  fused run from the reference's initial weights: host fields of every
  RoundRecord ``==`` (selection, fresh/stale split, SAFA's round end,
  landings, accounting), the generators' final states ``==``; final params
  within atol 1e-5, eval loss within rtol 1e-5 and accuracy within one test
  sample, as ``tests/test_torch_pipeline.py`` holds a free run.  The
  feedback selectors decide from floats, so the port's pipeline is fed the
  reference's per-row l2 stats (decisions then compare exactly), and its
  own l2 stats are held to the reference's separately, at rtol 1e-4 (each
  package's own local training, summed in other orders).
- **Port fused == port flat**, bit for bit (records, params), for every
  new selector, with and without the SAA kernels' wrappers.
"""
import copy
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro import selection as jsel
from repro.selection import flips as jflips
from repro.sim import SimConfig as JConfig
from repro.sim import Simulator as JSimulator
from repro_torch import selection as sel
from repro_torch.selection import flips
from repro_torch.sim import SimConfig, Simulator, Substrate
from repro_torch.sim.engine import substrate_key
from repro_torch.sim.pipeline import RoundPipeline
from repro_torch.weights import from_flat

torch.set_num_threads(1)

HOST = ("round_idx", "sim_time", "n_selected", "n_fresh", "n_stale",
        "resource_used", "resource_wasted", "unique_participants")
NEW = ("safa", "oort", "ucb", "contribution", "flips")
FEEDBACK = ("oort", "ucb", "contribution")
# every learner available (no trace dropouts), a deadline that leaves
# stragglers: each selector chooses among ~25 learners a round and stale
# rows land
BASE = dict(n_learners=30, rounds=8, eval_every=4, seed=2, n_target=4,
            mapping="label_uniform", saa=True, use_agg_kernel=True,
            dynamic_availability=False, setting="DL", deadline=15.0)
CELLS = {
    **{s: dict(selector=s) for s in NEW},
    # SAFA on the default OC setting (the select_all round end replaces OC's)
    "safa_oc": dict(selector="safa", setting="OC"),
    # the paper's SAFA cell (benchmarks/figures.py fig07) at 30 learners:
    # staleness threshold 5, the reference's 688 Mbit model, ratio 0.1
    "safa_fig07": dict(selector="safa", staleness_threshold=5, deadline=100.0,
                       safa_target_ratio=0.10, model_mbits=688.0,
                       dynamic_availability=True),
}


def _host(rec):
    return tuple(getattr(rec, f) for f in HOST)


def _bits(rec):
    return tuple(repr(v) for v in dataclasses.astuple(rec))


# ---------------------------------------------------------------------------
# Policies, driven directly
# ---------------------------------------------------------------------------


def _views(cls, rng, ids):
    """Views of learners ``ids`` with seeded availability and durations
    (a few ties), built from ``cls`` (either package's LearnerView)."""
    probs = np.round(rng.uniform(0, 1, len(ids)), 1)
    durs = np.round(rng.uniform(20, 200, len(ids)), 0)
    return [cls(int(lid), availability_prob=float(p), est_duration=float(d))
            for lid, p, d in zip(ids, probs, durs)]


@functools.lru_cache(maxsize=None)
def _substrates(seed):
    """Both packages' substrates of 40 learners (label_uniform) at ``seed``."""
    kw = dict(n_learners=40, seed=seed, mapping="label_uniform")
    return JSimulator(JConfig(**kw)).substrate, Substrate.build(SimConfig(**kw))


def _flips_pair(seed=0):
    """Both packages' FLIPS selectors built on one substrate's shards."""
    kw = dict(n_learners=40, seed=seed, mapping="label_uniform", selector="flips")
    j_sub, t_sub = _substrates(seed)
    return (jsel.build_selector(JConfig(**kw), substrate=j_sub),
            sel.build_selector(SimConfig(**kw), substrate=t_sub))


def _pair(name, seed):
    if name == "flips":
        return _flips_pair(seed)
    cfg = SimConfig(selector=name)
    return (jsel.SELECTOR_TABLE[name].build(JConfig(selector=name)),
            sel.SELECTOR_TABLE[name].build(cfg))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", list(jsel.SELECTOR_TABLE))
def test_policy_equals_reference(name, seed):
    """30 rounds of selection on checked-in subsets of 40 learners, each
    round followed by seeded feedback for the chosen learners; the port's
    policy picks what the reference's picks, round by round, from the same
    generator state."""
    ref, port = _pair(name, seed)
    world = np.random.default_rng(100 + seed)
    rng_j, rng_t = np.random.default_rng(seed), np.random.default_rng(seed)
    for r in range(30):
        ids = np.sort(world.choice(40, size=int(world.integers(1, 40)),
                                   replace=False))
        n_target = int(world.integers(1, 12))
        state = world.bit_generator.state
        vj = _views(jsel.LearnerView, world, ids)
        world.bit_generator.state = state
        vt = _views(sel.LearnerView, world, ids)
        if port.needs_views:
            got_j = ref.select(r, vj, n_target, rng_j)
            got_t = port.select(r, vt, n_target, rng_t)
        else:
            assert not ref.needs_views
            got_j = ref.select_ids(r, ids, n_target, rng_j)
            got_t = port.select_ids(r, ids, n_target, rng_t)
        assert [int(x) for x in got_t] == [int(x) for x in got_j]
        assert rng_t.bit_generator.state == rng_j.bit_generator.state
        for lid in got_j:
            fb = dict(stat_util=float(world.uniform(0, 50)),
                      duration=float(world.uniform(20, 200)), round_idx=r)
            ref.update_feedback(int(lid), **fb)
            port.update_feedback(int(lid), **fb)
    # the view-taking policies agree through select() too, on the same views
    if not port.needs_views and name != "flips":
        ref, port = _pair(name, seed)
        vj = _views(jsel.LearnerView, np.random.default_rng(seed), range(20))
        vt = _views(sel.LearnerView, np.random.default_rng(seed), range(20))
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        assert [int(x) for x in port.select(0, vt, 5, b)] == \
            [int(x) for x in ref.select(0, vj, 5, a)]


def test_policy_state_deep_copies():
    """Selector state is plain attributes (the reference snapshots it)."""
    for name in sel.SELECTOR_TABLE:
        _, port = _pair(name, 0)
        assert copy.deepcopy(port).__dict__.keys() == port.__dict__.keys()


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("k, iters", [(4, 8), (3, 2), (7, 8)])
def test_flips_histograms_and_kmeans_equal_reference(seed, k, iters):
    j_sub, t_sub = _substrates(seed)
    h_j = jflips.label_histograms(j_sub.data)
    h_t = flips.label_histograms(t_sub.data)
    assert h_t.dtype == h_j.dtype and np.array_equal(h_t, h_j)
    assert np.array_equal(flips.kmeans_labels(h_t, k, seed, iters),
                          jflips.kmeans_labels(h_j, k, seed, iters))


@pytest.mark.parametrize("sizes, n_target", [
    ([5, 5, 5, 5], 10), ([1, 9, 3], 7), ([2, 2], 9), ([12], 4), ([3, 1, 0, 6], 5)])
def test_flips_quotas_equal_reference(sizes, n_target):
    assert flips.FlipsSelector(np.zeros(1)).quotas(sizes, n_target) == \
        jflips.FlipsSelector(np.zeros(1)).quotas(sizes, n_target)


def test_flips_token_adapter_names_its_roadmap_item():
    """The token adapter (ROADMAP.md queue 1 item 2) is ported: a token
    dataset's top-k unigram histograms == the reference's, and
    ``learner_histograms`` dispatches on the dataset's kind."""
    from repro.sim import partition as jpart
    from repro_torch.sim import partition as tpart
    j_data = jpart.make_token_dataset("tokens_skew", 12, 3)
    t_data = tpart.make_token_dataset("tokens_skew", 12, 3)
    want = jflips.token_histograms(j_data, top_k=16)
    got = flips.token_histograms(t_data, top_k=16)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(flips.learner_histograms(t_data),
                          jflips.learner_histograms(j_data))


def test_flips_needs_a_substrate():
    with pytest.raises(ValueError, match="substrate"):
        sel.build_selector(SimConfig(selector="flips"))


# ---------------------------------------------------------------------------
# The spec surface
# ---------------------------------------------------------------------------


def test_table_matches_reference():
    assert sel.SELECTOR_TABLE.names() == jsel.SELECTOR_TABLE.names()
    for name in jsel.SELECTOR_TABLE:
        j, t = jsel.SELECTOR_TABLE[name], sel.SELECTOR_TABLE[name]
        assert (t.needs_feedback, t.select_all, t.doc) == \
            (j.needs_feedback, j.select_all, j.doc)
        assert [(k.name, k.default) for k in t.knobs] == \
            [(k.name, k.default) for k in j.knobs]
    assert sel.describe_selectors() == jsel.describe_selectors()


@pytest.mark.parametrize("name, params", [
    ("random", ()), ("safa", ()), ("oort", (("alpha", 3.0),)),
    ("ucb", (("c", 0.5),)), ("contribution", (("fairness_frac", 0.5),)),
    ("flips", (("n_clusters", 3),)), ("priority", (("holdoff", 2),))])
def test_selector_key_matches_reference(name, params):
    kw = dict(selector=name, selector_params=params)
    assert sel.selector_key(SimConfig(**kw)) == jsel.selector_key(JConfig(**kw))


@pytest.mark.parametrize("name, params, attr, value", [
    ("oort", (("alpha", 3.0), ("eps0", 0.5)), "eps", 0.5),
    ("ucb", (("c", 0.25),), "c", 0.25),
    ("contribution", (("decay", 0.5),), "decay", 0.5),
    ("flips", (("n_clusters", 2),), "cluster_of", None)])
def test_selector_params_reach_the_policy(name, params, attr, value):
    cfg = SimConfig(selector=name, selector_params=params, n_learners=30)
    sim = Simulator(cfg, device="cpu")
    if value is None:            # two clusters of the 30 learners
        assert set(sim.selector.cluster_of.tolist()) == {0, 1}
    else:
        assert getattr(sim.selector, attr) == value
    with pytest.raises(ValueError, match="unknown knob"):
        SimConfig(selector=name, selector_params=(("bogus", 1),))


# ---------------------------------------------------------------------------
# Simulations against the reference
# ---------------------------------------------------------------------------


def _reference(kw):
    """The reference's fused run, with the l2 stats each round's feedback
    carried (by plan row; None when the pipeline fetched none); one run per
    config, shared by the tests that read it."""
    return _reference_run(tuple(sorted(kw.items())))


@functools.lru_cache(maxsize=None)
def _reference_run(items):
    ref_sim = JSimulator(JConfig(**dict(items)))
    l2s, apply = {}, ref_sim._apply_feedback

    def logged(r, sched, l2):
        l2s[r] = None if l2 is None else np.array(l2)
        return apply(r, sched, l2)
    ref_sim._apply_feedback = logged
    return ref_sim, ref_sim.run(), l2s


def _port(kw, ref_sim, inject=None):
    """The port's fused run on the CPU from the reference's weights; with
    ``inject`` (round -> l2 stats by plan row) each round's feedback is fed
    those stats instead of its own.  Returns (sim, accounting, own l2
    stats by round, on the survivors)."""
    cfg = SimConfig(**kw)
    sub = Substrate.build(cfg, flat_params0=from_flat(
        ref_sim.substrate.flat_params0))
    sim = Simulator(cfg, sub, device="cpu")
    pipe = RoundPipeline(sim)
    own, device_round = {}, pipe._device_round

    def run_round(r, work):
        l2 = device_round(r, work)
        own[r] = None if l2 is None else l2.numpy().copy()
        if inject is None or l2 is None:
            return l2
        return torch.from_numpy(inject[r][sim.survivors(work.plans[0])[0]])
    pipe._device_round = run_round
    return sim, pipe.run()[0], own


@pytest.mark.parametrize("cell", list(CELLS))
def test_fused_run_matches_reference(cell):
    kw = {**BASE, **CELLS[cell]}
    needs = sel.SELECTOR_TABLE[kw["selector"]].needs_feedback
    ref_sim, ref, ref_l2s = _reference(kw)
    sim, port, _ = _port(kw, ref_sim, inject=ref_l2s if needs else None)
    assert [_host(r) for r in port.records] == [_host(r) for r in ref.records]
    assert sim.rng.bit_generator.state == ref_sim.rng.bit_generator.state
    evals = [(a, b) for a, b in zip(port.records, ref.records)
             if b.accuracy == b.accuracy]
    assert len(evals) == 2
    for a, b in evals:
        assert abs(a.accuracy - b.accuracy) <= 1.0 / len(sim.data.y_test)
        np.testing.assert_allclose(a.loss, b.loss, rtol=1e-5)
    np.testing.assert_allclose(sim.flat_params.numpy(),
                               np.asarray(ref_sim.flat_params), atol=1e-5)
    assert [(f.learner_id, f.origin_round) for f in sim.stale_cache] == \
        [(f.learner_id, f.origin_round) for f in ref_sim.stale_cache]
    assert sum(r.n_stale for r in ref.records) > 0       # landings ran
    if kw["selector"] == "safa":    # the cohort is every available learner
        assert max(r.n_selected for r in ref.records) > kw["n_target"]
    if needs:                       # the feedback carried the stats
        assert all(l2 is not None for l2 in ref_l2s.values())
        np.testing.assert_allclose([f.stat_util for f in sim.stale_cache],
                                   [f.stat_util for f in ref_sim.stale_cache],
                                   rtol=1e-6)


@pytest.mark.parametrize("name", FEEDBACK)
def test_fused_pipeline_own_l2s_match_reference(name):
    """Without injection the port's fused pipeline feeds its own l2 stats:
    they match the reference's at rtol 1e-4, round by round, and every
    stale row's utility is the stats', not 0."""
    kw = {**BASE, "selector": name}
    ref_sim, ref, ref_l2s = _reference(kw)
    sim, port, own = _port(kw, ref_sim)
    assert own.keys() == ref_l2s.keys() and own
    for r, l2 in own.items():
        nz = ref_l2s[r] != 0             # the reference's survivors' rows
        np.testing.assert_allclose(l2, ref_l2s[r][nz], rtol=1e-4)
        assert (l2 > 0).all()
    assert sim.stale_cache and all(f.stat_util > 0 for f in sim.stale_cache)
    assert [_host(r) for r in port.records] == [_host(r) for r in ref.records]


# ---------------------------------------------------------------------------
# Port fused == port flat, bit for bit
# ---------------------------------------------------------------------------

_SUBSTRATES = {}


def _substrate(cfg):
    key = substrate_key(cfg)
    if key not in _SUBSTRATES:
        _SUBSTRATES[key] = Substrate.build(cfg)
    return _SUBSTRATES[key]


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("cell", list(CELLS))
def test_fused_equals_flat_bitwise(cell, kernel):
    kw = {**BASE, **CELLS[cell], "use_agg_kernel": kernel}
    cfg = SimConfig(**kw)
    fused_sim = Simulator(cfg, _substrate(cfg), device="cpu")
    flat_sim = Simulator(SimConfig(**kw, fused_rounds=False), _substrate(cfg),
                         device="cpu")
    fused, flat = fused_sim.run(), flat_sim.run()
    assert sum(r.n_stale for r in flat.records) > 0
    assert [_bits(r) for r in fused.records] == [_bits(r) for r in flat.records]
    assert torch.equal(fused_sim.flat_params, flat_sim.flat_params)
    # the stragglers still in flight; their utility on both paths only for a
    # feedback selector (a feedback-free fused pipeline fetches no stats and
    # caches 0, as the reference's does)
    needs = sel.SELECTOR_TABLE[kw["selector"]].needs_feedback
    cached = lambda sim: [dataclasses.astuple(f)[:4] + (f.stat_util if needs else 0,)
                          for f in sim.stale_cache]
    assert cached(fused_sim) == cached(flat_sim)


# ---------------------------------------------------------------------------
# The zoo race
# ---------------------------------------------------------------------------


def _reference_zoo():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / "selector_zoo.py"
    spec = importlib.util.spec_from_file_location("_reference_selector_zoo", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("smoke", [True, False])
def test_zoo_cells_are_the_reference_cells(smoke):
    """The port's cells are ``zoo_spec``'s, field by field, in its order,
    with the SAA kernels on."""
    from repro_torch.selector_zoo import zoo_cells
    names = list(jsel.SELECTOR_TABLE)
    ref = _reference_zoo().zoo_spec(names, smoke, (0, 3)).expand()
    port = zoo_cells(names, smoke, (0, 3))
    assert [c.name for c in ref] == [name for name, *_ in port]
    for c, (_, s, seed, cfg) in zip(ref, port):
        want = dataclasses.asdict(c.config)
        got = dataclasses.asdict(cfg)
        assert got.pop("use_agg_kernel") and not want.pop("use_agg_kernel")
        assert got == want and (cfg.selector, cfg.seed) == (s, seed)


def test_zoo_smoke_runs_every_selector_on_cpu(capsys):
    from repro_torch import selector_zoo
    assert selector_zoo.main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "7 selectors x 1 shared seed(s) = 7 cells" in out
    rows = [line.split()[0] for line in out.splitlines()
            if line.startswith("selector=")]
    assert sorted(rows) == sorted(f"selector={s}" for s in sel.SELECTOR_TABLE)
    assert selector_zoo.main(["--selectors", "random,bogus"]) == 2
    assert "unknown selectors ['bogus']" in capsys.readouterr().out


def test_zoo_batched_runner_equals_serial_runner():
    """The zoo's batched runner (one lockstep batch a selector, two seeds a
    batch) gives every cell its serial run's summary, bit for bit on the
    CPU, and its records too."""
    from repro_torch import selector_zoo
    from repro_torch.sweeps import SweepRunner, summaries_equal
    cells = selector_zoo.zoo_cells(list(sel.SELECTOR_TABLE), True, (0, 1))
    batched, _ = selector_zoo.run_batched(cells, device="cpu")
    serial, _ = selector_zoo.run_serial(cells, device="cpu")
    assert len(batched) == len(serial) == 2 * len(sel.SELECTOR_TABLE)
    for a, b in zip(batched, serial):
        assert summaries_equal(a, b)
    selector_zoo.assert_batched_equals_serial(batched, serial, device="cpu")
    runner = SweepRunner(selector_zoo.sweep_cells(cells[:2]), device="cpu")
    res = runner.run()
    assert len(runner.batches()) == 1
    for r, (*_, cfg) in zip(res, cells[:2]):
        assert [_bits(x) for x in r.acct.records] == \
            [_bits(x) for x in Simulator(cfg, device="cpu").run().records]
