"""The legacy pytree engine (``SimConfig(fast_path=False)``), its scalar
availability substrate and the ``core.selection`` shim, held against the
JAX package and within the port.

Against the reference, on the same seeded inputs (the reference's initial
weights injected, its Pallas kernels in interpret mode):

- ``LearnerTrace`` / ``AlwaysAvailable`` queries and
  ``AvailabilityForecaster`` observations, predictions and scores ``==``
  (numpy code copied, so bit for bit);
- whole legacy runs (``tests/test_fastpath_parity.py``'s three configs,
  YoGi, an attacked trimmed_mean cell, a guarded cell under a NaN fault
  plan; the SAA kernel on and off): every RoundRecord's host fields and
  the summary's host counters ``==``, accuracy within one test sample,
  and the final parameter tree within atol 1e-5 of the reference's (the
  flat path's free-running tolerance: each round sums the same fp32
  terms in other orders in the two packages; under YoGi the few elements
  whose ``sign(v - d^2)`` flips at a tie are left out, as there).

Within the port: legacy == the fused fast path in host records and
summary counters (and, on the CPU, in parameters bit for bit), a legacy
snapshot resumed bit for bit, the configuration rules, and the shim's
names.
"""
import dataclasses
import pickle

import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core.availability import AvailabilityForecaster as JForecaster
from repro.core.availability import ForecasterBank as JBank
from repro.faults import FaultPlan as JPlan
from repro.faults import FaultSpec as JSpec
from repro.sim import SimConfig as JConfig
from repro.sim import Simulator as JSimulator
from repro.sim import traces as jtr
from repro_torch.checkpoint import resume_run
from repro_torch.core.aggregation import (flatten_update,
                                          stale_synchronous_aggregate)
from repro_torch.core.availability import (AvailabilityForecaster,
                                           ForecasterBank)
from repro_torch.faults import FaultPlan, FaultSpec
from repro_torch.kernels.staleness_agg import ops as agg_ops
from repro_torch.sim import SimConfig, Simulator, Substrate
from repro_torch.sim import traces as ttr
from repro_torch.sweeps import SweepRunner, SweepSpec
from repro_torch.weights import from_flat

torch.set_num_threads(1)


def _map_tree(fn, tree):
    return {k: _map_tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}

HOST = ("round_idx", "sim_time", "n_selected", "n_fresh", "n_stale",
        "resource_used", "resource_wasted", "unique_participants")
HOST_SUMMARY = ("rounds", "sim_time", "resource_used", "resource_wasted",
                "unique_participants", "stopped_early", "rejected_nonfinite",
                "rejected_norm", "quorum_skips", "robust_rejected",
                "robust_trimmed")
BASE = dict(n_learners=40, rounds=12, eval_every=6, seed=3)
STATIC = dict(n_learners=30, rounds=8, eval_every=4, n_target=6, saa=True,
              selector="priority", mapping="label_uniform",
              dynamic_availability=False)
NAN_PLAN = ((("nan", dict(prob=0.15)), ("post_drop", dict(prob=0.1)),
             ("replay", dict(prob=0.3))), 2)
CONFIGS = {
    # tests/test_fastpath_parity.py's three
    "random_oc": dict(BASE, selector="random", saa=True, setting="OC"),
    "safa_dl": dict(BASE, selector="safa", setting="DL", saa=True,
                    staleness_threshold=3),
    "priority_apt": dict(BASE, selector="priority", apt=True),
    "relay_yogi": dict(BASE, selector="priority", apt=True, saa=True,
                       server_opt="yogi"),
    "trimmed_attacked": dict(STATIC, aggregator="trimmed_mean", trim_k=1,
                             attack="collude_signflip", attack_frac=0.25),
    "guard_nan": dict(STATIC, guard=True),
}


def _host(rec):
    return tuple(getattr(rec, f) for f in HOST)


def _summary(acct):
    s = acct.summary()
    return {k: s[k] for k in HOST_SUMMARY}


def _plans(name):
    if name != "guard_nan":
        return None, None
    specs, seed = NAN_PLAN
    n, r = STATIC["n_learners"], STATIC["rounds"]
    return (JPlan(n, r, specs=tuple(JSpec(k, **a) for k, a in specs),
                  seed=seed),
            FaultPlan(n, r, specs=tuple(FaultSpec(k, **a) for k, a in specs),
                      seed=seed))


def _port_sim(kw, ref_sim, fault_plan=None, substrate=None):
    cfg = SimConfig(**kw)
    sub = substrate or Substrate.build(cfg, flat_params0=from_flat(
        ref_sim.substrate.flat_params0))
    return Simulator(cfg, sub, device="cpu", fault_plan=fault_plan)


def _flat(sim):
    return (flatten_update(sim.params)[0] if not sim.cfg.fast_path
            else sim.flat_params).numpy()


# ---------------------------------------------------------------------------
# Scalar availability substrate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dynamic", [True, False])
def test_scalar_traces_match_reference(dynamic):
    rng_j, rng_t = np.random.default_rng(7), np.random.default_rng(7)
    tj = jtr.make_traces(12, rng_j, dynamic=dynamic)
    tt = ttr.make_traces(12, rng_t, dynamic=dynamic)
    bank = ttr.TraceBank(tt)
    lids = np.arange(12)
    times = np.random.default_rng(1).uniform(0.0, 16 * 24 * 3600.0, 80)
    for t in map(float, times):
        t1 = t + 1800.0
        for a, b in zip(tj, tt):
            assert b.available(t) == a.available(t)
            assert b.available_through(t, t1) == a.available_through(t, t1)
            assert b.next_unavailable_after(t) == a.next_unavailable_after(t)
        np.testing.assert_array_equal(bank.available_all(t),
                                      [b.available(t) for b in tt])
        np.testing.assert_array_equal(
            bank.next_unavailable_after_batch(lids, t),
            [b.next_unavailable_after(t) for b in tt])


def test_scalar_forecaster_matches_reference_and_bank():
    rng = np.random.default_rng(11)
    n = 6
    fj = [JForecaster() for _ in range(n)]
    ft = [AvailabilityForecaster() for _ in range(n)]
    bank, jbank = ForecasterBank(n), JBank(n)
    t = 0.0
    for _ in range(200):
        t += float(rng.uniform(60.0, 7200.0))
        lids = np.sort(rng.choice(n, size=rng.integers(1, n + 1),
                                  replace=False))
        avail = rng.random(len(lids)) < 0.5
        for lid, a in zip(lids, avail):
            fj[lid].observe(t, bool(a))
            ft[lid].observe(t, bool(a))
        bank.observe_batch(lids, t, avail.astype(float))
        jbank.observe_batch(lids, t, avail.astype(float))
        t0 = t + float(rng.uniform(0.0, 3600.0))
        t1 = t0 + float(rng.uniform(-10.0, 3600.0))
        for lid in range(n):
            p = ft[lid].predict_window(t0, t1)
            assert p == fj[lid].predict_window(t0, t1)
            assert p == bank.view(lid).predict_window(t0, t1)
    for a, b in zip(fj, ft):
        np.testing.assert_array_equal(a.counts, b.counts)
        np.testing.assert_array_equal(a.avail_counts, b.avail_counts)
        assert a.recent == b.recent
    trace = ttr.make_traces(1, np.random.default_rng(3))[0]
    t_eval = np.arange(0.0, 2 * 24 * 3600.0, 900.0)
    st, sj = ft[0].score(trace.available, t_eval), fj[0].score(
        trace.available, t_eval)
    assert st == sj
    assert bank.view(0).score(trace.available, t_eval) == jbank.view(
        0).score(trace.available, t_eval)
    const = ft[1].score(lambda _: True, t_eval)
    assert const["r2"] != const["r2"]                  # NaN for a constant


# ---------------------------------------------------------------------------
# The legacy engine against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_legacy_run_matches_reference_legacy(name, kernel):
    kw = dict(CONFIGS[name], fast_path=False, use_agg_kernel=kernel)
    jplan, tplan = _plans(name)
    ref_sim = JSimulator(JConfig(**kw), fault_plan=jplan)
    ref = ref_sim.run()
    sim = _port_sim(kw, ref_sim, fault_plan=tplan)
    calls = []
    if kernel:
        real = agg_ops.fused_staleness_aggregate
        agg_ops.fused_staleness_aggregate = (
            lambda *a, **k: calls.append(1) or real(*a, **k))
    try:
        port = sim.run()
    finally:
        if kernel:
            agg_ops.fused_staleness_aggregate = real
    assert [_host(r) for r in port.records] == [_host(r) for r in ref.records]
    assert _summary(port) == _summary(ref)
    evals = [(a, b) for a, b in zip(port.records, ref.records)
             if b.accuracy == b.accuracy]
    assert evals
    for a, b in evals:
        assert abs(a.accuracy - b.accuracy) <= 1.0 / len(sim.data.y_test)
    flat_j = np.asarray(jagg.flatten_update(ref_sim.params)[0])
    keep = np.ones(flat_j.shape, bool)
    if sim.cfg.server_opt == "yogi":
        v_t = flatten_update(sim.opt_state["v"])[0].numpy()
        v_j = np.asarray(jagg.flatten_update(ref_sim.opt_state["v"])[0])
        keep = np.isclose(v_t, v_j, rtol=1e-4, atol=1e-12)
        assert keep.mean() > 0.999
    np.testing.assert_allclose(_flat(sim)[keep], flat_j[keep], atol=1e-5)
    s = port.summary()
    if name == "guard_nan":
        assert s["rejected_nonfinite"] > 0
    if name == "trimmed_attacked":
        assert s["robust_trimmed"] > 0
    if kernel:
        # kernel 3 is the plain and guarded routes' aggregation: one call
        # an aggregating round
        expect = (0 if CONFIGS[name].get("aggregator") else
                  sum(1 for r in port.records if r.n_fresh + r.n_stale))
        assert len(calls) == expect


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("rule", ["relay", "equal", "dynsgd"])
def test_tree_wrapper_matches_reference(rule, kernel):
    """``stale_synchronous_aggregate`` on update trees (3 fresh, 2 stale)
    against the reference's pytree wrapper (its kernel in interpret mode):
    the aggregate leaf for leaf and the weights at ``test_kernels.py``'s
    tolerances (aggregate rtol 1e-4 / atol 1e-5, weights rtol 1e-5 /
    atol 1e-6)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    trees = [{"dense1": {"w": rng.standard_normal((12, 8)).astype(np.float32),
                         "b": rng.standard_normal(8).astype(np.float32)},
              "out": {"w": rng.standard_normal((8, 3)).astype(np.float32)}}
             for _ in range(5)]
    fresh, tau = [True] * 3 + [False] * 2, [0, 0, 0, 2, 5]
    agg_j, w_j = jagg.stale_synchronous_aggregate(
        [_map_tree(jnp.asarray, t) for t in trees], fresh, tau, rule=rule,
        use_kernel=kernel)
    agg_t, w_t = stale_synchronous_aggregate(
        [_map_tree(torch.from_numpy, t) for t in trees], fresh, tau,
        rule=rule, use_kernel=kernel)
    for layer in ("dense1", "out"):
        for name, leaf in agg_t[layer].items():
            np.testing.assert_allclose(leaf.numpy(),
                                       np.asarray(agg_j[layer][name]),
                                       rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# Within the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("name", ["random_oc", "priority_apt", "relay_yogi",
                                  "trimmed_attacked", "guard_nan"])
def test_legacy_equals_fast_path(name, kernel):
    """The legacy engine's host decisions are the fused fast path's and
    the flat path's; on the CPU its parameters are the flat path's bit for
    bit (the same rows reach the same aggregation and server step)."""
    kw = dict(CONFIGS[name], use_agg_kernel=kernel)
    sub = Substrate.build(SimConfig(**kw))
    sims = [Simulator(SimConfig(**kw, **extra), sub, device="cpu",
                      fault_plan=_plans(name)[1])
            for extra in ({}, dict(fused_rounds=False), dict(fast_path=False))]
    fused, flat, legacy = (s.run() for s in sims)
    for other in (fused, flat):
        assert [_host(r) for r in legacy.records] == \
            [_host(r) for r in other.records]
        assert _summary(legacy) == _summary(other)
    np.testing.assert_array_equal(_flat(sims[2]), _flat(sims[1]))


@pytest.mark.parametrize("name", ["relay_yogi", "guard_nan"])
def test_legacy_snapshot_resumes_bitwise(name, tmp_path):
    kw = dict(CONFIGS[name], fast_path=False)
    sub = Substrate.build(SimConfig(**kw))
    full = Simulator(SimConfig(**kw), sub, device="cpu",
                     fault_plan=_plans(name)[1])
    whole = full.run()
    half = kw["rounds"] // 2
    path = str(tmp_path / "snap.pkl")
    first = Simulator(SimConfig(**kw), sub, device="cpu",
                      fault_plan=_plans(name)[1])
    first.run(checkpoint_path=path, checkpoint_every=half)
    payload = pickle.load(open(path, "rb"))
    assert payload["next_round"] == half and "forecasters" in \
        payload["sim"]["state"] and "params" in payload["sim"]
    resumed = resume_run(path, device="cpu")
    assert [dataclasses.astuple(r) for r in resumed.records] == \
        [dataclasses.astuple(r) for r in whole.records] or \
        repr([dataclasses.astuple(r) for r in resumed.records]) == \
        repr([dataclasses.astuple(r) for r in whole.records])
    assert repr(resumed.summary()) == repr(whole.summary())


def test_legacy_config_rules():
    with pytest.raises(ValueError, match="MLP-only"):
        SimConfig(fast_path=False, model="transformer", benchmark="tokens")
    with pytest.raises(ValueError, match="fused fast path"):
        SimConfig(fast_path=False, shard_participants=2)
    cells = SweepSpec(axes={"saa": [False, True]},
                      base=dict(BASE, fast_path=False), seeds=(0,)).expand()
    with pytest.raises(ValueError, match="fast_path=True"):
        SweepRunner(cells, device="cpu")


def test_selection_shim_names_the_zoo_classes():
    import repro_torch.core.selection as shim
    import repro_torch.selection as zoo
    for name in ("LearnerView", "OortSelector", "PrioritySelector",
                 "RandomSelector", "SafaSelector", "Selector", "SELECTORS"):
        assert getattr(shim, name) is getattr(zoo, name)
    assert set(shim.SELECTORS) == set(zoo.SELECTOR_TABLE)
    for key, cls in shim.SELECTORS.items():
        assert cls.name == key
    sel = pickle.loads(pickle.dumps(shim.PrioritySelector()))
    assert type(sel) is zoo.PrioritySelector
