"""The port's host side held exactly against the JAX reference.

Everything the seed builds (dataset, shards, device profiles, traces,
warmed forecasters) and every host decision of a round (cohort, batch
indices, dropouts, arrival schedule, fresh/straggler split, stale landings,
APT targets, resource accounting) is numpy, so the port must match with
``np.array_equal`` and an equal generator state — no tolerance.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core.apt import AdaptiveParticipantTarget as JApt
from repro.core.availability import ForecasterBank as JBank
from repro.selection import LearnerView as JView
from repro.selection import PrioritySelector as JPriority
from repro.selection import RandomSelector as JRandom
from repro.sim import SimConfig as JConfig
from repro.sim import Simulator as JSimulator
from repro.sim.engine import Substrate as JSubstrate
from repro.sim.engine import _InFlight as JInFlight
from repro.sim import devices as jdev
from repro_torch.core import aggregation as tagg
from repro_torch.core.apt import AdaptiveParticipantTarget as TApt
from repro_torch.core.availability import ForecasterBank as TBank
from repro_torch.core.stale_cache import DeviceStaleCache
from repro_torch.selection import LearnerView as TView
from repro_torch.selection import PrioritySelector as TPriority
from repro_torch.selection import RandomSelector as TRandom
from repro_torch.sim import SimConfig, Simulator, Substrate
from repro_torch.sim import devices as tdev
from repro_torch.sim.engine import _InFlight as TInFlight
from repro_torch.weights import from_flat, from_jax_params

torch.set_num_threads(1)


def _profiles_equal(a, b):
    assert [dataclasses.astuple(p) for p in a] == \
        [dataclasses.astuple(p) for p in b]


@pytest.mark.parametrize("benchmark,mapping,dynamic", [
    ("speech", "label_uniform", True),
    ("speech", "uniform", False),
    ("cifar10", "fedscale", True),
    ("openimage", "label_balanced", True),
    ("speech", "label_zipf", True),
])
def test_substrate_build_matches_reference(benchmark, mapping, dynamic):
    kw = dict(benchmark=benchmark, mapping=mapping, n_learners=40, seed=3,
              dynamic_availability=dynamic)
    ref = JSubstrate.build(JConfig(**kw))
    port = Substrate.build(SimConfig(**kw),
                           flat_params0=from_flat(ref.flat_params0))
    assert port.key == ref.key
    for f in ("x_train", "y_train", "x_test", "y_test"):
        a, b = getattr(port.data, f), getattr(ref.data, f)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert len(port.data.shards) == len(ref.data.shards)
    assert all(np.array_equal(a, b)
               for a, b in zip(port.data.shards, ref.data.shards))
    _profiles_equal(port.base_profiles, ref.base_profiles)
    for f in ("lens", "offsets", "boundaries", "states", "_packed"):
        assert np.array_equal(getattr(port.trace_bank, f),
                              getattr(ref.trace_bank, f))
    assert port.trace_bank.stride == ref.trace_bank.stride
    assert port.rng_state == ref.rng_state
    for a, b in zip(port.warmed_fbank(), ref.warmed_fbank()):
        assert np.array_equal(a, b)
    assert np.array_equal(port.flat_params0, np.asarray(ref.flat_params0))
    assert port.meta.feature_dim == ref.meta.feature_dim
    assert port.meta.n_classes == ref.meta.n_classes


def test_flat_layout_matches_reference():
    """The mlp on speech: leaves b1, b2, w1, w2 at offsets 0/128/163/8355,
    D = 12835, in both packages; carried weights land element for element."""
    ref = JSubstrate.build(JConfig(n_learners=10))
    port = Substrate.build(SimConfig(n_learners=10))
    assert port.flat_spec.names == ("b1", "b2", "w1", "w2")
    assert port.flat_spec.offsets == ref.flat_spec[3]
    assert port.flat_spec.offsets == (0, 128, 163, 8355, 12835)
    assert tagg.flat_dim(port.flat_spec) == jagg.flat_dim(ref.flat_spec)
    jax_params = {k: np.asarray(v) for k, v in ref.params0.items()}
    assert np.array_equal(from_jax_params(jax_params),
                          np.asarray(ref.flat_params0))
    with pytest.raises(ValueError):
        Substrate.build(SimConfig(n_learners=10),
                        flat_params0=np.zeros(5, np.float32))
    with pytest.raises(ValueError):
        from_flat(np.zeros((2, 3), np.float32))


@pytest.mark.parametrize("n", [1, 2, 3, 31, 32, 33, 127, 128, 129, 1000])
def test_padding_buckets_match_reference(n):
    assert tagg.bucket_pow2(n) == jagg.bucket_pow2(n)
    assert tagg.bucket_block(n, 32) == jagg.bucket_block(n, 32)
    assert tagg.bucket_block(n, 128) == jagg.bucket_block(n, 128)


@pytest.mark.parametrize("scenario", ["HS1", "HS2", "HS3", "HS4"])
def test_device_profiles_match_reference(scenario):
    a = jdev.sample_profiles(50, np.random.default_rng(1), scenario)
    b = tdev.sample_profiles(50, np.random.default_rng(1), scenario)
    _profiles_equal(a, b)


def test_forecaster_bank_and_apt_match_reference():
    rng = np.random.default_rng(4)
    jb, tb = JBank(25), TBank(25)
    for step in range(40):
        t = float(step * 977.0)
        if step % 3 == 0:
            avail = rng.random(25) < 0.4
            jb.observe_all(t, avail)
            tb.observe_all(t, avail)
        else:
            lids = rng.choice(25, size=7, replace=False)
            jb.observe_batch(lids, t, 1.0)
            tb.observe_batch(lids, t, 1.0)
        q = rng.choice(25, size=5, replace=False)
        assert np.array_equal(jb.predict_window_batch(q, t, t + 300.0),
                              tb.predict_window_batch(q, t, t + 300.0))
    for f in ("counts", "avail_counts", "recent"):
        assert np.array_equal(getattr(jb, f), getattr(tb, f))
    ja, ta = JApt(n0=10), TApt(n0=10)
    for dur in (120.0, 80.0, 300.0, 45.5):
        assert ja.update_round_duration(dur) == ta.update_round_duration(dur)
        rts = list(rng.uniform(0, 400, 6))
        assert ja.target(rts) == ta.target(rts)


@pytest.mark.parametrize("kind", ["random", "priority"])
def test_selectors_match_reference(kind):
    jsel, tsel = ((JRandom(), TRandom()) if kind == "random"
                  else (JPriority(holdoff=3), TPriority(holdoff=3)))
    rj, rt = np.random.default_rng(9), np.random.default_rng(9)
    rng = np.random.default_rng(0)
    for r in range(12):
        ids = np.sort(rng.choice(60, size=int(rng.integers(3, 40)),
                                 replace=False))
        probs = rng.random(len(ids)).round(1)   # ties exercise the jitter
        n = int(rng.integers(1, 15))
        if kind == "random":
            a = jsel.select_ids(r, ids, n, rj)
            b = tsel.select_ids(r, ids, n, rt)
        else:
            a = jsel.select(r, [JView(int(i), float(p)) for i, p in zip(ids, probs)],
                            n, rj)
            b = tsel.select(r, [TView(int(i), float(p)) for i, p in zip(ids, probs)],
                            n, rt)
        assert list(a) == list(b)
        assert rj.bit_generator.state == rt.bit_generator.state


@pytest.mark.parametrize("camp", [
    dict(selector="random"),
    dict(selector="priority", saa=True, apt=True),
    dict(selector="priority", saa=True, setting="DL", deadline=60.0,
         staleness_threshold=1, hardware_scenario="HS3"),
])
def test_round_host_stages_match_reference(camp):
    """The host state machine alone, round after round: plans, schedules,
    records and the generator stream equal the reference's.  The model
    never changes here, so the eval rounds evaluate the carried initial
    weights (accuracy within one test sample, loss rtol 1e-5)."""
    kw = dict(n_learners=40, rounds=12, seed=2, n_target=4, eval_every=5,
              mapping="label_uniform", **camp)
    js = JSimulator(JConfig(**kw))
    cfg = SimConfig(**kw)
    ts = Simulator(cfg, Substrate.build(cfg, flat_params0=from_flat(
        js.substrate.flat_params0)), device="cpu")
    for r in range(kw["rounds"]):
        pj, pt = js._begin_round(r), ts._begin_round(r)
        assert (pj is None) == (pt is None)
        if pj is None:
            continue
        assert list(pj.chosen) == list(pt.chosen) and pj.n_t == pt.n_t
        for f in ("durs", "drop_at", "bidx"):
            assert np.array_equal(getattr(pj, f), getattr(pt, f))
        sj, st = js._schedule_round(r, pj), ts._schedule_round(r, pt)
        assert sj.t_end == st.t_end and sj.fresh_rows == st.fresh_rows
        assert sj.new_stale == st.new_stale and sj.landing_taus == st.landing_taus
        assert [f.learner_id for f in sj.landing] == \
            [f.learner_id for f in st.landing]
        assert [f.learner_id for f in sj.expired] == \
            [f.learner_id for f in st.expired]
        js._apply_feedback(r, sj, None)
        ts._apply_feedback(r, st, None)
        for sim, sc, entry in ((js, sj, JInFlight), (ts, st, TInFlight)):
            for (_i, lid, arr, dur) in sc.new_stale:
                sim.stale_cache.append(entry(lid, r, arr, dur, None, 0.0))
        rj = js._record_round(r, pj.t_now, sj.t_end, len(pj.chosen),
                              len(sj.fresh_rows), len(sj.landing))
        rt = ts._record_round(r, pt.t_now, st.t_end, len(pt.chosen),
                              len(st.fresh_rows), len(st.landing))
        assert dataclasses.astuple(rj)[:8] == dataclasses.astuple(rt)[:8]
        if js.eval_due(r):
            assert abs(rj.accuracy - rt.accuracy) <= 1 / len(js.data.y_test)
            np.testing.assert_allclose(rt.loss, rj.loss, rtol=1e-5)
        assert js.rng.bit_generator.state == ts.rng.bit_generator.state
        assert np.array_equal(js.busy_until, ts.busy_until) and js.mu == ts.mu
    assert js.acct.unique == ts.acct.unique


def test_stale_cache_slot_discipline_matches_reference():
    from repro.core.stale_cache import DeviceStaleCache as JCache
    jc, tc = JCache(6, capacity=2), DeviceStaleCache(6, capacity=2, device="cpu")
    rng = np.random.default_rng(0)
    held = []
    for step in range(30):
        if held and rng.random() < 0.4:
            k = int(rng.integers(1, len(held) + 1))
            free, held = held[:k], held[k:]
            jc.free(free)
            tc.free(free)
        k = int(rng.integers(1, 4))
        sj, _ = jc.alloc(k)
        st = tc.alloc(k)
        assert sj == st and jc.capacity == tc.capacity
        rows = rng.standard_normal((k, 6)).astype(np.float32)
        jc.put(sj, rows)
        tc.put(st, rows)
        held += st
        assert jc.occupied() == tc.occupied()
        assert tuple(tc.rows.shape) == (tc.capacity + 1, 6)
    assert np.array_equal(jc.gather(held), tc.gather(held))
    assert jc.grow_events == tc.grow_events > 0
