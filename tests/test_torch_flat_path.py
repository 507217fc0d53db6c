"""The per-stage flat path (``fused_rounds=False``) and the YoGi server step.

Two contracts:

- **Port fused == port flat, bit for bit** (records, accuracy included, and
  final parameters), over random/priority x OC/DL x the four scaling rules x
  {fedavg, yogi} x kernel on/off — the port's own version of
  ``tests/test_pipeline_parity.py``.  Both substrates train the same rows in
  one batched call and reach the same plain functions on the same shapes.
- **Port flat vs JAX flat**, starting from the reference's initial weights:
  host fields of every RoundRecord equal; per round, from the reference's
  params, optimizer state and stale rows, the aggregate, parameters and
  YoGi state within rtol 1e-4 / atol 1e-6 (one round of fp32 training and
  SAA, summed in other orders).  YoGi's ``sign(v - d^2)`` is discontinuous:
  an element of v whose sign term flips between the two packages (float
  noise in d where v ~ d^2) must lie within rtol 1e-4 of the tie, and is
  then left out of the v and parameter comparison and counted.
  Free-running over a whole run: final params within atol 1e-5, eval loss
  within rtol 1e-5 and accuracy within one test sample, as the fused
  slice's end-to-end test holds them; under YoGi, the few elements whose v
  shows a sign flip (``_free_running_flips``) are counted and left out.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro.sim import SimConfig as JConfig
from repro.sim import Simulator as JSimulator
from repro_torch.sim import SimConfig, Simulator, Substrate
from repro_torch.sim.engine import substrate_key
from repro_torch.sim.pipeline import RoundPipeline
from repro_torch.weights import from_flat

torch.set_num_threads(1)

HOST = ("round_idx", "sim_time", "n_selected", "n_fresh", "n_stale",
        "resource_used", "resource_wasted", "unique_participants")
# every selector/setting pair lands stale rows under this config
PARITY = dict(n_learners=30, rounds=8, eval_every=3, n_target=4, seed=2,
              mapping="label_uniform", saa=True, deadline=30.0)
REF = dict(n_learners=30, rounds=8, eval_every=4, seed=2, n_target=4,
           mapping="label_uniform", use_agg_kernel=True)
VARIANTS = {
    "random": dict(selector="random"),
    "relay": dict(selector="priority", saa=True, apt=True, scaling_rule="relay"),
    "relay_yogi": dict(selector="priority", saa=True, apt=True,
                       scaling_rule="relay", server_opt="yogi"),
    "yogi_plain_dl": dict(selector="priority", saa=True, setting="DL",
                          deadline=30.0, scaling_rule="dynsgd",
                          aggregator="yogi", use_agg_kernel=False),
}
_SUBSTRATES = {}


def _substrate(cfg):
    key = substrate_key(cfg)
    if key not in _SUBSTRATES:
        _SUBSTRATES[key] = Substrate.build(cfg)
    return _SUBSTRATES[key]


def _bits(rec):
    """A RoundRecord as comparable values (NaN accuracy on non-eval rounds
    compares equal to itself)."""
    return tuple(repr(v) for v in dataclasses.astuple(rec))


def _host(rec):
    return tuple(getattr(rec, f) for f in HOST)


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("opt", ["fedavg", "yogi"])
@pytest.mark.parametrize("rule", ["equal", "dynsgd", "adasgd", "relay"])
@pytest.mark.parametrize("selector,setting",
                         list(itertools.product(["random", "priority"],
                                                ["OC", "DL"])))
def test_fused_equals_flat_bitwise(selector, setting, rule, opt, kernel):
    kw = dict(PARITY, selector=selector, setting=setting, scaling_rule=rule,
              server_opt=opt, use_agg_kernel=kernel,
              apt=selector == "priority")
    cfg = SimConfig(**kw)
    fused_sim = Simulator(cfg, _substrate(cfg), device="cpu")
    flat_sim = Simulator(SimConfig(**kw, fused_rounds=False), _substrate(cfg),
                         device="cpu")
    fused, flat = fused_sim.run(), flat_sim.run()
    assert sum(r.n_stale for r in flat.records) > 0
    assert [_bits(r) for r in fused.records] == [_bits(r) for r in flat.records]
    assert torch.equal(fused_sim.flat_params, flat_sim.flat_params)
    if opt == "yogi":
        for k in ("m", "v", "t"):
            assert torch.equal(fused_sim.flat_opt_state[k],
                               flat_sim.flat_opt_state[k])
    assert fused.summary() == flat.summary() or \
        repr(fused.summary()) == repr(flat.summary())


def test_yogi_pad_columns_stay_zero():
    """Under the kernel the fused pipeline keeps params and YoGi state
    d_pad wide; the pad columns stay exact zeros in all three."""
    kw = dict(PARITY, selector="priority", apt=True, server_opt="yogi",
              use_agg_kernel=True)
    cfg = SimConfig(**kw)
    sim = Simulator(cfg, _substrate(cfg), device="cpu")
    pipe = RoundPipeline(sim)
    d = pipe.d
    assert pipe.d_pad > d and pipe.opt_state["v"][0, :d].eq(1e-6).all()
    sim._t_now = 0.0
    for r in range(cfg.rounds):
        pipe.step(r)
        for t in (pipe.params[0], pipe.opt_state["m"][0],
                  pipe.opt_state["v"][0]):
            assert not t[d:].any()
    assert int(pipe.opt_state["t"][0]) > 0
    pipe.finalize()


def _port_sim(kw, ref_sim):
    cfg = SimConfig(**kw)
    sub = Substrate.build(cfg, flat_params0=from_flat(
        ref_sim.substrate.flat_params0))
    return Simulator(cfg, sub, device="cpu")


def _sync_from_reference(sim, ref):
    """Start the port's round from the reference's params, YoGi state and
    stale rows (same entries, same order)."""
    sim.flat_params = torch.tensor(np.asarray(ref.flat_params))
    if ref.flat_opt_state is not None:
        sim.flat_opt_state = {k: torch.tensor(np.asarray(v))
                              for k, v in ref.flat_opt_state.items()}
    assert len(sim.stale_cache) == len(ref.stale_cache)
    for fp, fj in zip(sim.stale_cache, ref.stale_cache):
        assert (fp.learner_id, fp.origin_round) == (fj.learner_id,
                                                    fj.origin_round)
        fp.delta = torch.tensor(np.asarray(fj.delta))


def _check_yogi_step(sim, ref, v_prev, agg_ref):
    """Compare one YoGi step under the sign-flip rule; returns the count of
    flipped elements."""
    d2 = np.asarray(agg_ref, np.float64) ** 2
    v_t, v_j = sim.flat_opt_state["v"].numpy(), np.asarray(ref.flat_opt_state["v"])
    flip = ~np.isclose(v_t, v_j, rtol=1e-4, atol=1e-6 * 1e-6)
    tie = np.abs(v_prev - d2) <= 1e-4 * d2
    assert not (flip & ~tie).any(), "v differs away from a sign tie"
    ok = ~flip
    np.testing.assert_allclose(sim.flat_opt_state["m"].numpy(),
                               np.asarray(ref.flat_opt_state["m"]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(sim.flat_params.numpy()[ok],
                               np.asarray(ref.flat_params)[ok],
                               rtol=1e-4, atol=1e-6)
    assert int(sim.flat_opt_state["t"]) == int(ref.flat_opt_state["t"])
    return int(flip.sum())


def _check_feedback(log_j, log_t):
    """Same feedback calls in the same order; stat utility within rtol
    1e-4 (it comes from each package's own local training)."""
    assert [(lid, kw["duration"], kw["round_idx"]) for lid, kw in log_t] == \
        [(lid, kw["duration"], kw["round_idx"]) for lid, kw in log_j]
    np.testing.assert_allclose([kw["stat_util"] for _, kw in log_t],
                               [kw["stat_util"] for _, kw in log_j],
                               rtol=1e-4)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_flat_rounds_match_reference_flat_path(variant):
    """Both packages' flat paths driven stage by stage, each round from the
    reference's state."""
    kw = {**REF, **VARIANTS[variant], "fused_rounds": False}
    ref = JSimulator(JConfig(**kw))
    sim = _port_sim(kw, ref)
    yogi = sim.cfg.server_opt == "yogi"
    feedback = {"jax": [], "torch": []}
    for key, s in (("jax", ref), ("torch", sim)):
        s.selector.update_feedback = (
            lambda lid, log=feedback[key], **fb: log.append((lid, fb)))
    flips, stale_rows = 0, 0
    for r in range(kw["rounds"]):
        _sync_from_reference(sim, ref)
        plan_j, plan_t = ref._begin_round(r), sim._begin_round(r)
        assert (plan_j is None) == (plan_t is None)
        if plan_j is None:
            continue
        deltas_j, losses, l2s = ref._train(plan_j)
        t_end, fresh_j, stale_j, taus_j, lids = ref._collect_updates(
            r, plan_j, deltas_j, losses, l2s)
        deltas_t, pos, l2s_t = sim._train(plan_t)
        t_end_t, fresh_t, stale_t, taus_t, lids_t = sim._collect_updates(
            r, plan_t, deltas_t, pos, l2s_t)
        assert (t_end_t, len(fresh_t), len(stale_t), list(taus_t), lids_t) == \
            (t_end, len(fresh_j), len(stale_j), list(taus_j), lids)
        # selector feedback and the stragglers' stat utility, from l2 stats
        _check_feedback(*feedback.values())
        np.testing.assert_allclose([f.stat_util for f in sim.stale_cache],
                                   [f.stat_util for f in ref.stale_cache],
                                   rtol=1e-4)
        stale_rows += len(stale_t)
        if fresh_j or stale_j:
            agg_j = np.asarray(ref._aggregate(r, lids, fresh_j, stale_j, taus_j))
            agg_t = sim._aggregate(r, lids_t, fresh_t, stale_t, taus_t)
            np.testing.assert_allclose(agg_t.numpy(), agg_j, rtol=1e-4,
                                       atol=1e-6)
            v_prev = np.asarray(ref.flat_opt_state["v"]) if yogi else None
            ref._apply_update(agg_j)
            sim._apply_update(agg_t)
            if yogi:
                flips += _check_yogi_step(sim, ref, v_prev, agg_j)
            else:
                np.testing.assert_allclose(sim.flat_params.numpy(),
                                           np.asarray(ref.flat_params),
                                           rtol=1e-4, atol=1e-6)
        rec_j = ref._record_round(r, plan_j.t_now, t_end, len(plan_j.chosen),
                                  len(fresh_j), len(stale_j))
        rec_t = sim._record_round(r, plan_t.t_now, t_end_t, len(plan_t.chosen),
                                  len(fresh_t), len(stale_t))
        assert _host(rec_t) == _host(rec_j)
        if rec_j.accuracy == rec_j.accuracy:
            assert abs(rec_t.accuracy - rec_j.accuracy) <= 1.0 / len(
                sim.data.y_test)
            np.testing.assert_allclose(rec_t.loss, rec_j.loss, rtol=1e-4)
    assert ref.rng.bit_generator.state == sim.rng.bit_generator.state
    assert any(fb["stat_util"] for _, fb in feedback["torch"])
    if variant != "random":
        assert stale_rows > 0
    print(f"{variant}: {flips} YoGi sign flips within the tie tolerance")


@pytest.mark.parametrize("variant", ["relay", "relay_yogi"])
def test_flat_run_matches_reference_end_to_end(variant):
    kw = {**REF, **VARIANTS[variant], "fused_rounds": False}
    ref_sim = JSimulator(JConfig(**kw))
    ref = ref_sim.run()
    sim = _port_sim(kw, ref_sim)
    port = sim.run()
    assert [_host(r) for r in port.records] == [_host(r) for r in ref.records]
    evals = [(a, b) for a, b in zip(port.records, ref.records)
             if b.accuracy == b.accuracy]
    assert len(evals) == 2
    for a, b in evals:
        assert abs(a.accuracy - b.accuracy) <= 1.0 / len(sim.data.y_test)
        np.testing.assert_allclose(a.loss, b.loss, rtol=1e-5)
    keep = np.ones(sim.flat_params.shape, bool)
    if sim.cfg.server_opt == "yogi":
        keep = ~_free_running_flips(sim, ref_sim)
    np.testing.assert_allclose(sim.flat_params.numpy()[keep],
                               np.asarray(ref_sim.flat_params)[keep], atol=1e-5)


def _free_running_flips(sim, ref):
    """Elements where a YoGi sign term flipped during a free run: v differs
    beyond rtol 1e-4.  A flip at a tie v ~ d^2 moves v by 2 (1-b2) d^2,
    about 2% of v, and later steps carry that difference along (v shrinks
    by at most 1% a step), so it stays under 2.5% of v over these rounds.
    They are few; their params are left out of the comparison."""
    v_t = sim.flat_opt_state["v"].numpy()
    v_j = np.asarray(ref.flat_opt_state["v"])
    flip = ~np.isclose(v_t, v_j, rtol=1e-4, atol=1e-12)
    assert (np.abs(v_t - v_j)[flip] <= 0.025 * np.maximum(v_t, v_j)[flip]).all()
    assert flip.sum() <= 1e-3 * flip.size, int(flip.sum())
    print(f"{int(flip.sum())} YoGi sign flips over the free run")
    return flip
