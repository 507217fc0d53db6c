"""Byzantine-robust aggregation and coordinated attacks in the port
(``repro_torch.robust``, ``repro_torch.faults``) against the JAX package.

Contracts:

- **Formulas.**  ``apply_attack``, ``krum_select``, ``weighted_rows``,
  ``trimmed_weighted_aggregate`` and ``screen_rows`` against the reference
  on the same seeded numpy inputs: masks, counts and passed-through rows
  exactly; floats within rtol 1e-5 / atol 1e-6 (sums taken in another
  order; a row mean of 7 rows moves by a few ulp).
- **Attacker draws.**  ``FaultPlan.with_attack`` gives the reference's
  attacker ids, ``==``.
- **Simulation vs the reference.**  For every robust kind under
  ``collude_signflip`` and ``alie``, both packages' flat paths driven stage
  by stage, each round from the reference's params and stale rows: host
  fields of every RoundRecord, the aggregation rows' learner ids and the
  robust counters equal; the aggregate and the params within rtol 1e-4 /
  atol 1e-6 (one round of fp32 training and aggregation summed in other
  orders), as ``tests/test_torch_flat_path.py`` holds the plain path.
- **Port fused == port flat**, bit for bit (records, params, counters),
  with and without ``use_agg_kernel``.
- **Closed-form counts**: ``multi_krum`` rejects exactly ``min(f, c-1)``
  rows a round, ``trimmed_mean`` trims exactly ``2 min(k, (c-1)//2)``, a
  norm screen against a huge sign flip rejects exactly the attackers.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.faults import AttackSpec as JAttackSpec
from repro.faults import FaultPlan as JFaultPlan
from repro.faults.attacks import apply_attack as japply_attack
from repro.faults.attacks import attack_key as jattack_key
from repro.robust import aggregators as jrob
from repro.sim import SimConfig as JConfig
from repro.sim import Simulator as JSimulator
from repro_torch.core.aggregation import screen_rows
from repro_torch.faults import AttackSpec, FaultPlan, apply_attack, attack_key
from repro_torch.robust import aggregators as rob
from repro_torch.sim import SimConfig, Simulator, Substrate
from repro_torch.sim.engine import substrate_key
from repro_torch.weights import from_flat

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
HOST = ("round_idx", "sim_time", "n_selected", "n_fresh", "n_stale",
        "resource_used", "resource_wasted", "unique_participants")
# the reference's tests/test_robust_aggregation.py size
BASE = dict(n_learners=30, rounds=8, eval_every=4, n_target=4, saa=True,
            selector="priority")
KINDS = {
    "saa": {},
    "coord_median": dict(aggregator="coord_median"),
    "trimmed_mean": dict(aggregator="trimmed_mean", trim_k=1),
    "krum": dict(aggregator="krum", krum_f=1),
    "multi_krum": dict(aggregator="multi_krum", krum_f=2),
    "norm_median_clip": dict(aggregator="norm_median_clip",
                             guard_reject_mult=5.0),
}
ATTACKS = {
    "collude_signflip": dict(attack="collude_signflip", attack_frac=0.25,
                             attack_scale=10.0),
    "alie": dict(attack="alie", attack_frac=0.25),
    "adaptive": dict(attack="adaptive", attack_frac=0.25, attack_scale=2.0),
    "collude_same_value": dict(attack="collude_same_value",
                               attack_frac=0.25, attack_scale=5.0),
}
_SUBSTRATES = {}


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _substrate(cfg):
    key = substrate_key(cfg)
    if key not in _SUBSTRATES:
        _SUBSTRATES[key] = Substrate.build(cfg)
    return _SUBSTRATES[key]


# ---------------------------------------------------------------------------
# formulas against the reference
# ---------------------------------------------------------------------------


def _attack_operand(seed):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(2, 7, 33)).astype(np.float32)
    att = rng.random((2, 7)) < 0.4
    valid = np.ones((2, 7), bool)
    valid[1, -2:] = False
    att[0, 0] = att[1, -1] = True          # an attacker on an invalid row
    return u, att, valid


@pytest.mark.parametrize("kind", list(ATTACKS))
def test_apply_attack_matches_reference(kind):
    u, att, valid = _attack_operand(len(kind))
    kw = dict(kind=kind, scale=3.0, z=1.5)
    got = apply_attack(*_t(u, att, valid), **kw).numpy()
    want = np.asarray(japply_attack(jnp.asarray(u), jnp.asarray(att),
                                    jnp.asarray(valid), **kw))
    passed = ~(att & valid)
    np.testing.assert_array_equal(got[passed], u[passed])
    if kind in ("collude_signflip", "collude_same_value"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


def test_attack_without_attackers_is_bit_exact():
    u, _, valid = _attack_operand(0)
    none = np.zeros_like(valid)
    for kind in ATTACKS:
        got = apply_attack(*_t(u, none, valid), kind=kind, scale=3.0, z=1.5)
        assert torch.equal(got, torch.from_numpy(u))


def test_attack_and_robust_keys_match_reference():
    cases = [dict(), dict(aggregator="trimmed_mean", trim_k=0),
             dict(aggregator="trimmed_mean", trim_k=2),
             dict(aggregator="coord_median"), dict(aggregator="krum"),
             dict(aggregator="multi_krum", krum_f=0),
             dict(aggregator="multi_krum", krum_f=2),
             dict(aggregator="multi_krum", multi_krum_m=3),
             dict(aggregator="norm_median_clip"),
             dict(aggregator="norm_median_clip", guard_clip=1.0,
                  guard_reject_mult=5.0),
             dict(attack="alie", attack_frac=0.0),
             dict(attack="adaptive", attack_scale=2.0)]
    for kw in cases:
        cfg, jcfg = SimConfig(**BASE, **kw), JConfig(**BASE, **kw)
        assert rob.robust_key(cfg) == jrob.robust_key(jcfg)
        assert attack_key(cfg) == jattack_key(jcfg)
    for bad in (dict(aggregator="bogus"), dict(attack="bogus")):
        with pytest.raises(ValueError, match="unknown"):
            SimConfig(**BASE, **bad)
    with pytest.raises(ValueError):
        AttackSpec("bogus")


@pytest.mark.parametrize("f,m", [(1, 1), (2, None), (1, 3), (0, None), (3, 2)])
def test_krum_select_matches_reference(f, m):
    rng = np.random.default_rng(f * 10 + (0 if m is None else m))
    u = rng.normal(size=(9, 40)).astype(np.float32)
    u[4] *= 20.0                                        # an outlier row
    valid = np.array([True] * 7 + [False, True])
    got = rob.krum_select(*_t(u, valid), f=f, m=m).numpy()
    want = np.asarray(jrob.krum_select(jnp.asarray(u), jnp.asarray(valid),
                                       f=f, m=m))
    np.testing.assert_array_equal(got, want)
    if (8 - f if m is None else m) < 8:        # fewer kept than valid rows
        assert not got[4]


def _cell(seed, n=7, d=300):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, d)).astype(np.float32)
    fresh = np.array([True, True, False, True, False, True, True][:n])
    tau = np.where(fresh, 0, rng.integers(1, 4, n)).astype(np.int32)
    valid = np.ones(n, bool)
    valid[-1] = False
    return u, fresh, tau, valid


@pytest.mark.parametrize("rule_id", [0, 1, 2, 3])
def test_weighted_rows_match_reference(rule_id):
    u, fresh, tau, valid = _cell(rule_id)
    u[2, 5] = np.nan                                   # scrubbed to +inf
    y, c = rob.weighted_rows(*_t(u, fresh, tau, valid), 0.35, rule_id)
    y_j, c_j = jrob.weighted_rows(jnp.asarray(u), jnp.asarray(fresh),
                                  jnp.asarray(tau), jnp.asarray(valid), 0.35,
                                  jnp.int32(rule_id))
    assert int(c) == int(c_j) == valid.sum()
    y_j = np.asarray(y_j)
    np.testing.assert_array_equal(np.isinf(y.numpy()), np.isinf(y_j))
    np.testing.assert_allclose(y.numpy(), y_j, **TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("trim_k,median", [(1, False), (2, False), (9, False),
                                           (0, True)])
def test_trimmed_weighted_aggregate_matches_reference(trim_k, median,
                                                      use_kernel):
    u, fresh, tau, valid = _cell(trim_k + 5 * median)
    out, n_trim = rob.trimmed_weighted_aggregate(
        *_t(u, fresh, tau, valid), 0.35, 3, trim_k=trim_k, median=median,
        use_kernel=use_kernel)
    out_j, n_trim_j = jrob.trimmed_weighted_aggregate(
        jnp.asarray(u), jnp.asarray(fresh), jnp.asarray(tau),
        jnp.asarray(valid), 0.35, jnp.int32(3), trim_k=trim_k, median=median)
    assert int(n_trim) == int(n_trim_j)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **TOL)


def test_trimmed_weighted_aggregate_with_no_valid_row_is_zero():
    u, fresh, tau, _ = _cell(1)
    out, n_trim = rob.trimmed_weighted_aggregate(
        *_t(u, fresh, tau, np.zeros(7, bool)), 0.35, 3, trim_k=1,
        median=False, use_kernel=True)
    assert int(n_trim) == 0 and not out.any()


@pytest.mark.parametrize("clip,reject_mult", [
    (None, 5.0), (1.0, None), (2.0, 3.0), (None, None), (0.5, 1.5)])
def test_screen_rows_matches_reference(clip, reject_mult):
    rng = np.random.default_rng(2)
    u = rng.normal(size=(2, 8, 300)).astype(np.float32) * 0.3
    u[0, 1] *= 40.0                                     # a norm outlier
    u[0, 3, 7] = np.nan                                 # a non-finite row
    u[1, 2, 0] = np.inf
    valid = np.ones((2, 8), bool)
    valid[1, -1] = False
    got = screen_rows(*_t(u, valid), clip=clip, reject_mult=reject_mult)
    want = jagg.screen_rows(jnp.asarray(u), jnp.asarray(valid), clip=clip,
                            reject_mult=reject_mult)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n,rounds,frac,seed", [(30, 8, 0.25, 0),
                                                (100, 40, 0.1, 0),
                                                (17, 5, 0.5, 3)])
def test_attacker_ids_equal_reference(n, rounds, frac, seed):
    plan = FaultPlan(n, rounds, seed=seed).with_attack(
        AttackSpec("collude_signflip", frac=frac))
    jplan = JFaultPlan(n, rounds, seed=seed).with_attack(
        JAttackSpec("collude_signflip", frac=frac))
    lids = np.arange(n)
    for r in range(rounds + 1):
        assert np.array_equal(plan.attackers(r), jplan.attackers(r))
        assert np.array_equal(plan.attack_flags(r, lids),
                              jplan.attack_flags(r, lids))
    assert len(plan.attackers(0)) == math.ceil(frac * n)


# ---------------------------------------------------------------------------
# the simulation against the reference, stage by stage
# ---------------------------------------------------------------------------


def _sync_from_reference(sim, ref):
    """Start the port's round from the reference's params and stale rows."""
    sim.flat_params = torch.tensor(np.asarray(ref.flat_params))
    assert len(sim.stale_cache) == len(ref.stale_cache)
    for fp, fj in zip(sim.stale_cache, ref.stale_cache):
        assert (fp.learner_id, fp.origin_round) == (fj.learner_id,
                                                    fj.origin_round)
        fp.delta = torch.tensor(np.asarray(fj.delta))


@pytest.mark.parametrize("attack", ["collude_signflip", "alie"])
@pytest.mark.parametrize("kind", [k for k in KINDS if k != "saa"])
def test_flat_rounds_match_reference(kind, attack):
    kw = {**BASE, **KINDS[kind], **ATTACKS[attack], "fused_rounds": False}
    ref = JSimulator(JConfig(**kw))
    cfg = SimConfig(**kw)
    sim = Simulator(cfg, Substrate.build(cfg, flat_params0=from_flat(
        ref.substrate.flat_params0)), device="cpu")
    aggregated = 0
    for r in range(cfg.rounds):
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
        assert (t_end_t, len(fresh_t), len(stale_t), list(taus_t), lids_t) \
            == (t_end, len(fresh_j), len(stale_j), list(taus_j), lids)
        if fresh_j or stale_j:
            aggregated += 1
            agg_j = np.asarray(ref._aggregate(r, lids, fresh_j, stale_j,
                                              taus_j))
            agg_t = sim._aggregate(r, lids_t, fresh_t, stale_t, taus_t)
            np.testing.assert_allclose(agg_t.numpy(), agg_j, **STEP_TOL)
            ref._apply_update(agg_j)
            sim._apply_update(agg_t)
            np.testing.assert_allclose(sim.flat_params.numpy(),
                                       np.asarray(ref.flat_params), **STEP_TOL)
        assert sim.robust_counts.tolist() == [ref.acct.robust_rejected,
                                              ref.acct.robust_trimmed]
        rec_j = ref._record_round(r, plan_j.t_now, t_end, len(plan_j.chosen),
                                  len(fresh_j), len(stale_j))
        rec_t = sim._record_round(r, plan_t.t_now, t_end_t,
                                  len(plan_t.chosen), len(fresh_t),
                                  len(stale_t))
        assert tuple(getattr(rec_t, f) for f in HOST) == \
            tuple(getattr(rec_j, f) for f in HOST)
    assert aggregated > 0
    assert any(ref.fault_plan.attack_flags(r, np.arange(30)).any()
               for r in range(cfg.rounds))
    acct = sim._finalize()
    ref_sum = ref._finalize().summary()
    for key in ("robust_rejected", "robust_trimmed"):
        assert acct.summary()[key] == ref_sum[key]


# ---------------------------------------------------------------------------
# port fused == port flat, and the closed-form counts
# ---------------------------------------------------------------------------


def _bits(acct):
    return [tuple(repr(v) for v in dataclasses.astuple(r))
            for r in acct.records]


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("attack", list(ATTACKS))
@pytest.mark.parametrize("kind", list(KINDS))
def test_fused_equals_flat_bitwise(kind, attack, use_kernel):
    kw = {**BASE, **KINDS[kind], **ATTACKS[attack],
          "use_agg_kernel": use_kernel}
    cfg = SimConfig(**kw)
    fused_sim = Simulator(cfg, _substrate(cfg), device="cpu")
    flat_sim = Simulator(SimConfig(**kw, fused_rounds=False), _substrate(cfg),
                         device="cpu")
    fused, flat = fused_sim.run(), flat_sim.run()
    assert sum(r.n_stale for r in flat.records) > 0
    assert _bits(fused) == _bits(flat)
    assert torch.equal(fused_sim.flat_params, flat_sim.flat_params)
    assert repr(fused.summary()) == repr(flat.summary())
    # alie and adaptive are built to pass a norm screen unflagged
    evades = kind == "norm_median_clip" and attack in ("alie", "adaptive")
    if kind != "saa" and not evades:
        assert fused.summary()["robust_rejected"] \
            + fused.summary()["robust_trimmed"] > 0


@pytest.mark.parametrize("kind", ["coord_median", "multi_krum"])
def test_fused_equals_flat_bitwise_under_yogi_in_dl(kind):
    kw = {**BASE, **KINDS[kind], **ATTACKS["collude_signflip"],
          "server_opt": "yogi", "setting": "DL", "deadline": 30.0,
          "use_agg_kernel": True}
    cfg = SimConfig(**kw)
    fused_sim = Simulator(cfg, _substrate(cfg), device="cpu")
    flat_sim = Simulator(SimConfig(**kw, fused_rounds=False), _substrate(cfg),
                         device="cpu")
    assert _bits(fused_sim.run()) == _bits(flat_sim.run())
    assert torch.equal(fused_sim.flat_params, flat_sim.flat_params)
    for k in ("m", "v", "t"):
        assert torch.equal(fused_sim.flat_opt_state[k],
                           flat_sim.flat_opt_state[k])


def test_robust_run_keeps_the_true_width():
    """Attacked and robust runs keep D unpadded under the kernel flag (the
    reference's layout), so every row reduction sees true-D rows."""
    from repro_torch.sim.pipeline import RoundPipeline
    kw = {**BASE, **KINDS["coord_median"], "use_agg_kernel": True}
    cfg = SimConfig(**kw)
    pipe = RoundPipeline(Simulator(cfg, _substrate(cfg), device="cpu"))
    assert pipe.d_pad == pipe.d
    plain = SimConfig(**BASE, use_agg_kernel=True)
    assert RoundPipeline(Simulator(plain, _substrate(plain),
                                   device="cpu")).d_pad > pipe.d


@pytest.mark.parametrize("fused", [True, False])
def test_multi_krum_rejects_exactly_f_per_round(fused):
    f = 2
    cfg = SimConfig(**BASE, aggregator="multi_krum", krum_f=f,
                    fused_rounds=fused)
    acct = Simulator(cfg, _substrate(cfg), device="cpu").run()
    s = acct.summary()
    expected = sum(min(f, max(rec.n_fresh + rec.n_stale - 1, 0))
                   for rec in acct.records)
    assert s["robust_rejected"] == expected > 0
    assert s["robust_trimmed"] == 0


@pytest.mark.parametrize("fused", [True, False])
def test_trimmed_mean_trims_exactly_2k_per_round(fused):
    k = 1
    cfg = SimConfig(**BASE, aggregator="trimmed_mean", trim_k=k,
                    fused_rounds=fused)
    acct = Simulator(cfg, _substrate(cfg), device="cpu").run()
    s = acct.summary()
    expected = sum(2 * min(k, max(rec.n_fresh + rec.n_stale - 1, 0) // 2)
                   for rec in acct.records)
    assert s["robust_trimmed"] == expected > 0
    assert s["robust_rejected"] == 0


def test_norm_screen_rejects_exactly_the_scheduled_attackers():
    n, d, rounds = 16, 32, 6
    plan = FaultPlan(n, rounds, seed=4).with_attack(
        AttackSpec("collude_signflip", frac=0.25, scale=1e3))
    rng = np.random.default_rng(0)
    total = 0
    for r in range(rounds):
        u = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32) * 0.1)
        att = plan.attack_flags(r, np.arange(n))
        out, counts = rob.robust_host_aggregate(
            u, np.ones(n, bool), np.zeros(n, np.int32), att,
            attack=("collude_signflip", 1e3, 1.5),
            robust=("norm_median_clip", None, 5.0), use_kernel=True,
            beta=0.4, rule="equal")
        assert counts.tolist() == [int(att.sum()), 0]
        assert int(att.sum()) == len(plan.attackers(r))
        assert torch.isfinite(out).all()
        total += int(counts[0])
    assert total == math.ceil(0.25 * n) * rounds


def test_coord_median_beats_attacked_saa_in_the_chaos_race():
    """``examples/chaos_round.py``'s robustness race at its smoke size, on
    the port: coord_median trims rows and ends above attacked saa."""
    race = dict(n_learners=40, rounds=10, eval_every=5, n_target=10,
                selector="priority", saa=True, scaling_rule="relay",
                mapping="label_uniform", seed=0, setting="DL", deadline=1e6,
                attack="collude_signflip", attack_frac=0.1, attack_scale=50.0,
                use_agg_kernel=True)
    sub = _substrate(SimConfig(**race))
    under = Simulator(SimConfig(**race), sub, device="cpu").run().summary()
    defended = Simulator(SimConfig(**race, aggregator="coord_median"), sub,
                         device="cpu").run().summary()
    assert defended["robust_trimmed"] > 0
    assert defended["final_accuracy"] > under["final_accuracy"]
