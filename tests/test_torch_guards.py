"""The chaos harness's fault plans and the guard (``SimConfig.guard``,
``guard_clip``, ``guard_reject_mult``, ``quorum``) in the port, on the CPU,
held against the JAX package and within the port.

Against the reference, on the same seeded inputs (the reference's initial
weights injected, its Pallas kernels in interpret mode):

- ``screen_rows`` with ``norm_d`` on a block-padded operand: counts ``==``,
  rows within 1e-6;
- ``guarded_aggregate_flat``: counts and the quorum verdict ``==``, the
  aggregate within rtol 1e-5 / atol 1e-6;
- every guard mode (guard=off, guard, reject, clip+reject) under the chaos
  plan (nan, inf, scale x1e4, post_drop, replay), and the post_drop and
  replay plans alone, on the fused pipeline and the flat path: every
  RoundRecord's host fields and the summary's host fields (guard counters
  included) ``==``; final params within atol 1e-5 of the reference's
  (``tests/test_torch_pipeline.py``'s free-running tolerance), or, where
  scaled rows reach the model (guard on without the norm rule), within
  rtol 1e-4 of its scale.

Within the port, bit for bit: a guard that rejects nothing equals no
guard (fused, K = 4, flat, kernel, YoGi); fused == flat under NaN faults
with the kernels off; K = 4 == K = 1 under guard + faults; batched sweeps
== serial runs.  And the two faults this slice found: a replayed entry's
slot is freed once, and the guard and the corruption multiplier key the
CUDA graph workspace.
"""
import contextlib
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.faults import FaultPlan as JPlan
from repro.faults import FaultSpec as JSpec
from repro.sim import SimConfig as JConfig
from repro.sim import Simulator as JSimulator
from repro.sweeps import SweepRunner as JSweepRunner
from repro.sweeps import SweepSpec as JSweepSpec
from repro_torch.core import aggregation as tagg
from repro_torch.kernels.staleness_agg import ops as agg_ops
from repro_torch.faults import FaultPlan, FaultSpec
from repro_torch.sim import SimConfig, Simulator, Substrate
from repro_torch.sim.engine import substrate_key
from repro_torch.sim import graphs as tgraphs
from repro_torch.sim import pipeline as pl
from repro_torch.sweeps import SweepRunner, SweepSpec, compat_key
from repro_torch.sweeps.runner import summaries_equal
from repro_torch.weights import from_flat

torch.set_num_threads(1)

# static availability: every round's cohort is full (8 learners, 6 fresh)
BASE = dict(n_learners=30, rounds=8, eval_every=4, n_target=6, saa=True,
            selector="priority", mapping="label_uniform",
            dynamic_availability=False)
# examples/chaos_round.py's plan, denser so 8 rounds of 30 learners see
# every kind: seed 2 rejects rows as non-finite and as norm outliers
CHAOS = (("nan", dict(prob=0.15)), ("inf", dict(prob=0.05)),
         ("scale", dict(prob=0.15, scale=1e4)),
         ("post_drop", dict(prob=0.1)), ("replay", dict(prob=0.3)))
PLANS = {"chaos": (CHAOS, 2),
         "post_drop": ((("post_drop", dict(prob=0.3)),), 5),
         "replay": ((("replay", dict(prob=0.5)),), 9)}
GUARD_MODES = {
    "off": dict(),
    "guard": dict(guard=True),
    "reject": dict(guard=True, guard_reject_mult=5.0, quorum=1),
    "clip_reject": dict(guard=True, guard_clip=1.0, guard_reject_mult=5.0,
                        quorum=1),
}
HOST = ("round_idx", "sim_time", "n_selected", "n_fresh", "n_stale",
        "resource_used", "resource_wasted", "unique_participants")
HOST_SUMMARY = ("rounds", "sim_time", "resource_used", "resource_wasted",
                "unique_participants", "stopped_early", "rejected_nonfinite",
                "rejected_norm", "quorum_skips", "robust_rejected",
                "robust_trimmed")


def _plan(name, spec_cls=FaultSpec, plan_cls=FaultPlan, **kw):
    specs, seed = PLANS[name]
    return plan_cls(BASE["n_learners"], BASE["rounds"],
                    specs=tuple(spec_cls(k, **a) for k, a in specs),
                    seed=seed, **kw)


def _cfg(**kw):
    return SimConfig(**{**BASE, **kw})


def _run(plan=None, **kw):
    sim = Simulator(_cfg(**kw), device="cpu",
                    fault_plan=None if plan is None else _plan(plan))
    return sim, sim.run()


@functools.lru_cache(maxsize=None)
def _reference(plan, kw: tuple):
    sim = JSimulator(JConfig(**{**BASE, **dict(kw)}),
                     fault_plan=_plan(plan, JSpec, JPlan))
    acct = sim.run()
    return sim, acct


def _host(rec):
    return tuple(getattr(rec, f) for f in HOST)


def _int_view(t):
    return t.contiguous().view(torch.int32)


def _same(a, sim_a, b, sim_b):
    return (summaries_equal(a.summary(), b.summary())
            and [repr(r) for r in a.records] == [repr(r) for r in b.records]
            and torch.equal(_int_view(sim_a.flat_params),
                            _int_view(sim_b.flat_params)))


# ---------------------------------------------------------------------------
# screen_rows (norm_d) and guarded_aggregate_flat against the reference
# ---------------------------------------------------------------------------


def _operand(rng, g, n, d, pad):
    u = rng.normal(size=(g, n, d)).astype(np.float32) * 0.1
    u[0, 1, 3] = np.nan
    u[1, 0] *= 1e4
    u[1, 2, 5] = np.inf
    u[2, :] *= 3.0
    valid = rng.uniform(size=(g, n)) < 0.8
    valid[:, 0] = True
    up = np.zeros((g, n, d + pad), np.float32)
    up[..., :d] = u
    return up, valid


@pytest.mark.parametrize("clip,reject_mult", [(None, None), (None, 5.0),
                                              (1.0, None), (0.5, 3.0)])
def test_screen_rows_norm_d_matches_reference(clip, reject_mult):
    """A block-padded operand screened over its true D: the reference's
    counts exactly, its rows within 1e-6; and bit for bit the port's
    screen of the true-width slice."""
    rng = np.random.default_rng(11)
    d = 300
    up, valid = _operand(rng, 3, 7, d, 212)
    got = tagg.screen_rows(torch.from_numpy(up), torch.from_numpy(valid),
                           clip=clip, reject_mult=reject_mult, norm_d=d)
    want = jagg.screen_rows(jnp.asarray(up), jnp.asarray(valid), clip=clip,
                            reject_mult=reject_mult, norm_d=d)
    for a, b in zip(got[1:], want[1:]):
        assert a.tolist() == np.asarray(b).tolist()
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-6)
    assert got[2].sum() > 0 and not got[0][..., d:].any()
    narrow = tagg.screen_rows(torch.from_numpy(up[..., :d].copy()),
                              torch.from_numpy(valid), clip=clip,
                              reject_mult=reject_mult)
    assert torch.equal(_int_view(got[0][..., :d].contiguous()),
                       _int_view(narrow[0]))
    for a, b in zip(got[1:], narrow[1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["clean", "screened", "quorum"])
@pytest.mark.parametrize("kernel", [False, True])
def test_guarded_aggregate_flat_matches_reference(case, kernel):
    rng = np.random.default_rng(5)
    n, d = 9, 2100
    u = rng.normal(size=(n, d)).astype(np.float32) * 0.1
    if case != "clean":
        u[2, 7] = np.nan
        u[5] *= 1e4
    fresh = np.arange(n) < 5
    tau = np.where(fresh, 0, rng.integers(1, 4, n)).astype(np.int32)
    kw = dict(rule="relay", beta=0.35, use_kernel=kernel,
              clip=None if case == "clean" else 2.0,
              reject_mult=None if case == "clean" else 5.0,
              quorum=8 if case == "quorum" else 1)
    agg, w, info = tagg.guarded_aggregate_flat(
        torch.from_numpy(u), torch.from_numpy(fresh), torch.from_numpy(tau),
        **kw)
    ragg, rw, rinfo = jagg.guarded_aggregate_flat(u, fresh, tau, **kw)
    assert info == rinfo
    assert info["applied"] == (case != "quorum")
    np.testing.assert_allclose(agg.numpy(), np.asarray(ragg), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(rw)[:n], rtol=1e-5,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# Whole runs against the reference
# ---------------------------------------------------------------------------


def _against_reference(plan, kw):
    ref_sim, ref = _reference(plan, tuple(sorted(kw.items())))
    cfg = _cfg(**kw)
    sub = Substrate.build(cfg, flat_params0=from_flat(
        ref_sim.substrate.flat_params0))
    sim = Simulator(cfg, sub, device="cpu", fault_plan=_plan(plan))
    acct = sim.run()
    assert [_host(r) for r in acct.records] == [_host(r) for r in ref.records]
    s, rs = acct.summary(), ref.summary()
    assert {k: s[k] for k in HOST_SUMMARY} == {k: rs[k] for k in HOST_SUMMARY}
    got, want = sim.flat_params.numpy(), np.asarray(ref_sim.flat_params)
    fin = want[np.isfinite(want)]
    scale = np.abs(fin).max() if fin.size else 0.0
    if scale < 10:                  # no scaled row reached the model
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)
    return s


@pytest.mark.parametrize("substrate", ["fused", "flat"])
@pytest.mark.parametrize("mode", list(GUARD_MODES))
def test_guard_modes_match_reference(mode, substrate):
    kw = dict(GUARD_MODES[mode], fused_rounds=substrate == "fused")
    s = _against_reference("chaos", kw)
    if mode != "off":
        assert s["rejected_nonfinite"] > 0
    if "guard_reject_mult" in kw:
        assert s["rejected_norm"] > 0


@pytest.mark.parametrize("substrate", ["fused", "flat"])
@pytest.mark.parametrize("plan", ["post_drop", "replay"])
def test_drop_and_replay_plans_match_reference(plan, substrate):
    _against_reference(plan, dict(fused_rounds=substrate == "fused"))


def test_guarded_attack_and_robust_match_reference():
    """attack -> guard screen -> robust mask -> weights, as the
    reference's robust program orders them."""
    kw = dict(aggregator="coord_median", attack="collude_signflip",
              guard=True, guard_reject_mult=5.0, setting="DL",
              deadline=1e6)
    s = _against_reference("chaos", kw)
    assert s["rejected_nonfinite"] > 0 and s["robust_trimmed"] > 0


def test_guarded_kernel_route_matches_reference():
    s = _against_reference("chaos", dict(GUARD_MODES["clip_reject"],
                                         use_agg_kernel=True))
    assert s["rejected_norm"] > 0


def _spy(monkeypatch, module, name):
    """Record the arguments of every call to ``module.name``."""
    calls, real = [], getattr(module, name)

    def spy(*a, **k):
        calls.append((a, k))
        return real(*a, **k)
    monkeypatch.setattr(module, name, spy)
    return calls


def test_guarded_flat_kernel_route_runs_kernel_3_every_round(monkeypatch):
    """The flat path's guarded rounds all go to ``fused_staleness_aggregate``
    (kernel 3), screened ones with the survivor mask as ``valid`` and
    ``fresh`` masked by it, and the run still matches the reference's
    (whose screened rounds take its plain masked weights)."""
    calls = _spy(monkeypatch, agg_ops, "fused_staleness_aggregate")
    s = _against_reference("chaos", dict(GUARD_MODES["clip_reject"],
                                         use_agg_kernel=True,
                                         fused_rounds=False))
    assert s["rejected_nonfinite"] > 0 and s["rejected_norm"] > 0
    assert len(calls) == s["rounds"]          # every round has a group
    holes = [k["valid"] for _, k in calls if not k["valid"].all()]
    assert holes
    for (_, fresh, *_), k in calls:
        assert not (fresh & ~k["valid"]).any()


def _port_substrates(ref_cache):
    cache = {}
    for sub in ref_cache.values():
        cfg = SimConfig(n_learners=sub.key[2], seed=sub.key[3],
                        mapping=sub.key[1], benchmark=sub.key[0],
                        dynamic_availability=sub.key[4])
        cache[substrate_key(cfg)] = Substrate.build(
            cfg, flat_params0=from_flat(sub.flat_params0))
    return cache


@pytest.mark.parametrize("kernel", [False, True])
def test_guarded_per_stage_sweep_matches_reference(kernel, monkeypatch):
    """The per-stage sweep screens its padded operand once a round and
    aggregates every cell's survivors in one call (kernel 2 under the
    kernels), as the reference's per-stage sweep does: host records and
    guard counters ``==`` the reference sweep's."""
    from repro_torch.sweeps import runner as runner_mod
    base = dict(BASE, **GUARD_MODES["clip_reject"], fused_rounds=False,
                use_agg_kernel=kernel)
    axes = {"saa": [False, True]}
    jrunner = JSweepRunner(JSweepSpec(axes=axes, base=base,
                                      seeds=(0, 1)).expand(),
                           fault_plan=_plan("chaos", JSpec, JPlan))
    ref = jrunner.run()
    screens = _spy(monkeypatch, runner_mod, "screen_rows")
    aggs = _spy(monkeypatch, agg_ops, "sweep_staleness_aggregate")
    cells = SweepSpec(axes=axes, base=base, seeds=(0, 1)).expand()
    runner = SweepRunner(cells, device="cpu", fault_plan=_plan("chaos"),
                         substrate_cache=_port_substrates(
                             jrunner.substrate_cache))
    mine = runner.run()
    # one screen and at most one aggregate a batch round, over its cells
    calls = BASE["rounds"] * len({compat_key(c.config) for c in cells})
    assert calls < BASE["rounds"] * len(cells)
    assert len(screens) == calls
    assert sum(a[0].shape[0] for a, _ in screens) == BASE["rounds"] * len(cells)
    assert len(aggs) == (calls if kernel else 0)
    for a, b in zip(mine, ref):
        assert [_host(r) for r in a.acct.records] == \
            [_host(r) for r in b.acct.records]
        assert {k: a.summary[k] for k in HOST_SUMMARY} == \
            {k: b.summary[k] for k in HOST_SUMMARY}
    assert mine.guard_totals() == ref.guard_totals()
    assert mine.guard_totals()["rejected_norm"] > 0


# ---------------------------------------------------------------------------
# Within the port, bit for bit
# ---------------------------------------------------------------------------


SUBSTRATES = {"fused": {}, "chunked": {"rounds_per_dispatch": 4},
              "flat": {"fused_rounds": False},
              "kernel": {"use_agg_kernel": True},
              "yogi": {"server_opt": "yogi", "use_agg_kernel": True}}


@pytest.mark.parametrize("sub", list(SUBSTRATES))
def test_guard_without_faults_is_bit_identical(sub):
    a, acct_a = _run(**SUBSTRATES[sub])
    b, acct_b = _run(guard=True, quorum=1, **SUBSTRATES[sub])
    assert _same(acct_a, a, acct_b, b)
    s = acct_b.summary()
    assert (s["rejected_nonfinite"], s["rejected_norm"],
            s["quorum_skips"]) == (0, 0, 0)


@pytest.mark.parametrize("mode", ["guard", "reject", "clip_reject"])
@pytest.mark.parametrize("yogi", [False, True])
def test_fused_equals_flat_under_faults_with_kernels_off(mode, yogi):
    kw = dict(GUARD_MODES[mode], server_opt="yogi" if yogi else "fedavg")
    a, acct_a = _run("chaos", **kw)
    b, acct_b = _run("chaos", fused_rounds=False, **kw)
    assert _same(acct_a, a, acct_b, b)
    assert acct_a.summary()["rejected_nonfinite"] > 0


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("yogi", [False, True])
def test_chunked_guarded_faulted_matches_single_dispatch(kernel, yogi):
    kw = dict(GUARD_MODES["clip_reject"], use_agg_kernel=kernel,
              server_opt="yogi" if yogi else "fedavg")
    a, acct_a = _run("chaos", **kw)
    b, acct_b = _run("chaos", rounds_per_dispatch=4, **kw)
    assert _same(acct_a, a, acct_b, b)


def test_unguarded_run_diverges_under_nan_faults():
    _, grd = _run("chaos", guard=True)
    raw_sim, raw = _run("chaos")
    assert grd.summary()["rejected_nonfinite"] > 0
    assert not torch.isfinite(raw_sim.flat_params).all()
    assert math.isfinite(grd.summary()["final_accuracy"])


@pytest.mark.parametrize("fused", [True, False])
def test_quorum_skips_round_and_carries_params(fused):
    """Every row poisoned in rounds 0-3: no survivor, the apply skipped and
    counted, the params untouched; the run ends finite."""
    plan = FaultPlan(BASE["n_learners"], BASE["rounds"],
                     specs=(FaultSpec("nan", prob=1.0, rounds=(0, 3)),))
    sim = Simulator(_cfg(guard=True, fused_rounds=fused), device="cpu",
                    fault_plan=plan)
    start = sim.flat_params.clone()
    pipe = pl.RoundPipeline(sim) if fused else None
    for r in range(3):
        if fused:
            pipe.step(r)
        else:
            sim._flat_round(r, False)
    now = pipe.params[0, :pipe.d] if fused else sim.flat_params
    assert torch.equal(now, start)
    s = (pipe.finalize()[0] if fused else sim._finalize()).summary()
    assert s["quorum_skips"] >= 1 and s["rejected_nonfinite"] > 0


def test_byzantine_scale_rows_rejected_by_norm_rule():
    plan = FaultPlan(BASE["n_learners"], BASE["rounds"],
                     specs=(FaultSpec("scale", prob=0.25, scale=1e4),), seed=1)
    sim = Simulator(_cfg(guard=True, guard_reject_mult=5.0), device="cpu",
                    fault_plan=plan)
    s = sim.run().summary()
    assert s["rejected_norm"] > 0 and math.isfinite(s["final_accuracy"])


@pytest.mark.parametrize("fused", [True, False])
def test_guarded_sweep_batched_equals_serial(fused):
    spec = SweepSpec(axes={"policy": ["random", "relay"],
                           "saa": [False, True]},
                     base=dict(BASE, **GUARD_MODES["clip_reject"],
                               fused_rounds=fused), seeds=(0,))
    cells = spec.expand()
    runner = SweepRunner(cells, device="cpu", fault_plan=_plan("chaos"))
    res = runner.run()
    for c, got, sim in zip(cells, res, runner.sims):
        one = Simulator(c.config, device="cpu", fault_plan=_plan("chaos"))
        acct = one.run()
        assert _same(got.acct, sim, acct, one), c.name
    totals = res.guard_totals()
    assert set(totals) == {"rejected_nonfinite", "rejected_norm",
                           "quorum_skips"}
    assert totals["rejected_nonfinite"] > 0


# ---------------------------------------------------------------------------
# The two faults found while planning this slice
# ---------------------------------------------------------------------------


def test_replayed_entry_frees_its_slot_once():
    """A replay lands one in-flight entry twice in a round; its cache slot
    is freed once (freeing it twice raised KeyError in the slot space, or
    handed one slot to two stragglers)."""
    from repro_torch.sim.engine import RoundSchedule, _InFlight
    f, g = _InFlight(1, 0, 1.0, 1.0, 7, 0.0), _InFlight(2, 0, 1.0, 1.0, 3, 0.0)
    sched = RoundSchedule(0.0, [], [], [f, f, g], [1, 1, 1], [], [])
    assert pl._quarantine_frees([0], {0: sched}) == [7, 3]
    sim, acct = _run("replay")
    again, acct2 = _run("replay", fused_rounds=False)
    assert _same(acct, sim, acct2, again)
    assert sum(r.n_stale for r in acct.records) > 0


class _Stream:
    def wait_stream(self, other):
        pass


def test_guard_and_faults_key_the_graph_workspace(monkeypatch):
    """Graphs outlive a pipeline; a guarded or faulted pipeline never
    takes the workspace (and graphs) of one captured without the screen or
    the multiplier, and a pipeline of the same structure still does."""
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: _Stream())
    kernel = dict(use_agg_kernel=True)

    def workspace(plan=None, **kw):
        sim = Simulator(_cfg(**kernel, **kw), device="cpu",
                        fault_plan=None if plan is None else _plan(plan))
        pipe = pl.RoundPipeline(sim)
        return pipe._workspace(sim.cfg)
    plain = workspace()
    tgraphs.release(plain)
    guarded = workspace(guard=True)
    tgraphs.release(guarded)
    faulted = workspace("chaos")
    tgraphs.release(faulted)
    assert len({id(plain), id(guarded), id(faulted)}) == 3
    assert workspace() is plain and workspace("chaos") is faulted
    assert workspace(guard=True) is guarded
    with contextlib.suppress(KeyError):
        for ws in (plain, guarded, faulted):
            tgraphs._IDLE.pop(ws.key)


def test_chaos_round_smoke_passes_on_cpu(capsys):
    """``python -m repro_torch.chaos_round --smoke``: the guarded modes
    land near clean and reject rows, coord_median beats attacked saa, and
    the crash -> resume phase ends bit for bit."""
    from repro_torch import chaos_round
    assert chaos_round.main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "bit for bit" in out and out.rstrip().endswith("OK")
