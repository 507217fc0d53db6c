"""The slice as a whole — the quickstart's Random and RELAY campaigns with
the SAA kernel on, at 30 learners and 8 rounds — held against the JAX
reference on the CPU, starting from the reference's initial weights.

Host fields of every RoundRecord must be equal.  Floats are held to stated
tolerances:
  - per round, from the reference's params: the port's round must land
    within rtol 1e-4 / atol 1e-6 of the reference's per-stage flat path
    (``fused_rounds=False``, which the reference holds bit-identical to its
    fused path) — one round of fp32 training and SAA, summed in other
    orders;
  - free-running over the whole run: final params within atol 1e-5, eval
    loss within rtol 1e-5 and accuracy within one test sample.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.sim import SimConfig as JConfig
from repro.sim import Simulator as JSimulator
from repro_torch.sim import SimConfig, Simulator, Substrate
from repro_torch.sim.pipeline import RoundPipeline
from repro_torch.weights import from_flat

torch.set_num_threads(1)

BASE = dict(n_learners=30, rounds=8, eval_every=4, seed=2, n_target=4,
            mapping="label_uniform", use_agg_kernel=True)
CAMPAIGNS = {
    "random": dict(selector="random"),
    "relay": dict(selector="priority", saa=True, apt=True, scaling_rule="relay"),
}
# the slice's other options, held round by round
VARIANTS = {
    "dl_fedprox_dynsgd": dict(selector="priority", saa=True, setting="DL",
                              deadline=60.0, prox_mu=0.01,
                              scaling_rule="dynsgd"),
    "plain_server_path": dict(selector="priority", saa=True, apt=True,
                              use_agg_kernel=False),
}
HOST = ("round_idx", "sim_time", "n_selected", "n_fresh", "n_stale",
        "resource_used", "resource_wasted", "unique_participants")


def _port_sim(cfg_kw, ref_sim):
    cfg = SimConfig(**cfg_kw)
    sub = Substrate.build(cfg, flat_params0=from_flat(
        ref_sim.substrate.flat_params0))
    return Simulator(cfg, sub, device="cpu")


def _host(rec):
    return tuple(getattr(rec, f) for f in HOST)


@pytest.mark.parametrize("camp", list(CAMPAIGNS))
def test_slice_matches_reference_end_to_end(camp):
    kw = {**BASE, **CAMPAIGNS[camp]}
    ref_sim = JSimulator(JConfig(**kw))
    ref = ref_sim.run()
    sim = _port_sim(kw, ref_sim)
    port = sim.run()
    assert [_host(r) for r in port.records] == [_host(r) for r in ref.records]
    if camp == "relay":      # the config exercises stale landings
        assert sum(r.n_stale for r in ref.records) > 0
    evals = [(a, b) for a, b in zip(port.records, ref.records)
             if b.accuracy == b.accuracy]
    assert len(evals) == 2
    n_test = len(sim.data.y_test)
    for a, b in evals:
        assert abs(a.accuracy - b.accuracy) <= 1.0 / n_test
        np.testing.assert_allclose(a.loss, b.loss, rtol=1e-5)
    np.testing.assert_allclose(sim.flat_params.numpy(),
                               np.asarray(ref_sim.flat_params), atol=1e-5)
    assert port.summary().keys() == ref.summary().keys()
    assert port.summary()["unique_participants"] == \
        ref.summary()["unique_participants"]


@pytest.mark.parametrize("camp", list(CAMPAIGNS) + list(VARIANTS))
def test_slice_rounds_match_reference_per_stage(camp):
    """Each round starts from the reference's params; the port's round
    result is compared with the reference's per-stage flat path, driven
    stage by stage."""
    kw = {**BASE, **CAMPAIGNS.get(camp, VARIANTS.get(camp))}
    ref = JSimulator(JConfig(**{**kw, "fused_rounds": False}))
    sim = _port_sim(kw, ref)
    pipe = RoundPipeline(sim)
    d = pipe.d
    for r in range(kw["rounds"]):
        pipe.params[0, :d] = torch.from_numpy(np.array(ref.flat_params))
        plan = ref._begin_round(r)
        rec, = pipe.step(r)
        assert (plan is None) == (rec is None)
        if plan is None:
            continue
        deltas, losses, l2s = ref._train(plan)
        t_end, fresh, stale, taus, lids = ref._collect_updates(
            r, plan, deltas, losses, l2s)
        if fresh or stale:
            ref._apply_update(ref._aggregate(r, lids, fresh, stale, taus))
        ref_rec = ref._record_round(r, plan.t_now, t_end, len(plan.chosen),
                                    len(fresh), len(stale))
        assert _host(rec) == _host(ref_rec)
        np.testing.assert_allclose(pipe.params[0, :d].numpy(),
                                   np.asarray(ref.flat_params),
                                   rtol=1e-4, atol=1e-6)
        assert not pipe.params[0, d:].any()      # pad columns stay zero
    pipe.finalize()
    assert ref.rng.bit_generator.state == sim.rng.bit_generator.state


def test_kernel_route_matches_plain_route():
    """use_agg_kernel=False runs core.aggregation's torch path; both
    routes make the same host decisions and nearly the same model."""
    kw = {**BASE, **CAMPAIGNS["relay"]}
    a_sim = Simulator(SimConfig(**kw), device="cpu")
    b_sim = Simulator(SimConfig(**{**kw, "use_agg_kernel": False}), device="cpu")
    a, b = a_sim.run(), b_sim.run()
    assert [_host(r) for r in a.records] == [_host(r) for r in b.records]
    np.testing.assert_allclose(a_sim.flat_params.numpy(),
                               b_sim.flat_params.numpy(), atol=1e-5)


def test_early_stop_matches_reference():
    kw = {**BASE, **CAMPAIGNS["relay"], "target_accuracy": 0.05}
    ref_sim = JSimulator(JConfig(**kw))
    ref = ref_sim.run()
    port = _port_sim(kw, ref_sim).run()
    assert port.stopped_early and ref.stopped_early
    assert [_host(r) for r in port.records] == [_host(r) for r in ref.records]


def test_cache_growth_keeps_results():
    """A one-slot stale cache grows under the run and changes nothing."""
    kw = {**BASE, **CAMPAIGNS["relay"]}
    a_sim = Simulator(SimConfig(**kw), device="cpu")
    b_sim = Simulator(SimConfig(**{**kw, "stale_cache_capacity": 1}),
                      device="cpu")
    a, b = a_sim.run(), b_sim.run()
    assert [dataclasses.astuple(r) for r in a.records] == \
        [dataclasses.astuple(r) for r in b.records]
    assert torch.equal(a_sim.flat_params, b_sim.flat_params)
