"""Telemetry in the port (``repro_torch.telemetry``), on the CPU, held
against the JAX package's and within the port.

Against the reference:

- the pinned schema tuples ``==`` the reference's, and the registry's
  Prometheus text, the JSONL serialization and the tracer's export behave
  as the reference's on the same calls;
- the round events of the same config on the same initial weights (the
  reference's, injected): keys in order, every int field, ``sim_time`` and
  the resource fields ``==``; the l2 columns within rtol 2e-6 (fp32 row
  norms reduced in another order); accuracy within one test sample and
  loss within rtol 1e-5 (``tests/test_torch_pipeline.py``'s free-running
  tolerance).  Fused, K = 4 chunks, the kernel route, guard + a chaos
  fault plan (the ``fault`` events ``==`` too), coord_median under
  ``collude_signflip`` (the robust columns), guarded multi_krum under
  faults, and oort (a feedback selector's one-round chunks).

Within the port, bit for bit: level 2 leaves params (int32 views),
records and summaries as level 0 leaves them on the fused, chunked, kernel,
guarded and robust routes; the guard counters have one writer (the
session's registry), so ``metrics.prom``, ``PipelineStats.guard`` and the
accountings agree; level 1 on the per-stage flat route writes spans and no
round log; ``SweepResults.round_logs``; the lane flag keys the graph
workspace; the lane reaches the host in one copy a chunk, counted in
``d2h_bytes``.
"""
import dataclasses
import functools
import json
import math
import re

import numpy as np
import pytest
import torch

import repro.telemetry as jtel
from repro.faults import FaultPlan as JPlan
from repro.faults import FaultSpec as JSpec
from repro.sim import SimConfig as JConfig
from repro.sim import Simulator as JSimulator
from repro.telemetry import schema as jschema
from repro_torch.faults import FaultPlan, FaultSpec
from repro_torch.sim import SimConfig, Simulator, Substrate
from repro_torch.sim import graphs as tgraphs
from repro_torch.sim import pipeline as pl
from repro_torch.sweeps import SweepRunner, SweepSpec
from repro_torch.sweeps.runner import summaries_equal
from repro_torch.telemetry import (JsonlWriter, MetricsRegistry,
                                   TelemetrySession, Tracer, dumps_event,
                                   write_prometheus)
from repro_torch.telemetry import schema
from repro_torch.telemetry.registry import CounterView
from repro_torch.weights import from_flat

torch.set_num_threads(1)

BASE = dict(n_learners=30, rounds=8, eval_every=4, n_target=6, saa=True,
            selector="priority", mapping="label_uniform",
            dynamic_availability=False)
CHAOS = (("nan", dict(prob=0.15)), ("inf", dict(prob=0.05)),
         ("scale", dict(prob=0.15, scale=1e4)),
         ("post_drop", dict(prob=0.1)), ("replay", dict(prob=0.3)))
GUARD = dict(guard=True, guard_reject_mult=5.0, quorum=1)
ATTACK = dict(aggregator="coord_median", attack="collude_signflip",
              attack_frac=0.25, attack_scale=10.0)
# config overrides, and whether the chaos plan runs
CONFIGS = {
    "fused": ({}, False),
    "chunked": ({"rounds_per_dispatch": 4}, False),
    "kernel": ({"use_agg_kernel": True}, False),
    "guard_faults": (GUARD, True),
    "guard_faults_kernel_k4": (dict(GUARD, use_agg_kernel=True,
                                    rounds_per_dispatch=4), True),
    "coord_median_attack": (ATTACK, False),
    "krum_guard_faults": (dict(aggregator="multi_krum", krum_f=1,
                               guard=True), True),
    "oort": ({"selector": "oort"}, False),
}
L2_RTOL = 2e-6
PINNED = ("LANE_FIELDS", "LANE_WIDTH", "N_LANE_HOST", "LANE_INT_FIELDS",
          "ROUND_EVENT_KEYS", "GUARD_COUNTERS", "PIPELINE_COUNTERS",
          "DISPATCH_KINDS", "SPAN_NAMES")


def _plan(cls=FaultPlan, spec=FaultSpec, **kw):
    return cls(BASE["n_learners"], BASE["rounds"],
               specs=tuple(spec(k, **a) for k, a in CHAOS), seed=2, **kw)


def _cfg(level=2, **kw):
    return SimConfig(**{**BASE, **kw, "telemetry": level})


def _int_view(t):
    return t.contiguous().view(torch.int32)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's level-2 run of ``CONFIGS[name]``: (Simulator,
    Accounting, its events.jsonl lines)."""
    import tempfile
    kw, faulted = CONFIGS[name]
    sim = JSimulator(JConfig(**{**BASE, **kw, "telemetry": 2}),
                     fault_plan=_plan(JPlan, JSpec) if faulted else None)
    with tempfile.TemporaryDirectory() as d:
        sess = jtel.TelemetrySession(d)
        acct = sim.run(telemetry=sess)
        sess.close()
        with open(f"{d}/events.jsonl") as fh:
            events = [json.loads(line) for line in fh]
    return sim, acct, events


def _port(name, level=2, telemetry=None, weights=True):
    """The port's run of ``CONFIGS[name]`` at ``level`` (on the
    reference's initial weights): (Simulator, Accounting)."""
    kw, faulted = CONFIGS[name]
    cfg = _cfg(level, **kw)
    sub = (Substrate.build(cfg, flat_params0=from_flat(
        _reference(name)[0].substrate.flat_params0)) if weights else None)
    sim = Simulator(cfg, sub, device="cpu",
                    fault_plan=_plan() if faulted else None)
    return sim, sim.run(telemetry=telemetry)


# ---------------------------------------------------------------------------
# The pinned schema and the sinks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", PINNED)
def test_pinned_tuples_equal_the_reference(name):
    assert getattr(schema, name) == getattr(jschema, name)


def test_lane_schema_is_pinned():
    assert schema.LANE_FIELDS == (
        "round", "sim_time", "cohort", "fresh", "stale_landed",
        "cache_occupancy", "l2_min", "l2_mean", "l2_max", "nonfinite_rows",
        "rejected_nonfinite", "rejected_norm", "robust_rejected",
        "robust_trimmed", "survivors", "applied")
    assert schema.LANE_WIDTH == 16 and schema.N_LANE_HOST == 6
    assert schema.ROUND_EVENT_KEYS == ("event", "cell") + \
        schema.LANE_FIELDS + ("resource_used", "resource_wasted",
                              "unique_participants", "accuracy", "loss")


def test_registry_matches_the_reference():
    """The same calls on both registries give the same snapshot and the
    same Prometheus text."""
    texts = []
    for reg in (MetricsRegistry(), jtel.MetricsRegistry()):
        c = reg.counter("c_total", "help")
        c.inc()
        c.inc(4)
        assert reg.value("c_total") == 5 and reg.counter("c_total") is c
        with pytest.raises(TypeError):
            reg.gauge("c_total")
        reg.gauge("g").set(2.5)
        for v in (0.0005, 0.05, 5.0, 50.0):
            reg.histogram("h").observe(v)
        texts.append((reg.snapshot(), reg.prometheus_text()))
    assert texts[0] == texts[1]
    assert 'h_bucket{le="+Inf"} 4' in texts[0][1]


def test_counter_view_is_a_dict_over_registry_counters():
    reg = MetricsRegistry()
    view = CounterView(reg, "guard_", ("a", "b"))
    view["a"] += 3
    view["b"] = 7
    assert reg.value("guard_a") == 3 and reg.value("guard_b") == 7
    assert dict(view) == {"a": 3, "b": 7} == view
    assert len(view) == 2 and "a" in view and "c" not in view
    with pytest.raises(KeyError):
        view["c"]


def test_tracer_spans_export_and_profiler_bridge(tmp_path):
    tr = Tracer()
    with tr.span("outer", rounds=2):
        with tr.span("inner"):
            pass
    tr.instant("mark", round=1)
    by = {e["name"]: e for e in tr.chrome_trace()["traceEvents"]}
    assert set(by) == {"outer", "inner", "mark"}
    assert by["inner"]["ph"] == "X" and by["mark"]["ph"] == "i"
    assert by["outer"]["ts"] <= by["inner"]["ts"]
    assert (by["inner"]["ts"] + by["inner"]["dur"]
            <= by["outer"]["ts"] + by["outer"]["dur"])
    tr.export(str(tmp_path / "trace.json"))
    assert json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    off = Tracer(enabled=False)
    with off.span("x"):
        pass
    assert not off.chrome_trace()["traceEvents"]
    assert off.export(str(tmp_path / "none.json")) is None
    # torch_profiler=True: each span is a record_function range
    from torch.profiler import ProfilerActivity, profile
    bridged = Tracer(torch_profiler=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with bridged.span("schedule"):
            torch.ones(4).sum()
    assert "schedule" in {e.name for e in prof.events()}


def test_jsonl_serialization_and_truncation_match_the_reference(tmp_path):
    ev = {"event": "round", "cell": "a", "x": 1.5, "nan": math.nan,
          "inf": -math.inf, "n": 3}
    assert dumps_event(ev) == jtel.dumps_event(ev)
    assert dumps_event(ev) == ('{"event": "round", "cell": "a", "x": 1.5, '
                               '"nan": null, "inf": null, "n": 3}')
    w = JsonlWriter(str(tmp_path / "sub" / "r.jsonl"))
    w.write({"a": 1})
    mark = w.tell()
    w.write({"a": 2})
    assert (tmp_path / "sub" / "r.jsonl").read_text().count("\n") == 2
    w.truncate_to(mark)
    w.write({"a": 3})
    w.truncate_to(10 ** 6)          # past the end: a no-op
    w.close()
    assert (tmp_path / "sub" / "r.jsonl").read_text() == \
        '{"a": 1}\n{"a": 3}\n'
    reg = MetricsRegistry()
    reg.counter("x_total").inc(3)
    assert "x_total 3" in open(write_prometheus(
        reg, str(tmp_path / "m.prom"))).read()


# ---------------------------------------------------------------------------
# Level 2 moves no bit; its round events against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_level2_is_bit_transparent(name, tmp_path):
    sim0, acct0 = _port(name, level=0, weights=False)
    sess = TelemetrySession(str(tmp_path))
    sim2, acct2 = _port(name, level=2, telemetry=sess, weights=False)
    sess.close()
    assert summaries_equal(dict(acct0.summary()), dict(acct2.summary()))
    assert [repr(r) for r in acct0.records] == \
        [repr(r) for r in acct2.records]
    assert torch.equal(_int_view(sim0.flat_params), _int_view(sim2.flat_params))
    assert acct0.round_events == [] and len(acct2.round_events) == \
        len(acct2.records)
    lines = (tmp_path / "rounds.jsonl").read_text().splitlines()
    assert [json.loads(line) for line in lines] == acct2.round_events
    for ev, rec in zip(acct2.round_events, acct2.records):
        assert tuple(ev) == schema.ROUND_EVENT_KEYS
        assert (ev["round"], ev["cohort"], ev["fresh"], ev["stale_landed"]) \
            == (rec.round_idx, rec.n_selected, rec.n_fresh, rec.n_stale)
        for k in schema.LANE_INT_FIELDS:
            assert isinstance(ev[k], int), k


def _assert_events_match(got, want, n_test):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert list(a) == list(b)
        for k in a:
            if k.startswith("l2_"):
                np.testing.assert_allclose(a[k], b[k], rtol=L2_RTOL, err_msg=k)
            elif k == "accuracy" and b[k] is not None:
                assert abs(a[k] - b[k]) <= 1.0 / n_test
            elif k == "loss" and b[k] is not None:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5)
            else:
                assert a[k] == b[k], (k, a["round"], a[k], b[k])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_round_events_match_reference(name, tmp_path):
    ref_sim, ref, ref_events = _reference(name)
    sess = TelemetrySession(str(tmp_path))
    sim, acct = _port(name, telemetry=sess)
    sess.close()
    _assert_events_match(acct.round_events, ref.round_events,
                         len(sim.substrate.data.y_test))
    events = [json.loads(line) for line in
              (tmp_path / "events.jsonl").read_text().splitlines()]
    assert events == ref_events
    evs = acct.round_events
    if CONFIGS[name][1]:            # the plan's corrupted rows were logged
        assert any(e["event"] == "fault" for e in events)
        assert sum(e["nonfinite_rows"] for e in evs) > 0
        assert sum(e["rejected_nonfinite"] for e in evs) == \
            acct.summary()["rejected_nonfinite"]
    if name == "coord_median_attack":
        assert sum(e["robust_trimmed"] for e in evs) == \
            acct.summary()["robust_trimmed"] > 0
        assert all(e["survivors"] == e["fresh"] + e["stale_landed"]
                   for e in evs)
    if name == "krum_guard_faults":
        assert sum(e["robust_rejected"] for e in evs) == \
            acct.summary()["robust_rejected"] > 0


def test_cells_without_a_group_log_their_host_fields(tmp_path):
    """A round may schedule a cell with no fresh and no landing rows (here
    round 6 under a 30 s deadline): its event carries the host fields and
    zeros, as the reference's does."""
    kw = dict(BASE, dynamic_availability=True, setting="DL", deadline=30.0,
              seed=1, telemetry=2)
    ref_sim = JSimulator(JConfig(**kw))
    ref = ref_sim.run(telemetry=jtel.TelemetrySession())
    cfg = SimConfig(**kw)
    sim = Simulator(cfg, Substrate.build(cfg, flat_params0=from_flat(
        ref_sim.substrate.flat_params0)), device="cpu")
    acct = sim.run()
    _assert_events_match(acct.round_events, ref.round_events,
                         len(sim.substrate.data.y_test))
    empty = [e for e in acct.round_events if not e["fresh"] + e["stale_landed"]]
    assert empty and all(e["survivors"] == e["applied"] == e["l2_max"] == 0
                         for e in empty)


# ---------------------------------------------------------------------------
# One writer of the guard counters; the level-1 flat route; sweeps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", [False, True])
def test_guard_counters_single_writer(kernel, tmp_path):
    sess = TelemetrySession(str(tmp_path))
    sim = Simulator(_cfg(use_agg_kernel=kernel, **GUARD), device="cpu",
                    fault_plan=_plan())
    pipe = pl.RoundPipeline([sim], telemetry=sess)
    acct, = pipe.run()
    sess.close()
    s = acct.summary()
    assert s["rejected_nonfinite"] > 0 and s["rejected_norm"] > 0
    reg = {name[len("guard_"):]: sess.registry.value(name)
           for name in schema.GUARD_COUNTERS}
    assert dict(pipe.stats.guard) == reg == pipe.stats.as_dict()["guard"]
    for key in ("rejected_nonfinite", "rejected_norm", "quorum_skips",
                "robust_rejected", "robust_trimmed"):
        assert reg[key] == s[key]
    prom = (tmp_path / "metrics.prom").read_text()
    for key in ("rejected_nonfinite", "rejected_norm", "quorum_skips"):
        assert re.search(rf"^guard_{key} {s[key]}$", prom, re.M)
    assert re.search(r"^span_seconds_dispatch_count \d+$", prom, re.M)
    assert re.search(r"^pipeline_rounds 8$", prom, re.M)
    names = {e["name"] for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"schedule", "pack", "dispatch", "fetch", "eval", "fault"} <= names


def test_level1_spans_without_lane_on_the_flat_route(tmp_path):
    """telemetry=1 on the per-stage flat route: spans and the registry, no
    lane and no round log (as the reference), the summary untouched."""
    ref = Simulator(_cfg(0, fused_rounds=False, **GUARD), device="cpu",
                    fault_plan=_plan()).run()
    sess = TelemetrySession(str(tmp_path))
    got = Simulator(_cfg(1, fused_rounds=False, **GUARD), device="cpu",
                    fault_plan=_plan()).run(telemetry=sess)
    sess.close()
    assert summaries_equal(dict(ref.summary()), dict(got.summary()))
    assert got.round_events == []
    assert (tmp_path / "rounds.jsonl").read_text() == ""
    spans = [e["name"] for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]]
    assert {"schedule", "dispatch", "fetch", "eval"} <= set(spans)
    assert spans.count("schedule") == BASE["rounds"]


def test_level1_fused_logs_spans_and_no_lane(tmp_path):
    sess = TelemetrySession(str(tmp_path))
    sim = Simulator(_cfg(1), device="cpu")
    pipe = pl.RoundPipeline([sim], telemetry=sess)
    acct, = pipe.run()
    sess.close()
    assert pipe.lane is None and acct.round_events == []
    assert pipe.stats.d2h_bytes == 0
    assert {"schedule", "pack", "dispatch", "eval"} <= {
        e["name"] for e in json.loads(
            (tmp_path / "trace.json").read_text())["traceEvents"]}


def test_sweep_round_logs(tmp_path):
    """A session shared by a sweep's batches: each cell's round log under
    its name, the JSONL lines those logs interleaved by round, ``batch``
    spans in the trace, and the summaries those of a sweep at level 0."""
    spec = SweepSpec(axes={"policy": ["random", "relay"],
                           "saa": [False, True]},
                     base={k: v for k, v in BASE.items() if k != "saa"},
                     seeds=(0,))
    cells = spec.expand()
    ref = SweepRunner(cells, device="cpu").run()
    cells2 = [dataclasses.replace(c, config=dataclasses.replace(
        c.config, telemetry=2)) for c in cells]
    sess = TelemetrySession(str(tmp_path))
    runner = SweepRunner(cells2, device="cpu", telemetry=sess)
    res = runner.run()
    sess.close()
    for a, b in zip(res, ref):
        assert summaries_equal(dict(a.summary), dict(b.summary))
    logs = res.round_logs()
    assert set(logs) == {c.name for c in cells}
    assert "round_logs" not in json.dumps(res.to_json_dict())
    lines = [json.loads(line) for line in
             (tmp_path / "rounds.jsonl").read_text().splitlines()]
    assert len(lines) == sum(len(r.acct.records) for r in res)
    for name, evs in logs.items():
        assert [e for e in lines if e["cell"] == name] == evs
        assert all(e["cell"] == name for e in evs)
    trace = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert sum(e["name"] == "batch" for e in trace) == len(runner.batches())
    # the registry's counters run on across the batches
    batch_rounds = [len({r.round_idx for i in idxs
                         for r in res[i].acct.records})
                    for idxs in runner.batches()]
    assert [st["rounds"] for st in runner.batch_stats] == \
        list(np.cumsum(batch_rounds))


# ---------------------------------------------------------------------------
# The graph workspace key; one lane copy a chunk
# ---------------------------------------------------------------------------


class _Stream:
    def wait_stream(self, other):
        pass


def test_lane_flag_keys_the_graph_workspace(monkeypatch):
    """Graphs outlive a pipeline: a level-2 pipeline never takes the
    workspace (and graphs) of a level-0 or level-1 one, nor the reverse;
    levels 0 and 1 share theirs (same device work)."""
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: _Stream())

    def workspace(level):
        sim = Simulator(_cfg(level, use_agg_kernel=True), device="cpu")
        return pl.RoundPipeline(sim)._workspace(sim.cfg)
    plain = workspace(0)
    tgraphs.release(plain)
    lane = workspace(2)
    tgraphs.release(lane)
    assert plain is not lane and plain.key != lane.key
    assert "lane" in lane.buffers and "lane" not in plain.buffers
    assert workspace(1) is plain
    tgraphs.release(plain)
    assert workspace(2) is lane
    for ws in (plain, lane):
        tgraphs._IDLE.pop(ws.key, None)


@pytest.mark.parametrize("k", [1, 4])
def test_one_lane_copy_a_chunk(k, monkeypatch):
    """Level 2 adds exactly one device-to-host copy a chunk (the lane's),
    counted in ``d2h_bytes``; levels 0 and 1 copy nothing of it."""
    copies = []
    orig = torch.Tensor.cpu

    def counting(self, *a, **kw):
        copies.append(self.shape)
        return orig(self, *a, **kw)
    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    counts, stats = {}, {}
    for level in (0, 2):
        copies.clear()
        sim = Simulator(_cfg(level, use_agg_kernel=True,
                             rounds_per_dispatch=k), device="cpu")
        pipe = pl.RoundPipeline([sim])
        pipe.run()
        counts[level], stats[level] = len(copies), pipe.stats
    chunks = stats[2].dispatches["round"]
    assert counts[2] - counts[0] == chunks == (8 if k == 1 else 2)
    assert stats[0].d2h_bytes == 0
    g_cap = pl.bucket_block(1, pl.G_BLOCK)
    assert stats[2].d2h_bytes == (stats[2].rounds * g_cap
                                  * schema.LANE_WIDTH * 4)
    assert stats[2].as_dict()["d2h_bytes"] == stats[2].d2h_bytes


# ---------------------------------------------------------------------------
# examples/chaos_round.py at full size, round by round against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["clean", "guard=off", "guard=reject",
                                  "guard=clip+reject"])
def test_chaos_round_full_size_round_logs_match_reference(mode, tmp_path):
    """The chaos harness's four guard modes at the example's full size
    (100 learners, 40 rounds, plan seed 42), both packages at level 2 on
    the reference's initial weights: every round event's int and host
    fields ``==`` (the guard columns included), the l2 columns within
    ``L2_RTOL``, the ``fault`` events ``==``, and the final accuracy within
    one test sample.  So the guarded runs' full-size accuracies (far below
    clean) are the reference's own."""
    from repro_torch import chaos_round
    common, plan = chaos_round.build(False)
    extra, faulted = {label: (kw, f) for label, kw, f in
                      chaos_round.GUARD_MODES}[mode]
    kw = dict(common, **extra, telemetry=2)
    jplan = JPlan(plan.n_learners, plan.rounds, seed=plan.seed, specs=tuple(
        JSpec(s.kind, prob=s.prob, scale=s.scale) for s in plan.specs))
    ref_sim = JSimulator(JConfig(**kw), fault_plan=jplan if faulted else None)
    ref_dir = tmp_path / "ref"
    sess = jtel.TelemetrySession(str(ref_dir))
    ref = ref_sim.run(telemetry=sess)
    sess.close()
    cfg = SimConfig(**kw)
    sim = Simulator(cfg, Substrate.build(cfg, flat_params0=from_flat(
        ref_sim.substrate.flat_params0)), device="cpu",
        fault_plan=plan if faulted else None)
    sess = TelemetrySession(str(tmp_path / "port"))
    acct = sim.run(telemetry=sess)
    sess.close()
    n_test = len(sim.substrate.data.y_test)
    _assert_events_match(acct.round_events, ref.round_events, n_test)
    assert (tmp_path / "port" / "events.jsonl").read_text() == \
        (ref_dir / "events.jsonl").read_text()
    s, rs = acct.summary(), ref.summary()
    assert abs(s["final_accuracy"] - rs["final_accuracy"]) <= 1.0 / n_test
    for key in ("rejected_nonfinite", "rejected_norm", "quorum_skips"):
        assert s[key] == rs[key]
