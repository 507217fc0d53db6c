"""The port's scenario sweeps (``repro_torch.sweeps``, the S >= 1 round
pipeline, the per-stage batched executor) against the JAX package and
against the port's own serial runs, on the CPU.

Contracts:

- **Grid.**  ``SweepSpec.expand`` gives the reference's cells: names,
  coordinates and every ``SimConfig`` field; a spec whose axes collapse
  two cells onto one config raises as the reference does.
- **Against the reference.**  An 8-cell grid (2 policies x 2 hardware
  scenarios x seeds 0 and 1; 30 learners, 6 rounds, ``eval_every=3``)
  through the port's ``SweepRunner(device="cpu")``, each substrate
  carrying the reference's initial weights (``substrate_cache``), against
  the reference's ``SweepRunner``: host fields of every RoundRecord ``==``,
  the generators' final states ``==``; final params within atol 1e-5,
  eval loss within rtol 1e-5, accuracy within one test sample (the
  tolerances ``tests/test_torch_pipeline.py`` holds a serial run to).
  Fused and per-stage, with the kernel wrappers (their plain versions on
  the CPU) and without.
- **Batched == serial, bit for bit**: summaries (``summaries_equal``),
  every RoundRecord's fields by ``repr``, final params as int32 views and
  robust counters, for a FedAvg, a YoGi, an oort, a trimmed_mean under
  ``collude_signflip`` and an early-stop batch, on both substrates.
- **Fused sweep == per-stage sweep**, bit for bit, on the same batches.
- The per-stage helpers (``sweep_bucket_pad``, ``sweep_aggregate_flat``,
  ``robust_sweep``), ``describe_aggregators``, ``compat_key``'s batches,
  the report's text, the CLI and every unported option's error.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.robust import aggregators as jrob
from repro.sim import SimConfig as JConfig
from repro.sim import Simulator as JSimulator
from repro.sim.engine import substrate_key as jsubstrate_key
from repro.sweeps import SweepRunner as JSweepRunner
from repro.sweeps import SweepSpec as JSweepSpec
from repro.sweeps import compat_key as jcompat_key
from repro.sweeps import report as jreport
from repro.sweeps.results import CellResult as JCellResult
from repro.sweeps.results import SweepResults as JSweepResults
from repro_torch.checkpoint import load_snapshot
from repro_torch.core import aggregation as tagg
from repro_torch.faults import FaultPlan, InjectedCrash
from repro_torch.robust import aggregators as trob
from repro_torch.sim import SimConfig, Simulator, Substrate
from repro_torch.sim import learner as ln
from repro_torch.sim.engine import substrate_key
from repro_torch.sim.pipeline import RoundPipeline
from repro_torch.sweeps import (Cell, SweepRunner, SweepSpec, compat_key,
                                report, run_batched, run_serial,
                                summaries_equal)
from repro_torch.sweeps import __main__ as cli
from repro_torch.sweeps.results import CellResult, SweepResults
from repro_torch.sweeps.runner import resume_sweep
from repro_torch.weights import from_flat

torch.set_num_threads(1)

HOST = ("round_idx", "sim_time", "n_selected", "n_fresh", "n_stale",
        "resource_used", "resource_wasted", "unique_participants")
SMALL = dict(n_learners=30, rounds=6, eval_every=3, n_target=4,
             mapping="label_uniform")
# DL with a short deadline: stragglers, so RELAY's stale rows land
REF_GRID = dict(axes={"policy": ["random", "relay"],
                      "hardware": ["HS1", "HS3"]},
                base=dict(SMALL, setting="DL", deadline=15.0), seeds=(0, 1))
# the batches held to serial runs: every learner available and a deadline
# that leaves stragglers, so stale rows land and the shared cache is used
STALE = dict(SMALL, dynamic_availability=False, setting="DL", deadline=15.0,
             saa=True, use_agg_kernel=True)
BATCHES = {
    "fedavg": dict(axes={"policy": ["relay"], "hardware": ["HS1", "HS2",
                                                           "HS3"]},
                   base=STALE, seeds=(0, 1)),
    "yogi": dict(axes={"hardware": ["HS1", "HS3"]},
                 base=dict(STALE, selector="priority", apt=True,
                           server_opt="yogi"), seeds=(0, 1)),
    "oort": dict(axes={"hardware": ["HS1", "HS3"]},
                 base=dict(STALE, selector="oort"), seeds=(0, 1)),
    "trimmed_mean": dict(axes={"hardware": ["HS1", "HS3"]},
                         base=dict(SMALL, aggregator="trimmed_mean", trim_k=1,
                                   attack="collude_signflip", attack_frac=0.2,
                                   attack_scale=50.0, setting="DL",
                                   deadline=1e6, use_agg_kernel=True),
                         seeds=(0, 1)),
    # targets that some cells reach at round 2 and others never
    "early_stop": dict(axes={"target_accuracy": [0.05, 0.2, 0.9],
                             "hardware": ["HS1", "HS3"]},
                       base=STALE, seeds=(0,)),
}


def _host(rec):
    return tuple(getattr(rec, f) for f in HOST)


def _bits(rec):
    return tuple(repr(v) for v in dataclasses.astuple(rec))


def _int_view(t):
    return t.contiguous().view(torch.int32)


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference sweep of REF_GRID: its cells, results and substrates."""
    cells = JSweepSpec(**REF_GRID).expand()
    runner = JSweepRunner(cells)
    res = runner.run()
    return cells, res, runner.substrate_cache


def _port_cache(ref_cache):
    """Port substrates built with the reference substrates' weights."""
    cache = {}
    for sub in ref_cache.values():
        cfg = SimConfig(n_learners=sub.key[2], seed=sub.key[3],
                        mapping=sub.key[1], benchmark=sub.key[0],
                        dynamic_availability=sub.key[4])
        cache[substrate_key(cfg)] = Substrate.build(
            cfg, flat_params0=from_flat(sub.flat_params0))
    return cache


def _spec(d):
    return SweepSpec(**d)


def _with(cells, **over):
    return [Cell(c.name, c.coords, dataclasses.replace(c.config, **over))
            for c in cells]


# ---------------------------------------------------------------------------
# Grid expansion
# ---------------------------------------------------------------------------

GRIDS = {
    "policy_saa_hardware": dict(axes={"policy": ["random", "oort", "safa",
                                                 "relay"],
                                      "saa": [False, True],
                                      "hardware": ["HS1", "HS3"]},
                                base=dict(n_learners=100, rounds=40),
                                seeds=(0, 1)),
    "selector_raw_fields": dict(axes={"selector": ["random", "ucb", "flips"],
                                      "n_target": [5, 12],
                                      "availability": ["static", "dynamic"]},
                                base=dict(mapping="label_zipf"), seeds=(3,)),
    "target_scaling": dict(axes={"target_accuracy": [0.5, 0.7],
                                 "scaling_rule": ["equal", "relay"],
                                 "aggregator": ["saa", "coord_median"]},
                           base=dict(attack="alie", server_opt="yogi"),
                           seeds=(0, 1, 2)),
}


@pytest.mark.parametrize("grid", list(GRIDS))
def test_grid_expansion_equals_reference(grid):
    mine, ref = SweepSpec(**GRIDS[grid]).expand(), \
        JSweepSpec(**GRIDS[grid]).expand()
    assert [c.name for c in mine] == [c.name for c in ref]
    assert [c.coords for c in mine] == [c.coords for c in ref]
    for a, b in zip(mine, ref):
        assert dataclasses.asdict(a.config) == dataclasses.asdict(b.config)
    assert SweepSpec(**GRIDS[grid]).size == len(mine)


def test_grid_rejects_collapsing_axes_as_reference():
    bad = dict(axes={"saa": [False, True], "policy": ["safa", "relay"]},
               base=dict(n_learners=20, rounds=4))
    with pytest.raises(ValueError, match="identical config"):
        SweepSpec(**bad).expand()
    with pytest.raises(ValueError, match="identical config"):
        JSweepSpec(**bad).expand()


def test_compat_key_batches_like_reference():
    """The port splits a mixed set of cells into the reference's batches."""
    cfgs = [dict(rounds=10), dict(rounds=20), dict(rounds=10, saa=True),
            dict(rounds=10, selector="oort"),
            dict(rounds=10, selector="oort", selector_params=(("alpha", 1.5),)),
            dict(rounds=10, use_agg_kernel=True, scaling_rule="equal"),
            dict(rounds=10, use_agg_kernel=True),
            dict(rounds=10, scaling_rule="equal"),
            dict(rounds=10, fused_rounds=False),
            dict(rounds=10, aggregator="trimmed_mean", trim_k=2),
            dict(rounds=10, server_opt="yogi", hardware_scenario="HS4")]

    def parts(key_fn, cls):
        keys = [key_fn(cls(**kw)) for kw in cfgs]
        return [[i for i, k in enumerate(keys) if k == key]
                for key in dict.fromkeys(keys)]
    assert parts(compat_key, SimConfig) == parts(jcompat_key, JConfig)


# ---------------------------------------------------------------------------
# Against the reference sweep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("kernel", [True, False])
def test_sweep_matches_reference(fused, kernel):
    ref_cells, ref, ref_cache = _reference()
    cells = _with(SweepSpec(**REF_GRID).expand(), fused_rounds=fused,
                  use_agg_kernel=kernel)
    runner = SweepRunner(cells, device="cpu",
                         substrate_cache=_port_cache(ref_cache))
    mine = runner.run()
    assert len({compat_key(c.config) for c in cells}) == 2   # S = 4 batches
    n_test = None
    for i, (a, b) in enumerate(zip(mine, ref)):
        assert a.cell.name == b.cell.name
        assert [_host(r) for r in a.acct.records] == \
            [_host(r) for r in b.acct.records]
        sim = runner.sims[i]
        n_test = len(sim.data.y_test)
        evals = [(x, y) for x, y in zip(a.acct.records, b.acct.records)
                 if y.accuracy == y.accuracy]
        assert evals
        for x, y in evals:
            assert abs(x.accuracy - y.accuracy) <= 1.0 / n_test
            np.testing.assert_allclose(x.loss, y.loss, rtol=1e-5)
        for key in ("rounds", "sim_time", "resource_used", "resource_wasted",
                    "unique_participants", "stopped_early"):
            assert a.summary[key] == b.summary[key]
    # the reference keeps its final params per Simulator: rerun serially
    for i, c in enumerate(ref_cells[:2]):
        js = JSimulator(c.config,
                        substrate=ref_cache[jsubstrate_key(c.config)])
        js.run()
        np.testing.assert_allclose(runner.sims[i].flat_params.numpy(),
                                   np.asarray(js.flat_params), atol=1e-5)
        assert runner.sims[i].rng.bit_generator.state == \
            js.rng.bit_generator.state
    assert sum(r.n_stale for res in mine for r in res.acct.records) > 0


# ---------------------------------------------------------------------------
# Batched == serial, fused == per-stage, bit for bit
# ---------------------------------------------------------------------------


def _batched(case, fused):
    cells = _with(_spec(BATCHES[case]).expand(), fused_rounds=fused)
    runner = SweepRunner(cells, device="cpu")
    return cells, runner.run(), runner


def _assert_same_run(a_acct, a_sim, b_acct, b_sim):
    assert summaries_equal(dict(a_acct.summary()), dict(b_acct.summary()))
    assert [_bits(r) for r in a_acct.records] == \
        [_bits(r) for r in b_acct.records]
    assert torch.equal(_int_view(a_sim.flat_params),
                       _int_view(b_sim.flat_params))
    if a_sim.cfg.server_opt == "yogi":
        for k in ("m", "v"):
            assert torch.equal(_int_view(a_sim.flat_opt_state[k]),
                               _int_view(b_sim.flat_opt_state[k]))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("case", list(BATCHES))
def test_batched_equals_serial_bitwise(case, fused):
    cells, res, runner = _batched(case, fused)
    assert len(runner.batches()) == 1 and len(cells) >= 4
    for i, c in enumerate(cells):
        sim = Simulator(c.config, device="cpu")
        acct = sim.run()
        _assert_same_run(res[i].acct, runner.sims[i], acct, sim)
    if case == "early_stop":       # some cells stop, some run out of rounds
        stopped = [r.summary["stopped_early"] for r in res]
        assert any(stopped) and not all(stopped)
        assert min(r.summary["rounds"] for r in res) < SMALL["rounds"]
    if case == "trimmed_mean":
        assert all(r.summary["robust_trimmed"] > 0 for r in res)
    if case in ("fedavg", "oort", "yogi"):
        assert sum(r.n_stale for x in res for r in x.acct.records) > 0


@pytest.mark.parametrize("case", list(BATCHES))
def test_fused_sweep_equals_per_stage_sweep(case):
    _, fused, f_run = _batched(case, True)
    _, flat, s_run = _batched(case, False)
    for i, (a, b) in enumerate(zip(fused, flat)):
        _assert_same_run(a.acct, f_run.sims[i], b.acct, s_run.sims[i])
        assert (a.summary["robust_rejected"], a.summary["robust_trimmed"]) \
            == (b.summary["robust_rejected"], b.summary["robust_trimmed"])


def test_one_cell_batch_is_the_serial_run():
    """``Simulator.run()`` is ``RoundPipeline([self])``: a pipeline of one
    cell built by hand gives the same bits."""
    cfg = SimConfig(**dict(STALE, selector="priority", apt=True))
    a, b = Simulator(cfg, device="cpu"), Simulator(cfg, device="cpu")
    acct_a = a.run()
    acct_b, = RoundPipeline([b]).run()
    _assert_same_run(acct_a, a, acct_b, b)


def test_shared_cache_growth_keeps_results():
    """A one-slot stale cache shared by a batch grows under it and changes
    no cell's bits; slots freed by one cell's landings serve others."""
    spec = _spec(BATCHES["fedavg"])
    base = SweepRunner(spec.expand(), device="cpu")
    res_a = base.run()
    small = _with(spec.expand(), stale_cache_capacity=1)
    sims = [Simulator(c.config, device="cpu") for c in small]
    pipe = RoundPipeline(sims)
    accts = pipe.run()
    assert pipe.cache.grow_events > 0
    for i, acct in enumerate(accts):
        _assert_same_run(res_a[i].acct, base.sims[i], acct, sims[i])


def test_batch_shares_one_device_copy_per_substrate():
    spec = _spec(BATCHES["fedavg"])
    runner = SweepRunner(spec.expand(), device="cpu")
    runner.run()
    subs = {id(s.substrate) for s in runner.sims}
    assert len(subs) == 2                              # seeds 0 and 1
    assert len({s.x_train.data_ptr() for s in runner.sims}) == 2


def test_learner_per_row_params_equal_broadcast():
    """``local_train_cohort`` from (R, D) rows gives each row the bits of a
    broadcast call from that row's model."""
    cfg = SimConfig(**SMALL)
    sim = Simulator(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    d = sim.flat_params.numel()
    models = sim.flat_params + 0.01 * torch.randn((3, d), generator=gen)
    bidx = torch.randint(0, len(sim.data.y_train), (7, 80), generator=gen)
    cell = torch.tensor([0, 0, 1, 2, 2, 2, 1])
    bx = sim.x_train[bidx].view(7, 5, 16, -1)
    by = sim.y_train[bidx].view(7, 5, 16)
    kw = dict(spec=sim._flat_spec, lr=0.05, prox_mu=0.01)
    rows = ln.local_train_cohort(models[cell], bx, by, **kw)
    for c in range(3):
        at = (cell == c).nonzero()[:, 0]
        one = ln.local_train_cohort(models[c], bx[at], by[at], **kw)
        for got, want in zip(rows, one):
            assert torch.equal(_int_view(got[at]), _int_view(want))


# ---------------------------------------------------------------------------
# The per-stage helpers against the reference's
# ---------------------------------------------------------------------------


def _cell_updates(rng, sizes, d):
    out = []
    for n in sizes:
        if n == 0:
            out.append(None)
            continue
        nf = int(rng.integers(0, n + 1))
        rows = [torch.from_numpy(rng.standard_normal(d).astype(np.float32))
                for _ in range(n)]
        out.append((rows, [True] * nf + [False] * (n - nf),
                    [0] * nf + list(rng.integers(1, 6, n - nf))))
    return out


@pytest.mark.parametrize("sizes", [(3, 0, 7, 1), (12,), (5, 5, 40)])
def test_sweep_bucket_pad_matches_reference(sizes):
    rng = np.random.default_rng(sum(sizes))
    ups = _cell_updates(rng, sizes, 37)
    u, fr, ta, va, has = tagg.sweep_bucket_pad(ups, 37)
    ref = jagg.sweep_bucket_pad(
        [None if c is None else ([r.numpy() for r in c[0]], c[1], c[2])
         for c in ups], 37)
    n = u.shape[1]
    assert n == max(sizes)
    for got, want in zip((u, fr, ta, va), ref[:4]):
        assert np.array_equal(got.numpy(), want[:, :n])
        assert not want[:, n:].any()
    assert np.array_equal(has.numpy(), ref[4])


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("rules", [("relay",) * 4,
                                   ("relay", "equal", "dynsgd", "adasgd")])
def test_sweep_aggregate_flat_matches_reference(kernel, rules):
    rng = np.random.default_rng(7)
    ups = _cell_updates(rng, (4, 0, 9, 2), 300)
    u, fr, ta, va, _ = tagg.sweep_bucket_pad(ups, 300)
    betas = [0.35, 0.2, 0.5, 0.9]
    if kernel and len(set(rules)) > 1:
        with pytest.raises(ValueError, match="mixed rules"):
            tagg.sweep_aggregate_flat(u, fr, ta, va, betas, rule=list(rules),
                                      use_kernel=True)
        return
    agg, w = tagg.sweep_aggregate_flat(u, fr, ta, va, betas, rule=list(rules),
                                       use_kernel=kernel)
    ref_agg, ref_w = jagg.sweep_aggregate_flat(
        u.numpy(), fr.numpy(), ta.numpy(), va.numpy(),
        np.asarray(betas, np.float32), rule=list(rules))
    np.testing.assert_allclose(agg.numpy(), np.asarray(ref_agg), atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), atol=1e-6)
    assert not agg[1].any() and not w[1].any()       # the cell without rows
    # each cell's bits are a serial call's on its own rows
    for i, c in enumerate(ups):
        if c is None:
            continue
        k = len(c[0])
        one, _ = tagg.sweep_aggregate_flat(u[i:i + 1, :k], fr[i:i + 1, :k],
                                           ta[i:i + 1, :k], va[i:i + 1, :k],
                                           betas[i:i + 1], rule=[rules[i]],
                                           use_kernel=kernel)
        assert torch.equal(_int_view(agg[i]), _int_view(one[0]))


ROBUST = {"trimmed_mean": ("trimmed_mean", 2), "coord_median": ("coord_median",),
          "multi_krum": ("multi_krum", 1, None),
          "norm_median_clip": ("norm_median_clip", 5.0, 2.0)}


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("kind", list(ROBUST))
def test_robust_sweep_equals_cells_and_reference(kind, kernel):
    rng = np.random.default_rng(3)
    sizes = [6, 2, 9]
    ups = _cell_updates(rng, sizes, 64)
    u, fr, ta, va, _ = tagg.sweep_bucket_pad(ups, 64)
    att = torch.as_tensor(rng.uniform(size=va.shape) < 0.3) & va
    attack = ("collude_signflip", 10.0, 1.5)
    betas, rules = [0.35, 0.5, 0.2], [3, 0, 1]
    agg, counts = trob.robust_sweep(u, fr, ta, va, att, sizes, attack=attack,
                                    robust=ROBUST[kind], betas=betas,
                                    rule_ids=rules, use_kernel=kernel)
    fn = jrob.robust_sweep_fn(attack, None, ROBUST[kind], False)
    ref_agg, ref_st = fn(u.numpy(), fr.numpy(), ta.numpy(), va.numpy(),
                         att.numpy(), np.asarray(betas, np.float32),
                         np.asarray(rules, np.int32))
    np.testing.assert_allclose(agg.numpy(), np.asarray(ref_agg), rtol=1e-5,
                               atol=1e-5)
    assert counts.tolist() == np.asarray(ref_st)[:, 3:5].tolist()
    for g, k in enumerate(sizes):
        one, cnt = trob.robust_cell(u[g, :k], fr[g, :k], ta[g, :k], va[g, :k],
                                    att[g, :k], attack=attack,
                                    robust=ROBUST[kind], beta=betas[g],
                                    rule_id=rules[g], use_kernel=kernel)
        assert torch.equal(_int_view(agg[g]), _int_view(one))
        assert counts[g].tolist() == cnt.tolist()


def test_describe_aggregators_equals_reference():
    assert trob.describe_aggregators() == jrob.describe_aggregators()


# ---------------------------------------------------------------------------
# Report, CLI, and what is not ported
# ---------------------------------------------------------------------------


def test_report_text_equals_reference():
    """The port's tables and savings line print the reference's text on
    the same summaries."""
    _, ref, _ = _reference()
    cells = SweepSpec(**REF_GRID).expand()
    mine = SweepResults([CellResult(c, dict(r.summary))
                         for c, r in zip(cells, ref)])
    theirs = JSweepResults([JCellResult(r.cell, r.summary) for r in ref])
    assert report.text_table(mine) == jreport.text_table(theirs)
    assert report.markdown_table(mine) == jreport.markdown_table(theirs)
    best, base = {"policy": "relay"}, {"policy": "random"}
    assert report.savings_line(mine, best, base) == \
        jreport.savings_line(theirs, best, base)
    assert mine.to_json_dict() == theirs.to_json_dict()
    assert mine.group_stats() == theirs.group_stats()
    assert mine.resource_to_target() == theirs.resource_to_target()


def test_cli_smoke_runs_on_cpu(tmp_path, capsys):
    out = tmp_path / "sweep.json"
    cli.main(["--smoke", "--device", "cpu", "--out", str(out)])
    text = capsys.readouterr().out
    assert "per-cell metrics equal" in text and "policy=relay" in text
    assert out.exists() and '"cells": 4' in out.read_text()


def test_cli_lists_strategy_tables(capsys):
    cli.main(["--list-selectors", "--list-aggregators"])
    text = capsys.readouterr().out
    assert trob.describe_aggregators() in text and "oort" in text


def test_cli_writes_nothing_without_out(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    res, _ = run_batched(SweepSpec(axes={"saa": [False]},
                                   base=dict(SMALL, rounds=2)).expand(),
                         device="cpu")
    assert len(res) == 1 and not list(tmp_path.iterdir())


@pytest.mark.parametrize("flag", ["sharded", "participant_shards"])
def test_cli_unported_flags_name_their_item(flag, monkeypatch, capsys):
    """The sharding flags (queue 1 item 14, ported) run: in a plain process
    the mesh is one rank, and the batched run still equals the serial
    runs; the header names the axis, as the reference's does."""
    monkeypatch.setattr(cli, "demo_spec", lambda smoke: SweepSpec(
        axes={"saa": [False, True]}, base=dict(SMALL, rounds=2)))
    opt = "--" + flag.replace("_", "-")
    argv = [opt] if flag == "sharded" else [opt, "4"]
    cli.main(["--smoke", "--device", "cpu", *argv])
    out = capsys.readouterr().out
    axis = "sweep" if flag == "sharded" else "participant"
    assert f"# sharding the {axis} axis over 1 rank(s)" in out
    assert "per-cell metrics equal" in out


@pytest.mark.parametrize("flag", ["checkpoint", "resume", "crash_after"])
def test_cli_chaos_flags_run(flag, tmp_path, capsys):
    """The checkpoint, crash and resume flags (queue 1 item 10, ported):
    a checkpointed smoke sweep leaves a sweep snapshot; a crash after
    round 3 raises out of the batched run; a resume finishes the crashed
    sweep with the uninterrupted sweep's results."""
    ckpt, out = str(tmp_path / "s.pkl"), tmp_path / "r.json"
    smoke = ["--smoke", "--device", "cpu", "--checkpoint", ckpt]
    if flag == "checkpoint":
        cli.main(smoke + ["--checkpoint-every", "4"])
        assert load_snapshot(ckpt)["kind"] == "sweep"
        assert "per-cell metrics equal" in capsys.readouterr().out
        return
    with pytest.raises(InjectedCrash):
        cli.main(smoke + ["--crash-after", "3"])
    if flag == "resume":
        cli.main(["--resume", ckpt, "--device", "cpu", "--out", str(out)])
        clean, _ = run_batched(cli.demo_spec(True).expand(), device="cpu")
        got = json.loads(out.read_text())["results"]
        assert got == json.loads(json.dumps(clean.to_json_dict()))


@pytest.mark.parametrize("kw, item", [
    (dict(shard=True), 14), (dict(mesh={"s": 1, "p": 1}), 14),
    (dict(shard_participants=2), 14)])
def test_runner_unported_options_name_their_item(kw, item):
    """``shard``, ``mesh`` and ``shard_participants`` (queue 1 item 14,
    ported) run: without a process group the mesh is one rank, and the
    sweep equals the unsharded one bit for bit."""
    cells = SweepSpec(axes={"saa": [False, True]},
                      base=dict(SMALL, rounds=3)).expand()
    runner = SweepRunner(cells, device="cpu", **kw)
    assert runner.mesh.shape == {"s": 1, "p": 1}
    got, want = runner.run(), SweepRunner(cells, device="cpu").run()
    for a, b in zip(got, want):
        assert summaries_equal(dict(a.summary), dict(b.summary))
    assert runner.batch_stats[0]["n_shards"] == 1


def test_runner_and_resume_take_a_telemetry_session(tmp_path):
    """``SweepRunner(telemetry=)`` and ``resume_sweep(telemetry=)`` (queue 1
    item 12, ported) run: one session for every batch, a round log line a
    level-2 cell and round."""
    from repro_torch.telemetry import TelemetrySession
    cells = [dataclasses.replace(c, config=dataclasses.replace(
        c.config, telemetry=2)) for c in SweepSpec(
            axes={"saa": [False, True]}, base=dict(SMALL, rounds=4)).expand()]
    sess = TelemetrySession(str(tmp_path / "t"))
    res = SweepRunner(cells, device="cpu", telemetry=sess).run()
    sess.close()
    lines = (tmp_path / "t" / "rounds.jsonl").read_text().splitlines()
    assert len(lines) == sum(len(r.acct.records) for r in res) > 0
    ckpt = str(tmp_path / "s.pkl")
    with pytest.raises(InjectedCrash):
        run_batched(cells, device="cpu", checkpoint_path=ckpt,
                    checkpoint_every=2, fault_plan=FaultPlan(
                        n_learners=SMALL["n_learners"], rounds=4,
                        crash_after=2, crash_mode="soft"))
    sess = TelemetrySession()
    got, _ = resume_sweep(ckpt, device="cpu", telemetry=sess)
    assert got.round_logs() == res.round_logs()
    assert sess.registry.value("pipeline_rounds") > 0


def test_cli_telemetry_dir_runs(tmp_path, capsys):
    """``--telemetry-dir`` (queue 1 item 12, ported): the batched cells run
    at level 2 against serial runs at level 0, and the directory holds a
    round log line a cell and recorded round, a trace that loads and a
    Prometheus snapshot."""
    out = tmp_path / "t"
    cli.main(["--smoke", "--device", "cpu", "--telemetry-dir", str(out),
              "--rounds-per-dispatch", "4"])
    assert "per-cell metrics equal" in capsys.readouterr().out
    lines = [json.loads(x) for x in
             (out / "rounds.jsonl").read_text().splitlines()]
    cells = cli.demo_spec(True).expand()
    assert {e["cell"] for e in lines} == {c.name for c in cells}
    assert json.loads((out / "trace.json").read_text())["traceEvents"]
    assert "guard_rejected_nonfinite 0" in (out / "metrics.prom").read_text()


def test_runner_checkpoint_path_runs(tmp_path):
    """``SweepRunner(checkpoint_path=)`` (queue 1 item 10, ported): a fused
    batch writes its snapshot and ends as the run without one."""
    cells = SweepSpec(axes={"saa": [False, True]},
                      base=dict(SMALL, rounds=6)).expand()
    ckpt = str(tmp_path / "s.pkl")
    res = SweepRunner(cells, device="cpu", checkpoint_path=ckpt,
                      checkpoint_every=2).run()
    ref, _ = run_batched(cells, device="cpu")
    assert load_snapshot(ckpt)["pipeline"]["next_round"] == 4
    for a, b in zip(res, ref):
        assert summaries_equal(dict(a.summary), dict(b.summary))


def test_resume_sweep_finishes_a_crashed_sweep(tmp_path):
    """``resume_sweep`` (queue 1 item 10, ported) finishes a sweep that
    crashed mid-batch, each cell bit for bit the uninterrupted sweep's."""
    cells = SweepSpec(axes={"saa": [False, True]},
                      base=dict(SMALL, rounds=6)).expand()
    ckpt = str(tmp_path / "s.pkl")
    with pytest.raises(InjectedCrash):
        run_batched(cells, device="cpu", checkpoint_path=ckpt,
                    checkpoint_every=2, fault_plan=FaultPlan(
                        0, 0, crash_after=2))
    res, _ = resume_sweep(ckpt, device="cpu")
    ref, _ = run_batched(cells, device="cpu")
    for a, b in zip(res, ref):
        assert summaries_equal(dict(a.summary), dict(b.summary))


def test_runner_needs_a_gpu_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SweepRunner([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_serial([])
    assert SweepRunner([], device="cpu").device.type == "cpu"
