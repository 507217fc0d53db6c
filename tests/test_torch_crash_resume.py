"""Crash-safe resume in the port (``repro_torch.checkpoint``), on the CPU.

The contract, within the port and bit for bit: run(2R) == run(R) ->
crash -> resume(R), for the fused pipeline at K = 1 and K = 4 (its
snapshots and crashes come at chunk boundaries), the kernel route with
YoGi, the flat path, a guarded robust run under attack and corruption, a
passive mid-run snapshot, and whole sweeps (the in-flight batch resumed,
the others rerun or restored).  Summaries, every RoundRecord by ``repr``
and the final params (int32 views) are compared, and the device counters
(robust and guard) continue across the crash.  Also: the snapshot's error
paths, the atomic write, the hard crash (SIGKILL, exit 137) through the
sweep CLI and its ``--resume`` in subprocesses, and ``save_pytree`` /
``load_pytree``.  The telemetry round log joins the contract: a level-2
run's ``rounds.jsonl`` after crash -> resume into the crashed run's
directory is byte-equal to the uninterrupted run's (rounds logged past the
last snapshot are truncated and re-emitted), at K = 1 and K = 4 and for a
sweep, and the in-memory round log rides the snapshot.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (CheckpointError, SnapshotError,
                                    build_resumed_pipeline, load_pytree,
                                    load_snapshot, resume_run, save_pytree,
                                    save_snapshot)
from repro_torch.checkpoint.state import _restore_sim
from repro_torch.faults import FaultPlan, FaultSpec, InjectedCrash
from repro_torch.sim import SimConfig, Simulator
from repro_torch.sweeps import SweepSpec, resume_sweep
from repro_torch.sweeps.__main__ import demo_spec
from repro_torch.sweeps.runner import run_batched, summaries_equal
from repro_torch.telemetry import TelemetrySession

torch.set_num_threads(1)

# static availability: full cohorts, and stragglers in flight at every
# snapshot, which a resume re-seats
BASE = dict(n_learners=30, rounds=8, eval_every=4, n_target=4, saa=True,
            selector="priority", mapping="label_uniform",
            dynamic_availability=False)
NAN = (FaultSpec("nan", prob=0.2), FaultSpec("scale", prob=0.1, scale=1e4),
       FaultSpec("replay", prob=0.3), FaultSpec("post_drop", prob=0.1))
SUBSTRATES = {
    "fused": {},
    "chunked": {"rounds_per_dispatch": 4},
    "kernel_yogi": {"use_agg_kernel": True, "server_opt": "yogi"},
    "flat": {"fused_rounds": False},
    "flat_yogi": {"fused_rounds": False, "server_opt": "yogi"},
}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(**kw):
    return SimConfig(**{**BASE, **kw})


def _plan(after=3, specs=(), mode="soft"):
    return FaultPlan(n_learners=BASE["n_learners"], rounds=BASE["rounds"],
                     specs=specs, seed=7, crash_after=after, crash_mode=mode)


def _int_view(t):
    return t.contiguous().view(torch.int32)


def _resume(path):
    """The resumed run's (Accounting, Simulator)."""
    payload = load_snapshot(path)
    if payload["kind"] == "engine":
        sim = _restore_sim(payload["sim"], device="cpu")
        return sim._run_loop(payload["next_round"], False), sim
    pipe = build_resumed_pipeline(payload, device="cpu")
    return pipe.run()[0], pipe.sims[0]


def _assert_same(acct, sim, ref, ref_sim):
    assert summaries_equal(dict(acct.summary()), dict(ref.summary()))
    assert [repr(r) for r in acct.records] == [repr(r) for r in ref.records]
    assert torch.equal(_int_view(sim.flat_params),
                       _int_view(ref_sim.flat_params))
    if ref_sim.flat_opt_state is not None:
        for k, v in ref_sim.flat_opt_state.items():
            assert torch.equal(_int_view(sim.flat_opt_state[k]),
                               _int_view(v)), k


def _crash_then_resume(cfg, specs, tmp_path, every=2, after=3, stale=True):
    ref_sim = Simulator(cfg, device="cpu",
                        fault_plan=_plan(None, specs) if specs else None)
    ref = ref_sim.run()
    ckpt = str(tmp_path / "run.pkl")
    with pytest.raises(InjectedCrash):
        Simulator(cfg, device="cpu", fault_plan=_plan(after, specs)).run(
            checkpoint_path=ckpt, checkpoint_every=every)
    payload = load_snapshot(ckpt)
    assert 0 < payload["next_round"] <= after + 1
    sims = payload.get("sims") or [payload["sim"]]
    assert any(ps["state"]["stale"] for ps in sims) == stale
    acct, sim = _resume(ckpt)
    _assert_same(acct, sim, ref, ref_sim)
    return acct


@pytest.mark.parametrize("sub", list(SUBSTRATES))
def test_soft_crash_resume_is_bit_exact(sub, tmp_path):
    _crash_then_resume(_cfg(**SUBSTRATES[sub]), (), tmp_path)


@pytest.mark.parametrize("sub", ["fused", "chunked", "flat"])
def test_crash_resume_under_corruption_faults(sub, tmp_path):
    """The fault plan rides the snapshot: a guarded run under NaN, scale,
    replay and post_drop faults resumes into the same remaining faults
    (crash disarmed) and its guard counters continue."""
    s = _crash_then_resume(_cfg(guard=True, guard_reject_mult=5.0,
                                **SUBSTRATES[sub]), NAN, tmp_path).summary()
    assert s["rejected_nonfinite"] > 0


@pytest.mark.parametrize("fused", [True, False])
def test_crash_resume_under_attack_with_guards_and_robust(fused, tmp_path):
    """A guarded robust run under a live attack and corruption crashes
    and resumes bit for bit: the attack rides the plan, and the device
    robust and guard counters carry across the snapshot."""
    cfg = _cfg(aggregator="coord_median", attack="collude_signflip",
               attack_frac=0.25, attack_scale=10.0, guard=True,
               guard_reject_mult=5.0, n_target=6, setting="DL", deadline=1e6,
               fused_rounds=fused)
    s = _crash_then_resume(cfg, (FaultSpec("nan", prob=0.25),), tmp_path,
                           stale=False).summary()
    assert s["robust_trimmed"] > 0 and s["rejected_nonfinite"] > 0


def test_chunked_crash_lands_on_a_chunk_boundary(tmp_path):
    """K = 4, eval_every 4, 12 rounds: chunks [0-3], [4-7], [8-11].
    Snapshots every 2 rounds come at chunk ends (4, then 8), and a crash
    after round 5 fires at the end of [4-7], after that chunk's snapshot:
    the resume starts at 8 and walks [8-11] as the uninterrupted run."""
    cfg = _cfg(rounds_per_dispatch=4, rounds=12)
    ckpt = str(tmp_path / "run.pkl")
    with pytest.raises(InjectedCrash):
        Simulator(cfg, device="cpu", fault_plan=FaultPlan(
            30, 12, seed=7, crash_after=5)).run(checkpoint_path=ckpt,
                                                checkpoint_every=2)
    assert load_snapshot(ckpt)["next_round"] == 8
    ref_sim = Simulator(cfg, device="cpu")
    ref = ref_sim.run()
    acct, sim = _resume(ckpt)
    _assert_same(acct, sim, ref, ref_sim)


def test_midrun_snapshot_of_clean_run_resumes_identically(tmp_path):
    """Checkpointing is passive: the last mid-run snapshot of a run that
    never crashed resumes into the same tail."""
    ckpt = str(tmp_path / "run.pkl")
    ref_sim = Simulator(_cfg(), device="cpu")
    ref = ref_sim.run(checkpoint_path=ckpt, checkpoint_every=2)
    assert 0 < load_snapshot(ckpt)["next_round"] < BASE["rounds"]
    acct, sim = _resume(ckpt)
    _assert_same(acct, sim, ref, ref_sim)
    assert summaries_equal(dict(resume_run(ckpt, device="cpu").summary()),
                           dict(ref.summary()))


@pytest.mark.parametrize("k", [1, 4])
def test_sweep_soft_crash_resume_is_bit_exact(k, tmp_path):
    spec = SweepSpec(
        axes={"policy": ["random", "relay"], "saa": [False, True]},
        base=dict(n_learners=40, rounds=8, eval_every=4, n_target=4,
                  mapping="label_uniform", rounds_per_dispatch=k),
        seeds=(0,))
    cells = spec.expand()
    ref, _ = run_batched(cells, device="cpu")
    ckpt = str(tmp_path / "sweep.pkl")
    plan = FaultPlan(n_learners=40, rounds=8, crash_after=3,
                     crash_mode="soft")
    with pytest.raises(InjectedCrash):
        run_batched(cells, device="cpu", fault_plan=plan,
                    checkpoint_path=ckpt, checkpoint_every=2)
    payload = load_snapshot(ckpt)
    assert payload["kind"] == "sweep" and payload["group"]
    results, _ = resume_sweep(ckpt, device="cpu")
    assert len(results) == len(ref)
    for got, want in zip(results, ref):
        assert got.cell.name == want.cell.name
        assert summaries_equal(dict(got.summary), dict(want.summary)), \
            got.cell.name
        assert [repr(r) for r in got.acct.records] == \
            [repr(r) for r in want.acct.records]


# K, rounds, snapshot every, crash after, the round the crash fires after
# (a chunk's last): rounds past the last snapshot are logged before it
@pytest.mark.parametrize("k, rounds, every, after, fired",
                         [(1, 8, 3, 4, 4), (4, 12, 6, 9, 11)])
def test_crash_resume_round_log_byte_continues(k, rounds, every, after,
                                               fired, tmp_path):
    """A guarded level-2 run under faults: the crashed run logged rounds
    past its last snapshot; the resumed session truncates them and the
    resumed rounds re-emit them, so ``rounds.jsonl`` equals the
    uninterrupted run's byte for byte (the counterpart of
    ``tests/test_crash_resume.py``'s round-log test)."""
    cfg = _cfg(rounds=rounds, guard=True, guard_reject_mult=5.0,
               rounds_per_dispatch=k, telemetry=2)
    plan = lambda after=None: FaultPlan(   # noqa: E731
        n_learners=BASE["n_learners"], rounds=rounds, specs=NAN, seed=7,
        crash_after=after, crash_mode="soft")
    dirs = [str(tmp_path / "clean"), str(tmp_path / "crashed")]
    ckpt = str(tmp_path / "run.pkl")
    sess = TelemetrySession(dirs[0])
    ref_sim = Simulator(cfg, device="cpu", fault_plan=plan())
    ref = ref_sim.run(telemetry=sess)
    sess.close()
    sess = TelemetrySession(dirs[1])
    with pytest.raises(InjectedCrash):
        Simulator(cfg, device="cpu", fault_plan=plan(after)).run(
            checkpoint_path=ckpt, checkpoint_every=every, telemetry=sess)
    sess.close()
    payload = load_snapshot(ckpt)
    crashed = open(os.path.join(dirs[1], "rounds.jsonl"), "rb").read()
    offset = payload["telemetry"]["rounds_offset"]
    assert 0 < offset < len(crashed)          # rounds past the snapshot
    assert len(payload["sims"][0]["state"]["acct"].round_events) == \
        crashed[:offset].count(b"\n")
    sess = TelemetrySession(dirs[1])           # the crashed run's directory
    acct = resume_run(ckpt, device="cpu", telemetry=sess)
    sess.close()
    assert summaries_equal(dict(acct.summary()), dict(ref.summary()))
    a, b = (open(os.path.join(d, "rounds.jsonl"), "rb").read() for d in dirs)
    assert a == b and a.count(b"\n") == len(ref.records)
    assert acct.round_events == ref.round_events
    assert acct.summary()["rejected_nonfinite"] > 0
    crash = [json.loads(line) for line in
             open(os.path.join(dirs[1], "events.jsonl"))
             if '"crash"' in line]
    assert crash == [{"event": "crash", "round": fired, "mode": "soft"}]


def test_sweep_round_log_byte_continues(tmp_path):
    """A level-2 sweep crashed in its first batch and resumed into the
    same telemetry directory: its round log (every cell's lines, by
    label) equals the uninterrupted sweep's byte for byte."""
    spec = SweepSpec(
        axes={"policy": ["random", "relay"], "saa": [False, True]},
        base=dict(n_learners=40, rounds=8, eval_every=4, n_target=4,
                  mapping="label_uniform", telemetry=2),
        seeds=(0,))
    cells = spec.expand()
    dirs = [str(tmp_path / "clean"), str(tmp_path / "crashed")]
    sess = TelemetrySession(dirs[0])
    ref, _ = run_batched(cells, device="cpu", telemetry=sess)
    sess.close()
    ckpt = str(tmp_path / "sweep.pkl")
    plan = FaultPlan(n_learners=40, rounds=8, crash_after=4,
                     crash_mode="soft")
    sess = TelemetrySession(dirs[1])
    with pytest.raises(InjectedCrash):
        run_batched(cells, device="cpu", fault_plan=plan,
                    checkpoint_path=ckpt, checkpoint_every=3, telemetry=sess)
    sess.close()
    sess = TelemetrySession(dirs[1])
    results, _ = resume_sweep(ckpt, device="cpu", telemetry=sess)
    sess.close()
    a, b = (open(os.path.join(d, "rounds.jsonl"), "rb").read() for d in dirs)
    assert a == b and a
    assert results.round_logs() == ref.round_logs()
    assert set(ref.round_logs()) == {c.name for c in cells}


def test_snapshot_error_paths(tmp_path):
    with pytest.raises(SnapshotError):
        load_snapshot(str(tmp_path / "missing.pkl"))
    bad = str(tmp_path / "bad.pkl")
    save_snapshot(bad, {"version": 999, "kind": "pipeline"})
    with pytest.raises(SnapshotError, match="version"):
        load_snapshot(bad)
    save_snapshot(bad, [1, 2])
    with pytest.raises(SnapshotError, match="not a run snapshot"):
        load_snapshot(bad)
    save_snapshot(bad, {"version": 1, "kind": "mystery"})
    with pytest.raises(SnapshotError, match="unknown snapshot kind"):
        resume_run(bad, device="cpu")
    save_snapshot(bad, {"version": 1, "kind": "engine"})
    with pytest.raises(SnapshotError, match="not a sweep snapshot"):
        resume_sweep(bad, device="cpu")


def test_save_snapshot_is_atomic(tmp_path, monkeypatch):
    """A crash while writing leaves the previous snapshot readable: the
    payload goes to a temporary file, then ``os.replace`` moves it in."""
    p = str(tmp_path / "snap.pkl")
    save_snapshot(p, {"version": 1, "kind": "engine", "tag": "old"})
    save_snapshot(p, {"version": 1, "kind": "engine", "tag": "new"})
    assert load_snapshot(p)["tag"] == "new"
    assert not os.path.exists(p + ".tmp")

    def dies(*_a, **_k):
        raise OSError("killed mid-write")
    monkeypatch.setattr("pickle.dump", dies)
    with pytest.raises(OSError):
        save_snapshot(p, {"version": 1, "kind": "engine", "tag": "lost"})
    assert load_snapshot(p)["tag"] == "new"


def test_hard_crash_sigkill_and_cli_resume(tmp_path):
    """``--crash-after 3 --crash-hard`` SIGKILLs the sweep (exit 137),
    then ``--resume`` completes it with results equal to an uninterrupted
    smoke sweep's."""
    env = {**os.environ, "PYTHONPATH": "src"}
    ckpt = str(tmp_path / "sweep.pkl")
    out = str(tmp_path / "resumed.json")

    def cli(*args):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.sweeps", "--device", "cpu",
             *args], cwd=ROOT, env=env, capture_output=True, text=True)
    crashed = cli("--smoke", "--checkpoint", ckpt, "--crash-after", "3",
                  "--crash-hard")
    assert crashed.returncode in (137, -9), crashed.stderr[-2000:]
    assert load_snapshot(ckpt)["kind"] == "sweep"
    resumed = cli("--resume", ckpt, "--out", out)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    clean, _ = run_batched(demo_spec(True).expand(), device="cpu")
    got = json.loads(open(out).read())["results"]
    assert got == json.loads(json.dumps(clean.to_json_dict()))


def test_pytree_roundtrip_and_mismatch(tmp_path):
    tree = {"w": {"a": torch.randn(3, 4), "b": torch.arange(5)},
            "h": torch.randn(2, 2).to(torch.bfloat16)}
    path = str(tmp_path / "ck" / "tree.npz")
    save_pytree(path, tree)
    back = load_pytree(path, tree)
    assert torch.equal(back["w"]["a"], tree["w"]["a"])
    assert torch.equal(back["w"]["b"], tree["w"]["b"])
    assert back["h"].dtype == torch.bfloat16
    assert torch.equal(back["h"].view(torch.int16), tree["h"].view(torch.int16))
    with pytest.raises(CheckpointError, match="missing keys"):
        load_pytree(path, {"w": tree["w"]})
    with pytest.raises(CheckpointError, match="has shape"):
        load_pytree(path, {**tree, "h": torch.zeros(3, 3, dtype=torch.bfloat16)})


def test_snapshot_holds_device_counters_and_host_rows(tmp_path):
    """A pipeline snapshot carries the device counters not yet in the
    accounting and each stale row at the cache's width; the row ids in
    the resumed cache need not match the crashed one's."""
    cfg = _cfg(aggregator="trimmed_mean", trim_k=1, attack="alie",
               guard=True, n_target=6, setting="DL", deadline=1e6)
    sim = Simulator(cfg, device="cpu", fault_plan=_plan(None, NAN))
    from repro_torch.sim.pipeline import RoundPipeline
    pipe = RoundPipeline(sim)
    for r in range(4):
        pipe.step(r)
    snap = pipe.snapshot(4)
    st = snap["sims"][0]["state"]
    assert st["counts"]["robust"].tolist() == pipe.robust_counts[0].tolist()
    assert st["counts"]["guard"].tolist() == pipe.guard_counts[0].tolist()
    assert st["counts"]["robust"][1] > 0
    for (_lid, _o, _a, _d, _su, row), f in zip(st["stale"], sim.stale_cache):
        np.testing.assert_array_equal(row, pipe.cache.rows[f.delta].numpy())
