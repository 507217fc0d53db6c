"""Chaos demo on the port: the fused round pipeline under deterministic
fault injection and coordinated attacks (counterpart of
``examples/chaos_round.py``).

One scenario per guard mode, same config and seeded fault plan, so every
difference comes from the guard mode alone:

  1. clean baseline    - no faults, no guard;
  2. guard=off         - NaN/Inf emitters, scaled-garbage rows (x1e4),
     post-training drops and replayed stale deliveries reach the model;
  3. guard=reject      - median-norm reject + quorum: the poisoned rows are
     rejected on the device and the run lands near the clean baseline;
  4. guard=clip+reject - adds an L2 clip on the surviving rows.

A robustness phase arms a coordinated ``collude_signflip`` attack and races
plain ``saa`` against ``coord_median``: the defense must win.  A last phase
runs the guarded run at telemetry level 2, crashes it after round 3 (a
soft crash at a snapshot boundary) and resumes it from its snapshot into
the crashed run's telemetry directory: the resumed run's summary and final
params must equal the uninterrupted run's bit for bit, and its
``rounds.jsonl`` round log the uninterrupted run's byte for byte.

Exits non-zero if a guarded run ends non-finite, rejects nothing or lands
farther than ``--tolerance`` from clean, if the defense loses, or if the
resume diverges.  ``--telemetry-dir DIR`` runs the four guard modes at
level 2, each logging into ``DIR/<mode>`` (round by round comparable with
the reference's logs of the same scenarios).

  PYTHONPATH=src python -m repro_torch.chaos_round --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.chaos_round     # the GPU, full size
"""
from __future__ import annotations

import argparse
import math
import os
import pathlib
import sys
import tempfile

import torch

from repro_torch.checkpoint import build_resumed_pipeline, load_snapshot
from repro_torch.faults import FaultPlan, FaultSpec, InjectedCrash
from repro_torch.sim import SimConfig, Simulator
from repro_torch.sweeps.runner import summaries_equal
from repro_torch.telemetry import TelemetrySession


def build(smoke: bool):
    """The example's common config and its fault plan (seed 42)."""
    common = dict(n_learners=40 if smoke else 100,
                  rounds=8 if smoke else 40,
                  eval_every=4 if smoke else 10,
                  n_target=4 if smoke else 10,
                  selector="priority", saa=True, scaling_rule="relay",
                  mapping="label_uniform", seed=0)
    plan = FaultPlan(
        n_learners=common["n_learners"], rounds=common["rounds"],
        specs=(FaultSpec("nan", prob=0.08),
               FaultSpec("inf", prob=0.04),
               FaultSpec("scale", prob=0.08, scale=1e4),
               FaultSpec("post_drop", prob=0.05),
               FaultSpec("replay", prob=0.10)),
        seed=42)
    return common, plan


# one scenario per guard mode: (label, config overrides, faulted?)
GUARD_MODES = (
    ("clean", dict(), False),
    ("guard=off", dict(), True),
    ("guard=reject", dict(guard=True, guard_reject_mult=5.0, quorum=1),
     True),
    ("guard=clip+reject", dict(guard=True, guard_clip=10.0,
                               guard_reject_mult=5.0, quorum=1), True),
)


def attack_config(smoke: bool) -> dict:
    """The robustness phase's config: DL with an unbounded deadline keeps
    cohorts large enough that the attacker fraction sits below the
    median's breakdown point."""
    return dict(n_learners=40 if smoke else 100,
                rounds=10 if smoke else 40,
                eval_every=5 if smoke else 10,
                n_target=10, selector="priority", saa=True,
                scaling_rule="relay", mapping="label_uniform", seed=0,
                setting="DL", deadline=1e6,
                attack="collude_signflip", attack_frac=0.1,
                attack_scale=50.0)


def crash_resume(cfg, plan, *, device=None, crash_after: int = 3,
                 checkpoint_every: int = 2):
    """The uninterrupted run of ``cfg`` under ``plan`` (crash disarmed),
    then the same run crashed (soft) after round ``crash_after`` with a
    snapshot every ``checkpoint_every`` rounds, then its resume from the
    last snapshot, each with a telemetry session: the uninterrupted run's
    logs into one directory, the crashed run's and then its resume's into
    another.  Returns {"ref", "resumed": (Accounting, Simulator),
    "next_round": the resume's first round, "pipeline": the resumed
    RoundPipeline (its ``stats``), "logs": the two ``rounds.jsonl``
    files' bytes (uninterrupted, crashed and resumed), "truncated": the
    crashed run's log size and the snapshot's offset, to which the resume
    truncated it, "snapshots": the crashed run's snapshot count and their
    seconds in all (its ``checkpoint`` span histogram)}."""
    crash = FaultPlan(n_learners=plan.n_learners, rounds=plan.rounds,
                      specs=plan.specs, seed=plan.seed,
                      crash_after=crash_after, crash_mode="soft")
    with tempfile.TemporaryDirectory() as tmp:
        dirs = [os.path.join(tmp, "clean"), os.path.join(tmp, "crashed")]
        ckpt = os.path.join(tmp, "run.pkl")
        ref_sim = Simulator(cfg, device=device,
                            fault_plan=plan.without_crash())
        ref_sess = TelemetrySession(dirs[0])
        ref = ref_sim.run(telemetry=ref_sess)
        ref_sess.close()
        crash_sess = TelemetrySession(dirs[1])
        try:
            Simulator(cfg, device=device, fault_plan=crash).run(
                checkpoint_path=ckpt, checkpoint_every=checkpoint_every,
                telemetry=crash_sess)
            raise RuntimeError("the scheduled crash never fired")
        except InjectedCrash:
            pass
        finally:
            crash_sess.close()
        snaps = crash_sess.registry.histogram("span_seconds_checkpoint")
        payload = load_snapshot(ckpt)
        truncated = (os.path.getsize(os.path.join(dirs[1], "rounds.jsonl")),
                     payload["telemetry"]["rounds_offset"])
        sess = TelemetrySession(dirs[1])     # the crashed run's directory
        pipe = build_resumed_pipeline(payload, device=device, telemetry=sess)
        acct = pipe.run()[0]
        sess.close()
        logs = [pathlib.Path(d, "rounds.jsonl").read_bytes() for d in dirs]
    return {"ref": (ref, ref_sim), "resumed": (acct, pipe.sims[0]),
            "next_round": payload["next_round"], "pipeline": pipe,
            "logs": logs, "truncated": truncated,
            "snapshots": (snaps.count, snaps.sum)}


def same_bits(a, b) -> bool:
    """Two fp32 tensors equal bit for bit (their int32 views)."""
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="small run")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU, required)")
    ap.add_argument("--tolerance", type=float, default=0.15,
                    help="max |guarded - clean| final-accuracy gap")
    ap.add_argument("--telemetry-dir", default=None, metavar="DIR",
                    help="run the guard modes at telemetry level 2, each "
                         "logging into DIR/<mode>")
    args = ap.parse_args(argv)

    common, plan = build(args.smoke)
    print("=== scheduled faults (deterministic, seed=42) ===")
    print("  " + "  ".join(f"{k}={v}" for k, v in plan.counts().items()
                           if v))
    runs = {}
    for i, (label, extra, faulted) in enumerate(GUARD_MODES):
        print(f"\n=== {i + 1}/{len(GUARD_MODES)} {label} ===")
        sess = None
        if args.telemetry_dir:
            extra = dict(extra, telemetry=2)
            sess = TelemetrySession(os.path.join(args.telemetry_dir, label))
        runs[label] = Simulator(
            SimConfig(**common, **extra), device=args.device,
            fault_plan=plan if faulted else None).run(
                telemetry=sess).summary()
        if sess is not None:
            sess.close()

    print("\n--- outcome ---")
    print(f"{'':20s}{'accuracy':>10s}{'rej_nonfin':>12s}{'rej_norm':>10s}"
          f"{'quorum':>8s}")
    for label, s in runs.items():
        print(f"{label:20s}{s['final_accuracy']:10.3f}"
              f"{s['rejected_nonfinite']:12d}{s['rejected_norm']:10d}"
              f"{s['quorum_skips']:8d}")
    clean = runs["clean"]
    for label in ("guard=reject", "guard=clip+reject"):
        grd = runs[label]
        gap = abs(grd["final_accuracy"] - clean["final_accuracy"])
        rejected = grd["rejected_nonfinite"] + grd["rejected_norm"]
        print(f"{label}: rejected {rejected} poisoned rows, skipped "
              f"{grd['quorum_skips']} quorum-less applies, landed within "
              f"{gap:.3f} of clean (tolerance {args.tolerance})")
        if not math.isfinite(grd["final_accuracy"]) or gap > args.tolerance:
            print(f"FAIL: {label} diverged from the clean baseline",
                  file=sys.stderr)
            return 1
        if rejected == 0:
            print("FAIL: the plan scheduled corruption but nothing was "
                  "rejected", file=sys.stderr)
            return 1

    print(f"\n=== {len(GUARD_MODES) + 1}/{len(GUARD_MODES) + 2} "
          "coordinated attack: saa vs coord_median ===")
    base = attack_config(args.smoke)
    under = Simulator(SimConfig(**base), device=args.device).run().summary()
    defended = Simulator(SimConfig(**base, aggregator="coord_median"),
                         device=args.device).run().summary()
    print(f"{'saa (attacked)':20s}{under['final_accuracy']:10.3f}")
    print(f"{'coord_median':20s}{defended['final_accuracy']:10.3f}"
          f"   trimmed {defended['robust_trimmed']} rows")
    if defended["robust_trimmed"] == 0 or \
            defended["final_accuracy"] <= under["final_accuracy"]:
        print("FAIL: coord_median did not beat attacked saa",
              file=sys.stderr)
        return 1

    print(f"\n=== {len(GUARD_MODES) + 2}/{len(GUARD_MODES) + 2} "
          "crash mid-run, resume, compare round logs ===")
    cfg = SimConfig(guard=True, guard_reject_mult=5.0, quorum=1, telemetry=2,
                    **common)
    out = crash_resume(cfg, plan, device=args.device)
    (ref, ref_sim), (got, sim) = out["ref"], out["resumed"]
    if not summaries_equal(got.summary(), ref.summary()) or \
            not same_bits(sim.flat_params, ref_sim.flat_params):
        print("FAIL: the resumed run diverged from the uninterrupted one",
              file=sys.stderr)
        return 1
    clean_log, resumed_log = out["logs"]
    if clean_log != resumed_log or not clean_log or \
            got.round_events != ref.round_events:
        print("FAIL: the resumed round log does not continue the crashed "
              "run's byte for byte", file=sys.stderr)
        return 1
    print(f"resumed at round {out['next_round']}: summary and params bit "
          "for bit the uninterrupted run's; round logs byte-equal "
          f"({len(clean_log.splitlines())} events, {len(clean_log)} bytes)")
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
