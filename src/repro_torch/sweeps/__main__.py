"""Sweep demo / smoke entry point (port of ``python -m repro.sweeps``).

  PYTHONPATH=src python -m repro_torch.sweeps --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.sweeps                  # GPU demo grid
  PYTHONPATH=src python -m repro_torch.sweeps --list-selectors
  PYTHONPATH=src python -m repro_torch.sweeps --list-models
  PYTHONPATH=src python -m repro_torch.sweeps --smoke --benchmark tokens \
      --model transformer,rwkv6       # an LM sweep
  PYTHONPATH=src python -m repro_torch.sweeps --selector random,oort,safa
  PYTHONPATH=src python -m repro_torch.sweeps --rounds-per-dispatch 4
  PYTHONPATH=src python -m repro_torch.sweeps --smoke --checkpoint S.pkl \
      --crash-after 3 --crash-hard          # exits 137 after round 3
  PYTHONPATH=src python -m repro_torch.sweeps --resume S.pkl --out R.json
  PYTHONPATH=src python -m repro_torch.sweeps --smoke --telemetry-dir T

Expands a policy x SAA x hardware grid (or, with ``--selector``, a
selector race under matched seeds; ``--model`` adds a learner-model axis
and ``--benchmark`` overrides the benchmark), runs it batched, re-runs every cell
serially to assert equal metrics, and prints the paper-style
resource-to-accuracy table with the batched and serial wall times.
``--rounds-per-dispatch K`` runs the batches in K-round chunks, against
serial runs at K = 1.  ``--checkpoint PATH`` writes a crash-safe sweep
snapshot every ``--checkpoint-every`` rounds, ``--crash-after R`` crashes
the batched run once round R is done (an exception, or with
``--crash-hard`` a SIGKILL, exit code 137), and ``--resume PATH`` finishes
a crashed sweep from its snapshot, bit for bit the uninterrupted sweep.
``--telemetry-dir DIR`` runs the batched cells at telemetry level 2 and
exports the run there: ``rounds.jsonl`` (a line a cell and recorded
round), ``events.jsonl``, ``trace.json`` (Perfetto) and ``metrics.prom``;
the serial runs they are checked against stay at level 0 and K = 1.
Unlike the reference it writes a JSON payload only when ``--out`` names a
path.  The reference's sharding flags raise, naming the ROADMAP.md item
that ports them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib

from repro_torch.sim.engine import resolve_device
from repro_torch.sim.partition import TOKEN_BENCHMARKS
from repro_torch.sweeps import (SweepSpec, assert_parity, run_batched,
                                run_serial)
from repro_torch.sweeps.report import savings_line, text_table
from repro_torch.sweeps.runner import exact_parity, resume_sweep, unported

# flag -> (what it asks for, the ROADMAP.md queue 1 item that ports it)
UNPORTED_FLAGS = {
    "sharded": ("sweep-axis sharding", 14),
    "participant_shards": ("participant sharding", 14),
}


def demo_spec(smoke: bool) -> SweepSpec:
    """The reference's demo grid (``repro.sweeps.__main__.demo_spec``)."""
    if smoke:
        return SweepSpec(
            axes={"policy": ["random", "relay"], "saa": [False, True]},
            base=dict(n_learners=60, rounds=8, eval_every=4, n_target=5,
                      mapping="label_uniform"),
            seeds=(0,))
    return SweepSpec(
        axes={"policy": ["random", "oort", "safa", "relay"],
              "saa": [False, True],
              "hardware": ["HS1", "HS3"]},
        base=dict(n_learners=100, rounds=40, eval_every=10,
                  mapping="label_uniform"),
        seeds=(0, 1))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="small CI grid")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU, required)")
    ap.add_argument("--out", default=None,
                    help="write the JSON payload (wall times, results) here")
    ap.add_argument("--selector", default=None, metavar="A,B",
                    help="race selection strategies: replaces the demo "
                         "grid's policy axis with a selector axis")
    ap.add_argument("--aggregator", default=None, metavar="A,B",
                    help="add a robust-aggregator sweep axis")
    ap.add_argument("--attack", default=None, metavar="X,Y",
                    help="add a coordinated-attack sweep axis")
    ap.add_argument("--attack-frac", type=float, default=0.25,
                    help="attacker fraction of the population (with --attack)")
    ap.add_argument("--model", default=None, metavar="A,B",
                    help="add a learner-model sweep axis (see --list-models; "
                         "LM models need --benchmark tokens)")
    ap.add_argument("--benchmark", default=None, metavar="B",
                    help="override the grid's benchmark (classifier: speech/"
                         "cifar10/openimage; LM: tokens/tokens_skew)")
    ap.add_argument("--list-selectors", action="store_true",
                    help="print the selector strategy table and exit")
    ap.add_argument("--list-aggregators", action="store_true",
                    help="print the robust-aggregator strategy table and exit")
    ap.add_argument("--list-models", action="store_true",
                    help="print the learner-model strategy table and exit")
    ap.add_argument("--sharded", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--participant-shards", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--rounds-per-dispatch", type=int, default=1,
                    metavar="K", help="rounds a chunk of the batched run "
                    "(the serial runs stay at 1)")
    ap.add_argument("--checkpoint", default=None,
                    help="write crash-safe sweep snapshots to this path")
    ap.add_argument("--checkpoint-every", type=int, default=2,
                    help="rounds between snapshots (with --checkpoint)")
    ap.add_argument("--resume", default=None, metavar="CKPT",
                    help="finish a crashed sweep from its snapshot and "
                         "print (and with --out write) its results")
    ap.add_argument("--crash-after", type=int, default=None, metavar="R",
                    help="chaos: crash the batched run once round R is done")
    ap.add_argument("--crash-hard", action="store_true",
                    help="chaos: crash by SIGKILL instead of an exception")
    ap.add_argument("--telemetry-dir", default=None, metavar="DIR",
                    help="run the batched cells at telemetry level 2 and "
                         "export rounds.jsonl, events.jsonl, trace.json "
                         "(Perfetto) and metrics.prom there")
    args = ap.parse_args(argv)

    for flag, (what, item) in UNPORTED_FLAGS.items():
        value = getattr(args, flag)
        if value not in (None, False, 0):
            raise unported(what, item)
    if args.list_selectors or args.list_aggregators or args.list_models:
        if args.list_selectors:
            from repro_torch.selection import describe_selectors
            print(describe_selectors())
        if args.list_aggregators:
            from repro_torch.robust.aggregators import describe_aggregators
            print(describe_aggregators())
        if args.list_models:
            from repro_torch.learners import describe_models
            print(describe_models())
        return
    telemetry = None
    if args.telemetry_dir:
        from repro_torch.telemetry import TelemetrySession
        telemetry = TelemetrySession(args.telemetry_dir)
    try:
        _run(args, telemetry)
    finally:
        if telemetry is not None:
            telemetry.close()
            print(f"# telemetry exported to {args.telemetry_dir}")


def _run(args, telemetry) -> None:
    if args.resume:
        results, wall = resume_sweep(args.resume, device=args.device,
                                     telemetry=telemetry)
        print(f"# resumed from {args.resume} in {wall:.2f}s "
              f"({len(results)} cells)")
        print(text_table(results))
        if args.out:
            payload = {"bench": "sweeps", "mode": "resume",
                       "resumed_from": args.resume, "cells": len(results),
                       "results": results.to_json_dict()}
            pathlib.Path(args.out).write_text(json.dumps(payload, indent=2)
                                              + "\n")
            print(f"\n# wrote {args.out}")
        return

    spec = demo_spec(args.smoke)
    if args.selector:
        axes = {k: v for k, v in spec.axes.items() if k != "policy"}
        spec.axes = {"selector": args.selector.split(","), **axes}
    if args.aggregator:
        kinds = args.aggregator.split(",")
        spec.axes = dict(spec.axes, aggregator=kinds)
        if any(k in ("krum", "multi_krum") for k in kinds):
            spec.base = dict(spec.base, krum_f=max(
                int(dict(spec.base).get("krum_f", 0)), 1))
    if args.attack:
        spec.axes = dict(spec.axes, attack=args.attack.split(","))
        spec.base = dict(spec.base, attack_frac=args.attack_frac)
    if args.model:
        spec.axes = dict(spec.axes, model=args.model.split(","))
    if args.benchmark:
        base = dict(spec.base, benchmark=args.benchmark)
        # token benchmarks own their data-to-learner mapping (the shard
        # structure): the grid's mapping goes
        if args.benchmark in TOKEN_BENCHMARKS:
            base.pop("mapping", None)
        spec.base = base
    cells = spec.expand()
    if args.rounds_per_dispatch != 1:
        cells = [dataclasses.replace(c, config=dataclasses.replace(
            c.config, rounds_per_dispatch=args.rounds_per_dispatch))
            for c in cells]
    if telemetry is not None:
        cells = [dataclasses.replace(c, config=dataclasses.replace(
            c.config, telemetry=2)) for c in cells]
    print(f"# sweep: {len(cells)} cells "
          f"({' x '.join(f'{a}[{len(v)}]' for a, v in spec.axes.items())}"
          f" x seeds[{len(spec.seeds)}])")
    fault_plan = None
    if args.crash_after is not None:
        from repro_torch.faults import FaultPlan
        fault_plan = FaultPlan(
            n_learners=max(c.config.n_learners for c in cells),
            rounds=max(c.config.rounds for c in cells),
            crash_after=args.crash_after,
            crash_mode="hard" if args.crash_hard else "soft")
    results, batched_wall = run_batched(
        cells, device=args.device, fault_plan=fault_plan,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every if args.checkpoint else 0,
        telemetry=telemetry)
    # the serial runs stay at K = 1 and telemetry level 0: an independent
    # ground truth (level 2 moves no bit, so parity also shows that)
    serial, serial_wall = run_serial(
        [dataclasses.replace(c, config=dataclasses.replace(
            c.config, rounds_per_dispatch=1, telemetry=0)) for c in cells],
        device=args.device)
    exact = exact_parity(resolve_device(args.device))
    assert_parity(results, serial, exact=exact)
    speedup = serial_wall / max(batched_wall, 1e-9)
    print(f"# batched {batched_wall:.2f}s vs serial {serial_wall:.2f}s "
          f"({speedup:.1f}x), per-cell metrics equal"
          + ("" if exact else " in their host fields") + "\n")
    print(text_table(results))
    if "policy" in spec.axes:
        print()
        print(savings_line(results, {"policy": "relay", "saa": True},
                           {"policy": "random", "saa": False}))
    if args.out:
        payload = {"bench": "sweeps", "mode": "smoke" if args.smoke else "demo",
                   "device": args.device or "cuda",
                   "rounds_per_dispatch": args.rounds_per_dispatch,
                   "cells": len(cells), "batched_wall_s": batched_wall,
                   "serial_wall_s": serial_wall, "speedup": speedup,
                   "parity": True, "results": results.to_json_dict()}
        pathlib.Path(args.out).write_text(json.dumps(payload, indent=2) + "\n")
        print(f"\n# wrote {args.out}")


if __name__ == "__main__":
    main()
