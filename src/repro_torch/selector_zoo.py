"""Selector-zoo race: every registered selection strategy on one
shared-seed grid, head-to-head on resource-to-accuracy (port of
``examples/selector_zoo.py``).

The cells are ``zoo_spec``'s: one per selector and seed, every selector on
bit-identical datasets, device populations and availability traces, so
accuracy and resource differences come from the selection policy alone.
The cells run batched (``repro_torch.sweeps.SweepRunner``: one lockstep
batch a selector), then each serially through ``Simulator.run()``, and the
two must agree: bit for bit on the CPU, in every host-decided summary field
on the GPU (``repro_torch.sweeps.runner.exact_parity``).  They run on the
GPU unless ``--device`` names another, with the SAA server step through
the CUDA kernels (``use_agg_kernel=True``, as ``repro_torch.quickstart``
runs it).  ``--telemetry-dir DIR`` runs the batched cells at telemetry
level 2 and exports the run there (``rounds.jsonl``, ``events.jsonl``,
``trace.json``, ``metrics.prom``); the serial runs stay at level 0.  The
reference also renders the zoo's figures from that directory; the port
renders none: its figures belong to the port's benchmark (the reference's
``benchmarks/figures.py``, which needs matplotlib).

  PYTHONPATH=src python -m repro_torch.selector_zoo [--smoke]
  PYTHONPATH=src python -m repro_torch.selector_zoo --selectors random,oort,safa
  PYTHONPATH=src python -m repro_torch.selector_zoo --smoke --device cpu \
      --telemetry-dir T
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np

from repro_torch.selection import SELECTOR_TABLE, describe_selectors
from repro_torch.sim import SimConfig, Simulator

# the reference's resource-to-accuracy columns (repro.sweeps.report)
COLUMNS = (
    ("final_accuracy", "accuracy", "{:.3f}"),
    ("best_accuracy", "best", "{:.3f}"),
    ("resource_used", "resources(s)", "{:.0f}"),
    ("waste_fraction", "waste", "{:.1%}"),
    ("unique_participants", "unique", "{:.0f}"),
)


def zoo_base(smoke: bool) -> dict:
    """``zoo_spec``'s base config, with the SAA kernels on."""
    return dict(n_learners=60 if smoke else 100,
                rounds=8 if smoke else 40,
                eval_every=4 if smoke else 10,
                n_target=5 if smoke else 10,
                saa=True, mapping="label_uniform", use_agg_kernel=True)


def zoo_cells(selectors, smoke: bool, seeds) -> list:
    """(name, selector, seed, SimConfig) per cell, in the reference's
    order: selectors, then seeds."""
    return [(f"selector={s}/seed={seed}", s, int(seed),
             SimConfig(**zoo_base(smoke), selector=s, seed=int(seed)))
            for s in selectors for seed in seeds]


def sweep_cells(cells) -> list:
    """The zoo's cells as ``repro_torch.sweeps`` cells."""
    from repro_torch.sweeps import Cell
    return [Cell(name, (("selector", sel), ("seed", seed)), cfg)
            for name, sel, seed, cfg in cells]


def run_batched(cells, device=None, telemetry=None):
    """The cells as lockstep sweep batches, at telemetry level 2 into the
    session ``telemetry`` when one is given; returns (summaries, wall
    seconds)."""
    from repro_torch.sweeps import run_batched as run
    cells = sweep_cells(cells)
    if telemetry is not None:
        cells = [dataclasses.replace(c, config=dataclasses.replace(
            c.config, telemetry=2)) for c in cells]
    results, wall = run(cells, device=device, telemetry=telemetry)
    return [dict(r.summary) for r in results], wall


def assert_batched_equals_serial(batched, serial, device=None) -> None:
    """Each cell's batched summary equals its serial one (``exact_parity``
    decides whether in every field or in the host-decided ones)."""
    from repro_torch.sim.engine import resolve_device
    from repro_torch.sweeps.runner import HOST_KEYS, exact_parity
    from repro_torch.sweeps import summaries_equal
    keys = None if exact_parity(resolve_device(device)) else HOST_KEYS
    for i, (a, b) in enumerate(zip(batched, serial)):
        if not summaries_equal(a, b, keys):
            raise AssertionError(f"zoo cell {i}: batched {a} != serial {b}")


def run_serial(cells, device=None):
    """One ``Simulator(cfg).run()`` per cell; returns (summaries, wall
    seconds)."""
    t0 = time.time()
    summaries = [Simulator(cfg, device=device).run().summary()
                 for *_, cfg in cells]
    return summaries, time.time() - t0


def text_table(cells, summaries) -> str:
    """One row per selector (mean over its seeds), best resource-to-
    accuracy first, as the reference's ``text_table`` prints a zoo."""
    groups: dict = {}
    for (_, s, _, _), summ in zip(cells, summaries):
        groups.setdefault(s, []).append(summ)
    rows = []
    for s, members in groups.items():
        row = {k: float(np.nanmean([m[k] for m in members], dtype=float))
               for k, _, _ in COLUMNS}
        rows.append(dict(row, _label=f"selector={s}", n=len(members)))
    rows.sort(key=lambda r: (-r["final_accuracy"], r["resource_used"]))
    label_w = max([len(r["_label"]) for r in rows] + [8]) + 2
    head = ("scenario".ljust(label_w)
            + "".join(h.rjust(14) for _, h, _ in COLUMNS) + "  seeds".rjust(7))
    lines = [head, "-" * len(head)]
    for r in rows:
        lines.append(r["_label"].ljust(label_w)
                     + "".join(fmt.format(r[k]).rjust(14)
                               for k, _, fmt in COLUMNS)
                     + str(r["n"]).rjust(7))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="tiny race")
    ap.add_argument("--selectors", default=",".join(SELECTOR_TABLE),
                    help="comma list from the registered zoo "
                         "(default: all of it)")
    ap.add_argument("--seeds", default="0", help="comma list of shared seeds")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU, required)")
    ap.add_argument("--telemetry-dir", default=None, metavar="DIR",
                    help="run the batched cells at telemetry level 2 and "
                         "export the run's timeline there")
    args = ap.parse_args(argv)

    selectors = args.selectors.split(",")
    unknown = [s for s in selectors if s not in SELECTOR_TABLE]
    if unknown:
        print(f"unknown selectors {unknown}; registered zoo:\n")
        print(describe_selectors())
        return 2
    seeds = tuple(int(s) for s in args.seeds.split(","))
    cells = zoo_cells(selectors, args.smoke, seeds)
    print(f"# zoo race: {len(selectors)} selectors x {len(seeds)} shared "
          f"seed(s) = {len(cells)} cells, batched and serial")
    telemetry = None
    if args.telemetry_dir:
        from repro_torch.telemetry import TelemetrySession
        telemetry = TelemetrySession(args.telemetry_dir)
    try:
        batched, wall_b = run_batched(cells, device=args.device,
                                      telemetry=telemetry)
    finally:
        if telemetry is not None:
            telemetry.close()
            print(f"# telemetry exported to {args.telemetry_dir}")
    summaries, wall = run_serial(cells, device=args.device)
    assert_batched_equals_serial(batched, summaries, device=args.device)
    print(f"# batched {wall_b:.2f}s vs serial {wall:.2f}s; batched == "
          "serial\n")
    print(text_table(cells, summaries))
    return 0


if __name__ == "__main__":
    sys.exit(main())
