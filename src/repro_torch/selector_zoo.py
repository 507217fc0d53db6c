"""Selector-zoo race: every registered selection strategy on one
shared-seed grid, head-to-head on resource-to-accuracy (port of
``examples/selector_zoo.py``).

The cells are ``zoo_spec``'s: one per selector and seed, every selector on
bit-identical datasets, device populations and availability traces, so
accuracy and resource differences come from the selection policy alone.
Each cell runs serially through ``Simulator.run()``, on the GPU unless
``--device`` names another, with the SAA server step through the CUDA
kernels (``use_agg_kernel=True``, as ``repro_torch.quickstart`` runs it).
The reference's batched runner, and its assert that batched runs equal
serial ones, come with the sweeps (ROADMAP.md queue 1 item 9); its
``--telemetry-dir`` with telemetry (item 12).

  PYTHONPATH=src python -m repro_torch.selector_zoo [--smoke]
  PYTHONPATH=src python -m repro_torch.selector_zoo --selectors random,oort,safa
"""
from __future__ import annotations

import argparse
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
          f"seed(s) = {len(cells)} cells, serial")
    summaries, wall = run_serial(cells, device=args.device)
    print(f"# serial {wall:.2f}s\n")
    print(text_table(cells, summaries))
    return 0


if __name__ == "__main__":
    sys.exit(main())
