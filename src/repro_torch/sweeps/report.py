"""Paper-style reporting over sweep results (port of
``repro.sweeps.report``, unchanged but for its import).

Renders the resource-to-accuracy comparison (the paper's headline currency,
Figs. 2/6/7) for a whole grid the way ``examples/quickstart.py`` prints it
for two cells: one row per policy/scenario group (seeds aggregated), columns
for accuracy, resource usage, waste, and unique participation — as plain
text or a markdown table.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.sweeps.results import SweepResults

COLUMNS = (
    ("final_accuracy", "accuracy", "{:.3f}"),
    ("best_accuracy", "best", "{:.3f}"),
    ("resource_used", "resources(s)", "{:.0f}"),
    ("waste_fraction", "waste", "{:.1%}"),
    ("unique_participants", "unique", "{:.0f}"),
)


def _group_label(row: dict, by: Sequence[str]) -> str:
    return " ".join(f"{a}={row[a]}" for a in by)


def resource_to_accuracy_rows(results: SweepResults,
                              by: Optional[Sequence[str]] = None) -> list[dict]:
    by = ([a for a in results.axes if a != "seed"]
          if by is None else list(by))
    rows = results.group_stats(by=by)
    # best resource-to-accuracy first: highest accuracy per resource second
    rows.sort(key=lambda r: (-r["final_accuracy"], r["resource_used"]))
    for r in rows:
        r["_label"] = _group_label(r, by)
    return rows


def markdown_table(results: SweepResults,
                   by: Optional[Sequence[str]] = None) -> str:
    rows = resource_to_accuracy_rows(results, by)
    head = "| scenario | " + " | ".join(h for _, h, _ in COLUMNS) + " | seeds |"
    sep = "|" + "---|" * (len(COLUMNS) + 2)
    lines = [head, sep]
    for r in rows:
        cells = " | ".join(fmt.format(r[k]) for k, _, fmt in COLUMNS)
        lines.append(f"| {r['_label']} | {cells} | {r['n']} |")
    return "\n".join(lines)


def text_table(results: SweepResults,
               by: Optional[Sequence[str]] = None) -> str:
    rows = resource_to_accuracy_rows(results, by)
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


def savings_line(results: SweepResults, best: dict, baseline: dict) -> str:
    """One-line takeaway comparing two coordinate selections, e.g.
    ``savings_line(res, {"policy": "relay"}, {"policy": "random"})``."""
    b = results.filter(**best).group_stats(by=list(best))
    r = results.filter(**baseline).group_stats(by=list(baseline))
    if not b or not r or not r[0]["resource_used"]:
        return "savings: n/a"
    save = 1 - b[0]["resource_used"] / r[0]["resource_used"]
    return (f"{_group_label(b[0], list(best))} used {save:.0%} fewer learner "
            f"resources than {_group_label(r[0], list(baseline))} "
            f"(accuracy {b[0]['final_accuracy']:.3f} vs "
            f"{r[0]['final_accuracy']:.3f})")
