"""Condense the pod dry run's records into one markdown table, and compare
two record sets.

    python tools/dryrun_table.py [experiments/dryrun_torch]
    python tools/dryrun_table.py A.json B.json     # FLOPs a chip, A against B

A record set is a directory of ``<arch>__<shape>__<mesh>.json`` records
(``python -m repro_torch.launch.dryrun``) or the JSON list its ``--json``
writes.  The table has one row an (arch, mesh) and one cell a shape:
FLOPs a chip / collective bytes a chip / bottleneck / useful ratio (model
FLOPs over counted), the train cohort beside the mesh.  The comparison lists every record whose FLOPs
a chip differ between the two sets, and the records either set lacks.
"""
from __future__ import annotations

import glob
import json
import os
import sys

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def load(path: str) -> dict:
    if os.path.isdir(path):
        recs = [json.load(open(f)) for f in sorted(glob.glob(os.path.join(path, "*.json")))]
    else:
        recs = json.load(open(path))
    return {(r["arch"], r["shape"], r["mesh"]): r for r in recs}


def cell(r) -> str:
    if r is None:
        return "—"
    if r.get("step") != "counted":
        return "not run"
    bottleneck = {"compute": "cmp", "memory": "mem", "collective": "coll"}
    return (f"{r['flops_per_chip']:.2e} / {r['collectives']['total']:.1e} / "
            f"{bottleneck[r['roofline']['bottleneck']]} / {r['roofline']['useful_ratio']:.3f}")


def table(recs: dict) -> str:
    rows = ["| arch | mesh | cohort | " + " | ".join(SHAPES) + " |",
            "| --- | --- | --- | " + " | ".join("---" for _ in SHAPES) + " |"]
    for arch in sorted({k[0] for k in recs}):
        for mesh in ("16x16", "2x16x16"):
            got = [recs.get((arch, shape, mesh)) for shape in SHAPES]
            cohort = (got[0] or {}).get("cohort", "-")
            rows.append(f"| {arch} | {mesh} | {cohort} | "
                        + " | ".join(cell(r) for r in got) + " |")
    counted = sum(r.get("step") == "counted" for r in recs.values())
    rows.append(f"\n{len(recs)} records, {counted} counted")
    return "\n".join(rows)


def compare(a: dict, b: dict) -> str:
    out = []
    for key in sorted(set(a) | set(b)):
        ra, rb = a.get(key), b.get(key)
        if ra is None or rb is None:
            out.append(f"{key}: only in {'B' if ra is None else 'A'}")
        elif ra.get("flops_per_chip") != rb.get("flops_per_chip"):
            out.append(f"{key}: FLOPs/chip {ra.get('flops_per_chip')} != {rb.get('flops_per_chip')}")
    same = len(set(a) & set(b)) - sum(": FLOPs" in line for line in out)
    return "\n".join(out + [f"{same} record(s) with equal FLOPs a chip; {len(out)} difference(s)"])


if __name__ == "__main__":
    args = sys.argv[1:] or ["experiments/dryrun_torch"]
    print(compare(load(args[0]), load(args[1])) if len(args) == 2 else table(load(args[0])))
