"""Pod dry run (port of ``repro.launch.dryrun``): place every (arch x input
shape x mesh) step on the production meshes and count it.

The reference lowers and compiles each step for 256 / 512 TPU chips and
reads XLA's memory and cost analyses.  Torch has no compiler to ask, so
for each combination this module

  1. builds the production mesh (16 x 16 single pod, 2 x 16 x 16 multi-pod)
     over a fake process group (``mesh.fake_group``: this process is rank
     0, collectives return at once), created here and destroyed after;
  2. builds the parameter tree and the step's inputs as ``meta`` tensors
     (``shape_params``, ``shardings.input_specs``) and their placements
     (``param_pspecs``), and counts the bytes one chip holds of each
     argument from the placements;
  3. places them as DTensors with ``meta`` local shards and runs the train /
     prefill / decode step on them under ``roofline.CostCounter``, with the
     reference's activation pins (``models.shard_hints``), so the FLOPs,
     bytes and collective bytes by kind are rank 0's share of the step;
  4. writes the roofline terms (H100 constants) into
     ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``.

How the step is counted:
- depth: the step runs on the model cut to one and to two repetitions of
  its super-block (full width, full sequence); every count grows linearly
  with the repetitions, so the full model's is c1 + (n_rep - 1)(c2 - c1);
- prefill attention (full causal or sliding window) is counted by its
  closed form, ``analysis.swa_cost`` (kernel 8's work: q.k and p.v over
  the live pairs, q, k, v read and the output written once) in place of
  the blocked loop, whose tens of thousands of small ops a 32k prompt
  would dispatch; training and decode dispatch their attention;
- RWKV6's recurrence is counted on its plain path (kernel 9 launches only
  on the card, and not inside a DTensor step);
- DTensor's propagation carries a row-parallel matmul's partial sums
  (``Partial``) through the residual adds and norms up to the next pin,
  where they are all-reduced: the collective bytes are those of that
  placement;
- a multi-pod step of a config below the FSDP threshold, whose specs name
  "pod" only together with "data" (the batch axes), is placed on the
  mesh's (pod x data, model) = (32, 16) flattening: the same shards, and
  DTensor's redistribution planner, which searches placements over the
  mesh's dims, takes seconds there where the 3-D mesh takes minutes.

Where DTensor cannot run a step, the record keeps the argument half and
says ``"step": "not run"`` with the error: the vmap cohort is not tried
(its per-participant loop indexes a participant axis sharded over the
batch axes, on which DTensor's view propagation did not finish, torch
2.13), and a step that runs past ``STEP_LIMIT_S`` is stopped.  The run
ends non-zero only when a step in ``REQUIRED`` fails (or an argument half
does).

Usage:
  python -m repro_torch.launch.dryrun --arch internlm2-1.8b --both-meshes
  python -m repro_torch.launch.dryrun --required [--json PATH]
  python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod]
"""
from __future__ import annotations

import argparse
import contextlib
import signal
import threading
import dataclasses
import json
import math
import os
import time

import torch

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, adapt_for_shape, get_config
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import (axis_sizes, batch_axes, fake_group,
                                     make_production_mesh, mesh_shape)
from repro_torch.launch.train import default_cohort, make_fl_train_step
from repro_torch.models import attention, shard_hints
from repro_torch.models.transformer import decode_step, prefill, shape_params
from repro_torch.roofline import (CostCounter, active_params, model_flops,
                                  roofline_terms, swa_cost)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

# (arch, shape, cohort) whose step must run; any other records its error
REQUIRED = {("internlm2-1.8b", "train_4k", "stream"),
            ("internlm2-1.8b", "prefill_32k", "-"),
            ("internlm2-1.8b", "decode_32k", "-")}
STEP_LIMIT_S = 600


@contextlib.contextmanager
def _time_limit(seconds: int):
    """Raise TimeoutError in the main thread after ``seconds`` (no limit
    off the main thread)."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def stop(*_):
        raise TimeoutError(f"the step did not finish within {seconds} s")
    old = signal.signal(signal.SIGALRM, stop)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _count_mesh(mesh, multi_pod: bool, fsdp: bool):
    """The mesh a step is placed on (see the module docstring)."""
    if not multi_pod or fsdp:
        return mesh
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", (32, 16), mesh_dim_names=("data", "model"))


def _depth(cfg, reps: int):
    """``cfg`` cut to ``reps`` repetitions of its super-block."""
    prefix, specs, _ = cfg.segment_plan()
    return dataclasses.replace(cfg, n_layers=len(prefix) + reps * len(specs))


@contextlib.contextmanager
def _closed_form_attention(counter: CostCounter):
    """``attention.blocked_attention`` replaced by an output of its shape
    and the closed-form work of the chip's local shard added to
    ``counter`` (forward only: nothing may need its gradient)."""
    real = attention.blocked_attention

    def counted(q, k, v, q_positions, kv_positions, *, window=None, **_):
        lq, lk = q.to_local(), k.to_local()
        b, s, hkv, g, dh = lq.shape
        nbytes, flops = swa_cost(b, s, hkv * g, hkv, dh,
                                 window or lk.shape[1], lq.element_size())
        counter.add(flops, nbytes, "attention (closed form)")
        return torch.empty_like(q[..., :v.shape[-1]])
    attention.blocked_attention = counted
    try:
        yield
    finally:
        attention.blocked_attention = real


def _place(tree, specs, mesh):
    if isinstance(tree, torch.Tensor):
        return sh.distribute({"x": tree}, {"x": specs}, mesh)["x"]
    return sh.distribute(tree, specs, mesh)


def count_step(cfg, shape, mesh, cohort: str, *, fsdp: bool,
               stream_participants: int = 8) -> dict:
    """CostCounter totals of one step of ``cfg`` on ``mesh``, placed as
    DTensors with meta shards (rank 0's share)."""
    from torch.distributed.tensor.experimental import implicit_replication
    params = shape_params(cfg)
    pspecs = sh.param_pspecs(cfg, params, mesh, fsdp=fsdp)
    spec = sh.input_specs(cfg, shape, mesh, cohort=cohort,
                          stream_participants=stream_participants)
    dp = _place(params, pspecs, mesh)
    args = {k: _place(v, spec.arg_specs[k], mesh) for k, v in spec.args.items()}
    baxes = batch_axes(mesh)
    if shape.kind == "train":
        hint_batch = baxes if cohort == "stream" else None
    else:
        n_shards = math.prod(axis_sizes(mesh)[a] for a in baxes)
        hint_batch = baxes if shape.global_batch % n_shards == 0 else None
    counter = CostCounter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(shard_hints.hints(batch_axes=hint_batch,
                                              model_axis="model"))
        stack.enter_context(implicit_replication())
        if shape.kind == "prefill":
            stack.enter_context(_closed_form_attention(counter))
        stack.enter_context(counter)
        if shape.kind == "train":
            step = make_fl_train_step(cfg, cohort=cohort, param_specs=pspecs)
            step(dp, args["batch"], args["fresh"], args["tau"])
        elif shape.kind == "prefill":
            with torch.no_grad():          # DTensors refuse inference mode
                prefill(cfg, dp, args["batch"])
        else:
            with torch.no_grad():
                decode_step(cfg, dp, args["state"], args["tokens"],
                            args["position"])
    return counter.totals()


def lower_one(arch: str, shape_name: str, *, multi_pod: bool = False,
              cohort: str = "auto", save: bool = True, verbose: bool = True,
              overrides: dict | None = None, variant: str = "",
              stream_participants: int = 8, run_step: bool = True) -> dict:
    """Place and count one combination (see the module docstring); returns
    its record.  The fake group of the mesh's size lives inside this
    call."""
    t0 = time.time()
    shape = INPUT_SHAPES[shape_name]
    base_cfg = get_config(arch)
    arch = base_cfg.arch_id
    cfg = adapt_for_shape(base_cfg, shape)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if variant:
        arch = f"{arch}@{variant}"
    dims, _ = mesh_shape(multi_pod)
    mesh_name = "x".join(map(str, dims))
    chips = math.prod(dims)
    params = shape_params(cfg)
    n_total = sum(math.prod(l.shape) for l in sh.leaves(params))
    fsdp = n_total > sh.FSDP_THRESHOLD
    chosen = default_cohort(cfg, params) if cohort == "auto" else cohort
    if shape.kind != "train":
        chosen = "-"
    with fake_group(chips):
        mesh = make_production_mesh(multi_pod=multi_pod)
        pspecs = sh.param_pspecs(cfg, params, mesh, fsdp=fsdp)
        spec = sh.input_specs(cfg, shape, mesh,
                              cohort=chosen if chosen != "-" else "vmap",
                              stream_participants=stream_participants)
        arg_bytes = {"params": sh.shard_bytes(params, pspecs, mesh)}
        for name, tree in spec.args.items():
            arg_bytes[name] = sh.shard_bytes(tree, spec.arg_specs[name], mesh)
        arg_bytes["total"] = sum(arg_bytes.values())
        n_active = active_params(cfg, params)
        tokens = shape.global_batch * (1 if shape.kind == "decode"
                                       else shape.seq_len)
        mf = model_flops(n_active, tokens,
                         "train" if shape.kind == "train" else "infer")
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "chips": chips, "kind": shape.kind, "cohort": chosen,
               "n_params": n_total, "n_active_params": n_active,
               "arg_bytes_per_chip": arg_bytes, "model_flops": mf}
        del params
        if run_step:
            _, _, n_rep = cfg.segment_plan()
            t1 = time.time()
            cmesh = _count_mesh(mesh, multi_pod, fsdp)
            try:
                if chosen == "vmap":
                    raise NotImplementedError(
                        "the vmap cohort is not placed: DTensor's view "
                        "propagation did not finish on its sharded "
                        "participant axis (torch 2.13)")
                with _time_limit(STEP_LIMIT_S):
                    counts = [count_step(_depth(cfg, r), shape, cmesh,
                                         chosen if chosen != "-" else "vmap",
                                         fsdp=fsdp,
                                         stream_participants=stream_participants)
                              for r in ((1, 2) if n_rep > 1 else (1,))]
                c1, c2 = counts[0], counts[-1]
                total = {k: c1[k] + (n_rep - 1) * (c2[k] - c1[k]) for k in c1}
                rep = roofline_terms(
                    arch=arch, shape=shape_name, mesh_name=mesh_name,
                    chips=chips,
                    cost={"flops": total["flops"],
                          "bytes accessed": total["bytes"]},
                    coll_bytes=total["coll_total"], model_flops_val=mf,
                    per_device_hbm=arg_bytes["total"])
                rec.update(
                    step="counted", step_s=time.time() - t1,
                    depth_counted=[1, 2] if n_rep > 1 else [1], n_rep=n_rep,
                    flops_per_chip=total["flops"],
                    bytes_per_chip=total["bytes"],
                    collectives={k[5:]: v for k, v in total.items()
                                 if k.startswith("coll_")},
                    roofline=dataclasses.asdict(rep))
            except Exception as e:  # noqa: BLE001 - recorded, judged below
                rec.update(step="not run", error=repr(e)[:500],
                           step_s=time.time() - t1)
    rec["seconds"] = time.time() - t0
    if save:
        os.makedirs(OUT_DIR, exist_ok=True)
        fn = os.path.join(OUT_DIR, f"{arch}__{shape_name}__{mesh_name}.json")
        with open(fn, "w") as f:
            json.dump(rec, f, indent=1)
    if verbose:
        print(summary_line(rec))
    return rec


def summary_line(rec: dict) -> str:
    head = (f"{rec['arch']:22s} {rec['shape']:12s} mesh={rec['mesh']:8s} "
            f"cohort={rec['cohort']:6s} args/chip="
            f"{rec['arg_bytes_per_chip']['total']:.3e}B")
    if rec.get("step") != "counted":
        return f"[ARGS] {head} step: not run: {rec.get('error', 'skipped')}"
    r = rec["roofline"]
    coll = " ".join(f"{k}={v:.2e}" for k, v in rec["collectives"].items()
                    if k != "total" and v)
    return (f"[OK] {head} flops/chip={rec['flops_per_chip']:.3e} "
            f"bytes/chip={rec['bytes_per_chip']:.3e} coll={coll or 0} "
            f"bottleneck={r['bottleneck']} useful={r['useful_ratio']:.2f} "
            f"({rec['seconds']:.1f}s)")


def required(rec: dict) -> bool:
    return (rec["arch"].split("@")[0], rec["shape"], rec["cohort"]) in REQUIRED


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--cohort", default="auto")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (int/float/bool literal)")
    ap.add_argument("--variant", default="", help="label for override records")
    ap.add_argument("--stream-participants", type=int, default=8)
    ap.add_argument("--required", action="store_true",
                    help="the REQUIRED combinations on both meshes only")
    ap.add_argument("--json", default=None,
                    help="also write every record to this JSON list")
    args = ap.parse_args(argv)
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            overrides[k] = eval(v, {}, {})  # noqa: S307 - CLI literals
        except Exception:  # noqa: BLE001 - a bare string
            overrides[k] = v
    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    combos = [(a, s, mp, args.cohort) for a in archs for s in shapes
              for mp in meshes]
    if args.required:
        combos = [(a, s, mp, c if c != "-" else "auto")
                  for a, s, c in sorted(REQUIRED) for mp in (False, True)]
    failures, not_run, records = [], [], []
    for arch, shape, mp, cohort in combos:
        try:
            rec = lower_one(arch, shape, multi_pod=mp, cohort=cohort,
                            overrides=overrides, variant=args.variant,
                            stream_participants=args.stream_participants)
        except Exception as e:  # noqa: BLE001 - report and go on
            failures.append((arch, shape, mp, repr(e)[:300]))
            print(f"[FAIL] {arch} {shape} multi_pod={mp}: {e!r}"[:500])
            continue
        records.append(rec)
        if rec.get("step") != "counted":
            not_run.append(rec)
            if required(rec):
                failures.append((arch, shape, mp, rec["error"]))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
    print(f"\n{len(not_run)} step(s) not run; {len(failures)} failure(s)")
    if failures:
        raise SystemExit(1)
    print("ALL DRY-RUNS PLACED")


if __name__ == "__main__":
    main()
