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
  the live pairs, q, k, v read and the output written once; MLA's q / k
  and v head dims apart) in place of the blocked loop, whose tens of
  thousands of small ops a 32k prompt would dispatch; training and decode
  dispatch their attention;
- the two recurrences are counted by their closed forms
  (``_closed_form_scan``): Mamba's scan and RWKV6's plain WKV loop by what
  the counter counts for the dispatched loop (``mamba_scan_cost``,
  ``wkv_scan_cost``), kernel 9's route (a decode step's) by the kernel's
  work (``analysis.wkv_cost``), a training step's backward as twice the
  forward;
- the vmap cohort (below ``STREAM_THRESHOLD`` params) is placed as the
  reference's ``vmap`` over a participant axis sharded on the batch axes:
  a chip dispatches its own participants (one on both production meshes),
  each on the model sub-mesh, and the Lam / weights pass over all P with
  its collectives (``launch.train._Placed``);
- heads that do not split over the model axis in whole kv groups are
  pinned whole on each chip (``shard_hints.pin_heads``): an all-gather of
  the projection and the attention of every head on each chip;
- a row-parallel product's partial sums (``Partial``) are all-reduced
  before the residual add (``shard_hints.reduced``), as a tensor-parallel
  layer's all-reduce does;
- a multi-pod step is not dispatched on the 3-D mesh, whose redistribute
  planner took minutes a step, but on a 2-D mesh with the same per-chip
  work (``_count_plan``; the record's ``counted_on``): below the FSDP
  threshold, where the specs name "pod" only together with "data", on the
  (pod x data, model) = (32, 16) flattening, the same shards; above it
  (params sharded on "data" within a pod, replicated across pods) on the
  pod's own (16, 16) mesh with the pod's half of the batch, each pinned
  gradient adding its all-reduce over the pod axis (the one cross-pod
  collective a pod's step has).

Every combination must be counted: a step that fails or runs past
``STEP_LIMIT_S``, a record missing, or a useful ratio out of (0,
``USEFUL_MAX``] (``useful_ok``) fails the run, as the reference's
``[FAIL]`` does.  More than one arch runs one child process an arch,
``min(archs, os.cpu_count())`` at a time.

Usage:
  python -m repro_torch.launch.dryrun --arch all --shape all --both-meshes
  python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape all --both-meshes
  python -m repro_torch.launch.dryrun --smoke [--json PATH]
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
from repro_torch.models import attention, mamba, rwkv6, shard_hints
from repro_torch.models.transformer import decode_step, prefill, shape_params
from repro_torch.roofline import (CostCounter, active_params, model_flops,
                                  roofline_terms, swa_cost, wkv_cost)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

# a short list, both meshes each (``--smoke``; chip_smoke.py's dry-run phase)
SMOKE = (("internlm2-1.8b", "train_4k", "stream"),
         ("internlm2-1.8b", "train_4k", "vmap"),
         ("internlm2-1.8b", "prefill_32k", "auto"),
         ("internlm2-1.8b", "decode_32k", "auto"))
STEP_LIMIT_S = 600
USEFUL_MAX = 1.05


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


def _count_plan(mesh, multi_pod: bool, fsdp: bool, shape):
    """(mesh, shape, pods) a step is dispatched on (see the module
    docstring): the mesh itself for one pod; multi-pod, the (32, 16)
    flattening below the FSDP threshold, else the pod's (16, 16) sub-mesh
    with the pod's share of a batch split over the pods (``pods`` > 1:
    each pinned gradient adds its all-reduce over the pod axis)."""
    if not multi_pod:
        return mesh, shape, 1
    if not fsdp:
        from torch.distributed.device_mesh import init_device_mesh
        sizes = axis_sizes(mesh)
        return (init_device_mesh("cpu", (sizes["pod"] * sizes["data"], sizes["model"]),
                                 mesh_dim_names=("data", "model")), shape, 1)
    pods, n_batch = mesh.size(0), mesh.size(0) * mesh.size(1)
    if shape.global_batch % n_batch == 0:
        shape = dataclasses.replace(shape, global_batch=shape.global_batch // pods)
    return mesh["data", "model"], shape, pods


@contextlib.contextmanager
def _pod_allreduce(counter: CostCounter, pods: int):
    """Each gradient pin of a train step (``launch.train._pin_grads``) adds
    the all-reduce of its pinned gradients over a pod axis of ``pods``:
    the bytes of their local shards, counted as the counter counts an
    all-reduce (its result)."""
    from repro_torch.launch import train
    real = train._pin_grads
    if pods == 1:
        yield
        return

    def pinned(params, grads, param_specs):
        out = real(params, grads, param_specs)
        moved = float(sum(g.to_local().numel() * g.to_local().element_size()
                          for g in out))
        counter.coll["all-reduce"] += moved
        counter.add(0.0, moved, "all_reduce (pod axis)")
        return out
    train._pin_grads = pinned
    try:
        yield
    finally:
        train._pin_grads = real


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
                                 window or lk.shape[1], lq.element_size(),
                                 dv=v.shape[-1])
        counter.add(flops, nbytes, "attention (closed form)")
        return torch.empty_like(q[..., :v.shape[-1]])
    attention.blocked_attention = counted
    try:
        yield
    finally:
        attention.blocked_attention = real


def mamba_scan_cost(b, s, d, n, chunk=None) -> tuple:
    """(flops, bytes) the counter counts for ``models.mamba._scan`` over
    ``s`` steps of a (b, d, n) fp32 state, as dispatched: per chunk of L
    steps the decays ``exp(dt A)`` (a mul and an exp), the inputs
    ``dt B x`` (two muls), one ``addcmul`` a step, the stacked states, and
    the outputs ``(h C).sum(-1)``; the chunks' outputs concatenated once.
    That is 15 (b d n) + 4 (b d) + 2 (b n) fp32 elements a step, d n a
    chunk (A, read by each chunk's decay) and 2 b s d for the concat.  The
    ops are all elementwise or reductions, for which the counter counts no
    FLOPs."""
    chunk = chunk or mamba.SCAN_CHUNK
    n_chunks = -(-s // chunk)
    return 0.0, float(4 * (s * (15 * b * d * n + 4 * b * d + 2 * b * n)
                           + n_chunks * d * n) + 8 * b * s * d)


def wkv_scan_cost(b, s, h, n, elem_in, elem_v, elem_u=4, with_s0=False,
                  elem_s0=4) -> tuple:
    """(flops, bytes) the counter counts for ``models.rwkv6.wkv6_scan`` over
    ``s`` steps, as dispatched: r, k, v cast to fp32 (``elem_in`` bytes an
    element; w is fp32), u and the start state likewise, zeros for a
    missing start state; a step's k v^T, u (k v^T), S + u k v^T, the r
    read (a copy when b > 1, its slice not being contiguous), the
    r . (S + u k v^T) product (2 N^2 FLOPs a (batch, head)), w S and
    w S + k v^T: 12 (b h n^2) + 5 (b h n) (+ 2 for the copy) + h n fp32
    elements a step; then the outputs stacked and cast to v's dtype."""
    seq, st = b * s * h * n, b * h * n * n
    cast = lambda e, m: (e + 4) * m if e != 4 else 0
    per_step = 4 * (12 * b * h * n * n + (7 if b > 1 else 5) * b * h * n + h * n)
    nbytes = (3 * cast(elem_in, seq) + cast(elem_u, h * n)
              + (cast(elem_s0, st) if with_s0 else 4 * st)
              + s * per_step + 8 * seq + cast(elem_v, seq))
    return float(2 * st * s), float(nbytes)


class _Counted(torch.autograd.Function):
    """A scan's stand-in: the forward adds ``cost`` to ``counter`` and
    returns outputs of the scan's shapes, dtypes and placements
    (``outs()``); the backward adds twice ``cost`` (the backward of a
    linear-time scan reads what its forward read and wrote and writes a
    gradient of each: twice the traffic, and for a product's FLOPs its two
    gradient products) and returns gradients of the inputs' shapes."""

    @staticmethod
    def forward(ctx, counter, cost, name, outs, *inputs):
        counter.add(*cost, name)
        ctx.counter, ctx.cost, ctx.name = counter, cost, name
        ctx.likes = [t if isinstance(t, torch.Tensor) else None for t in inputs]
        return outs()

    @staticmethod
    def backward(ctx, *_):
        ctx.counter.add(2 * ctx.cost[0], 2 * ctx.cost[1], ctx.name + " backward")
        return (None,) * 4 + tuple(None if t is None else torch.empty_like(t)
                                   for t in ctx.likes)


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


@contextlib.contextmanager
def _closed_form_scan(counter: CostCounter):
    """The two recurrences counted by their closed forms in place of a
    time loop a 32k prompt would dispatch step by step: ``mamba._scan`` by
    ``mamba_scan_cost``, ``rwkv6.wkv6_scan`` by ``wkv_scan_cost`` (both
    what the counter counts for the dispatched loop), and kernel 9's
    route (``kernels.wkv6.ops.wkv6``, which a decode step launches on the
    card) by ``wkv_cost``, the kernel's own work; each on the chip's local
    shards, its inputs' partial sums reduced first, its backward (training)
    as ``_Counted`` counts it."""
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    real = mamba._scan, rwkv6.wkv6_scan, wkv_ops.wkv6

    def scan(x, dt, Bm, Cm, A, h):
        x, dt, Bm, Cm, A, h = map(shard_hints.reduced, (x, dt, Bm, Cm, A, h))
        b, s, d = _local(x).shape
        cost = mamba_scan_cost(b, s, d, _local(Bm).shape[-1])
        return _Counted.apply(
            counter, cost, "mamba scan (closed form)",
            lambda: (torch.empty_like(x), torch.empty_like(h)),
            x, dt, Bm, Cm, A, h)

    def wkv(kind):
        def run(r, k, v, w, u, state0=None):
            r, k, v, w, u = map(shard_hints.reduced, (r, k, v, w, u))
            lr = _local(r)
            b, s, h, n = lr.shape
            if kind == "kernel":
                cost = wkv_cost(b, s, h, n, lr.element_size(),
                                state0 is not None)[::-1]
            else:
                cost = wkv_scan_cost(
                    b, s, h, n, lr.element_size(), _local(v).element_size(),
                    _local(u).element_size(), state0 is not None,
                    _local(state0).element_size() if state0 is not None else 4)
            s_like = (state0 if state0 is not None else
                      r[:, 0, :, :, None].expand(r.shape[0], r.shape[2], n, n))
            return _Counted.apply(
                counter, cost, f"wkv6 {kind} (closed form)",
                lambda: (torch.empty_like(v),
                         torch.empty_like(s_like, dtype=torch.float32)),
                r, k, v, w, u, state0)
        return run

    mamba._scan, rwkv6.wkv6_scan, wkv_ops.wkv6 = scan, wkv("scan"), wkv("kernel")
    try:
        yield
    finally:
        mamba._scan, rwkv6.wkv6_scan, wkv_ops.wkv6 = real


def _place(tree, specs, mesh):
    if isinstance(tree, torch.Tensor):
        return sh.distribute({"x": tree}, {"x": specs}, mesh)["x"]
    return sh.distribute(tree, specs, mesh)


def count_step(cfg, shape, mesh, cohort: str, *, fsdp: bool,
               stream_participants: int = 8, pods: int = 1) -> dict:
    """CostCounter totals of one step of ``cfg`` on ``mesh``, placed as
    DTensors with meta shards (rank 0's share); ``pods`` > 1 adds the
    gradients' all-reduce over a pod axis (``_pod_allreduce``)."""
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
        stack.enter_context(_closed_form_scan(counter))
        stack.enter_context(_pod_allreduce(counter, pods))
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
            cmesh, cshape, pods = _count_plan(mesh, multi_pod, fsdp, shape)
            rec["counted_on"] = ("x".join(map(str, cmesh.shape))
                                 + (f" (a pod, batch {cshape.global_batch}, "
                                    f"+ the pod-axis all-reduce)" if pods > 1 else ""))
            try:
                with _time_limit(STEP_LIMIT_S):
                    counts = [count_step(_depth(cfg, r), cshape, cmesh,
                                         chosen if chosen != "-" else "vmap",
                                         fsdp=fsdp, pods=pods,
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
            except Exception as e:  # noqa: BLE001 - recorded, fails the run
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
            f"cohort={rec['cohort']:6s} counted on {rec.get('counted_on', '-')}; "
            f"args/chip={rec['arg_bytes_per_chip']['total']:.3e}B")
    if rec.get("step") != "counted":
        return f"[FAIL] {head} step: not run: {rec.get('error', 'skipped')}"
    r = rec["roofline"]
    coll = " ".join(f"{k}={v:.2e}" for k, v in rec["collectives"].items()
                    if k != "total" and v)
    return (f"[OK] {head} flops/chip={rec['flops_per_chip']:.3e} "
            f"bytes/chip={rec['bytes_per_chip']:.3e} coll={coll or 0} "
            f"bottleneck={r['bottleneck']} useful={r['useful_ratio']:.2f} "
            f"({rec['seconds']:.1f}s)")


RECURRENT = frozenset({"rwkv6", "mamba"})


def useful_ok(rec: dict, cfg) -> bool:
    """Whether a counted record's useful ratio (model FLOPs 2 N T or 6 N T
    over the counted FLOPs) is in (0, ``USEFUL_MAX``]: a count under the
    model's own FLOPs has left work out.  One named exception: a decode
    step of an architecture of recurrent blocks only (``cfg`` the record's
    config) multiplies no embedding row, which 2 N T counts, and reads no
    attention cache that would make up for them, so there the model FLOPs
    are taken less the embedding's 2 V d T (rwkv6-1.6b's ``decode_32k``
    reads 1.07 against 2 N T, 0.99 against 2 (N - V d) T)."""
    r = rec["roofline"]["useful_ratio"]
    if rec["kind"] == "decode" and set(cfg.block_pattern) <= RECURRENT:
        r *= 1.0 - cfg.vocab_size * cfg.d_model / rec["n_active_params"]
    return 0 < r <= USEFUL_MAX


def _child_argv(args) -> list:
    """The arguments of ``args`` but ``--arch`` and ``--json``, for a child."""
    out = ["--shape", args.shape, "--cohort", args.cohort,
           "--stream-participants", str(args.stream_participants),
           "--variant", args.variant]
    for kv in args.set:
        out += ["--set", kv]
    if args.both_meshes:
        out.append("--both-meshes")
    elif args.multi_pod:
        out.append("--multi-pod")
    return out


def _run_child(arch: str, argv: list) -> tuple:
    """``python -m repro_torch.launch.dryrun --arch arch *argv`` in a child
    process, its ``[OK]`` / ``[FAIL]`` lines printed: (its exit code, its
    records, the tail of its standard error)."""
    import subprocess
    import sys
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "records.json")
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
             "--json", out, *argv], capture_output=True, text=True)
        print("".join(line for line in proc.stdout.splitlines(True)
                      if line.startswith("[")), end="", flush=True)
        recs = json.load(open(out)) if os.path.exists(out) else []
    return proc.returncode, recs, proc.stderr[-2000:]


def _run_archs(archs: list, argv: list) -> tuple:
    """One child process an arch, ``min(len(archs), os.cpu_count())`` at a
    time: their records, and (arch, stderr tail) of each child that exited
    with another code than 0."""
    from concurrent.futures import ThreadPoolExecutor
    records, broken = [], []
    with ThreadPoolExecutor(min(len(archs), os.cpu_count() or 1)) as pool:
        for arch, (rc, recs, err) in zip(
                archs, pool.map(lambda a: _run_child(a, argv), archs)):
            records += recs
            if rc != 0:
                broken.append((arch, err))
    return records, broken


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="an arch, or all (one child process an arch)")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--cohort", default="auto")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (int/float/bool literal)")
    ap.add_argument("--variant", default="", help="label for override records")
    ap.add_argument("--stream-participants", type=int, default=8)
    ap.add_argument("--smoke", action="store_true",
                    help="the SMOKE combinations on both meshes only")
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
    if args.smoke:
        combos = [(a, s, mp, c) for a, s, c in SMOKE for mp in (False, True)]
    failures, records = [], []
    if len(archs) > 1 and not args.smoke:
        records, broken = _run_archs(archs, _child_argv(args))
        failures += [(a, "-", "-", err) for a, err in broken]
    else:
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
    counted = [r for r in records if r.get("step") == "counted"]
    failures += [(r["arch"], r["shape"], r["mesh"], r.get("error"))
                 for r in records if r.get("step") != "counted"]
    for r in counted:
        cfg = dataclasses.replace(get_config(r["arch"].split("@")[0]), **overrides)
        if not useful_ok(r, cfg):
            failures.append((r["arch"], r["shape"], r["mesh"], "useful ratio "
                             f"{r['roofline']['useful_ratio']} out of (0, {USEFUL_MAX}]"))
            print(f"[FAIL] {r['arch']} {r['shape']} mesh={r['mesh']}: "
                  f"{failures[-1][-1]}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
    print(f"\n{len(counted)} step(s) counted, {len(combos) - len(counted)} step(s) "
          f"not run; {len(failures)} failure(s)")
    if failures or len(counted) != len(combos):
        raise SystemExit(1)
    print("ALL DRY-RUNS PLACED")


if __name__ == "__main__":
    main()
