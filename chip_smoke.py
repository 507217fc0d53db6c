#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

From the repository root, with nothing built beforehand.  It
  1. prints the card's name and power limit;
  2. builds every CUDA kernel from the sources in ``src/repro_torch``;
  3. holds each kernel of the SAA family against its plain PyTorch version
     on the card (the round pipeline's shapes, a large shape, every scaling
     rule, padding, no-stale, no-fresh and all-invalid cells; the params
     update in place), and holds the apply kernels bit for bit to the
     aggregate kernels followed by torch's ``params + lr * agg``; after
     step 4 it does the same at every participant count n the paths ran
     a kernel at;
  4. drives the port's paths at the quickstart's full scale, each with the
     launch counters zeroed just before it and read just after: the fused
     pipeline's Random and RELAY campaigns (``sweep_fused_staleness_apply``)
     and RELAY+YoGi (``sweep_fused_staleness_aggregate``), the per-stage
     flat path's Random, RELAY and RELAY+YoGi (``fused_staleness_aggregate``),
     and the host entry points' A/B path over the flat RELAY campaign's
     rounds (``fused_staleness_apply``, ``deviation_partials``,
     ``weighted_aggregate``).  Every kernel must launch exactly once per
     round that aggregated; then each campaign is timed warm (rounds/s) and
     profiled (device busy share, host spans, top GPU kernels);
  5. checks the result: finite parameters of the model's width; each flat
     campaign equal to its fused twin bit for bit (records and params);
     host records equal to a CPU run of every campaign; small RELAY,
     RELAY+YoGi and RELAY flat runs on the GPU close to the same runs on
     the CPU;
  6. times each kernel, its plain version and (where one exists) the one
     PyTorch call that computes the same function, and prints their bounds.
It exits non-zero, printing no result, on any failure or without a GPU.
The next-to-last line is the per-kernel JSON summary, the last line
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""
import dataclasses
import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke.json"

# H100 SXM data-sheet peaks (dense): HBM3 bandwidth and fp32 CUDA-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# kernel vs plain version tolerances (fp32; the two sum in other orders),
# as the JAX package's own kernel tests hold its Pallas kernels
W_RTOL, W_ATOL = 1e-5, 1e-6
P_RTOL, P_ATOL = 1e-4, 1e-5
MAIN_D = 14336        # mlp on speech: D = 12835 padded to the 2048-column block
LARGE = (1, 64, 1 << 20)

SOURCE = "src/repro_torch/kernels/staleness_agg/csrc/staleness_agg.cu"
PALLAS = "src/repro/kernels/staleness_agg/staleness_agg.py"
# kernel -> the line of its TPU def
REPLACES = {
    "sweep_fused_staleness_apply": f"{PALLAS}:267",
    "sweep_fused_staleness_aggregate": f"{PALLAS}:318",
    "fused_staleness_aggregate": f"{PALLAS}:364",
    "fused_staleness_apply": f"{PALLAS}:410",
    "deviation_partials": f"{PALLAS}:460",
    "weighted_aggregate": f"{PALLAS}:490",
}
APPLY, AGG, CELL_AGG, CELL_APPLY, PARTIALS, WAGG = REPLACES


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip()


def saa_inputs(torch, s, n, d, case, gen):
    """Operands of the SAA kernels for one check; ``case`` picks the masks."""
    dev = "cuda"
    u = torch.randn((s, n, d), generator=gen, device=dev)
    params = torch.randn((s, d), generator=gen, device=dev)
    fresh = torch.zeros((s, n), dtype=torch.bool, device=dev)
    valid = torch.ones((s, n), dtype=torch.bool, device=dev)
    nf = max(1, n // 2)
    if case in ("mixed", "padding", "all_invalid"):
        fresh[:, :nf] = True
    elif case == "no_stale":
        fresh[:] = True
    if case == "padding" and n > 2:
        valid[:, -(n // 4 or 1):] = False
        u[~valid] = 0.0          # the pipeline's padding rows are exact zeros
    if case == "all_invalid":
        valid[-1] = False
    tau = torch.randint(1, 6, (s, n), generator=gen, device=dev,
                        dtype=torch.int32)
    tau[fresh] = 0
    beta = torch.rand((s,), generator=gen, device=dev) * 0.5
    lr = 0.5 + torch.rand((s,), generator=gen, device=dev)
    scal = torch.stack([beta, lr], dim=1).contiguous()
    return params, u, fresh, tau, valid, scal


class Checks:
    """Per-kernel count of checks, largest absolute error, and largest
    error relative to the largest magnitude of the plain result."""

    def __init__(self, torch):
        self.torch = torch
        self.n = Counter()
        self.err = Counter()
        self.rel = Counter()

    def close(self, kernel, got, want, what, weights=False):
        torch = self.torch
        rtol, atol = (W_RTOL, W_ATOL) if weights else (P_RTOL, P_ATOL)
        if not torch.isfinite(got).all():
            fail(f"{kernel}: non-finite output at {what}")
        err = (got - want).abs().max().item() if got.numel() else 0.0
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            fail(f"{kernel}: differs from its plain version at {what}: {err}")
        self.err[kernel] = max(self.err[kernel], err)
        scale = want.abs().max().item() if want.numel() else 0.0
        if scale > 0:
            self.rel[kernel] = max(self.rel[kernel], err / scale)

    def count(self, *kernels):
        for k in kernels:
            self.n[k] += 1


def check_family(torch, ops, ref, checks, s, n, d, rule, case, gen,
                 rule_free: bool):
    """Every kernel of the family on one set of operands against its plain
    version; ``rule_free`` also runs the two kernels that take no rule."""
    params, u, fresh, tau, valid, scal = saa_inputs(torch, s, n, d, case, gen)
    beta, lr = scal[:, 0].contiguous(), scal[:, 1].contiguous()
    what = f"S={s} n={n} D={d} rule={rule} case={case}"
    # 1. the sweep server step, in place
    p_k = params.clone()
    ptr = p_k.data_ptr()
    out, w_k = ops.sweep_fused_staleness_apply(p_k, u, fresh, tau, valid, scal,
                                               rule=rule)
    p_r = params.clone()
    _, w_r = ref.sweep_fused_staleness_apply(p_r, u, fresh, tau, valid, scal,
                                             rule=rule)
    torch.cuda.synchronize()
    if out.data_ptr() != ptr or p_k.data_ptr() != ptr:
        fail(f"SAA kernel did not update params in place ({what})")
    checks.close(APPLY, w_k, w_r, what, weights=True)
    checks.close(APPLY, p_k, p_r, what)
    if case == "all_invalid" and not torch.equal(p_k[-1], params[-1]):
        fail(f"an all-invalid cell changed its params at {what}")
    # 2. the sweep aggregate; kernel 1 is it, applied with torch's rounding
    agg, w2 = ops.sweep_fused_staleness_aggregate(u, fresh, tau, beta, valid,
                                                  rule=rule)
    agg_r, w2_r = ref.sweep_fused_staleness_aggregate(u, fresh, tau, beta,
                                                      valid, rule=rule)
    torch.cuda.synchronize()
    checks.close(AGG, w2, w2_r, what, weights=True)
    checks.close(AGG, agg, agg_r, what)
    if case == "all_invalid" and (w2[-1].any() or agg[-1].any()):
        fail(f"an all-invalid cell got weight at {what}")
    if not (torch.equal(w_k, w2) and torch.equal(p_k, params + lr[:, None] * agg)):
        fail(f"apply kernel != params + lr * aggregate kernel, bitwise, at {what}")
    # 3 and 4: one cell (the last, which is all-invalid in that case)
    c = s - 1
    b, l = float(beta[c]), float(lr[c])
    a3, w3 = ops.fused_staleness_aggregate(u[c], fresh[c], tau[c], b, rule=rule,
                                           valid=valid[c])
    a3_r, w3_r = ref.fused_staleness_aggregate(u[c], fresh[c], tau[c],
                                               beta[c:c + 1], valid[c],
                                               rule=rule)
    p4 = params[c].clone()
    _, w4 = ops.fused_staleness_apply(p4, u[c], fresh[c], tau[c], b, l,
                                      rule=rule, valid=valid[c])
    p4_r = params[c].clone()
    ref.fused_staleness_apply(p4_r, u[c], fresh[c], tau[c], valid[c],
                              scal[c:c + 1], rule=rule)
    torch.cuda.synchronize()
    checks.close(CELL_AGG, w3, w3_r, what, weights=True)
    checks.close(CELL_AGG, a3, a3_r, what)
    checks.close(CELL_APPLY, w4, w3_r, what, weights=True)
    checks.close(CELL_APPLY, p4, p4_r, what)
    if not (torch.equal(a3, agg[c]) and torch.equal(w3, w2[c])):
        fail(f"one-cell aggregate != sweep aggregate's cell, bitwise, at {what}")
    if not (torch.equal(w4, w3) and torch.equal(p4, params[c] + l * a3)):
        fail(f"one-cell apply != params + lr * aggregate, bitwise, at {what}")
    checks.count(APPLY, AGG, CELL_AGG, CELL_APPLY)
    if not rule_free:
        return
    # 5 and 6: no scaling rule; the partials and a GEMV on given weights
    num, den = ops.deviation_partials(u[0], fresh[0])
    num_r, den_r = ref.deviation_partials(u[0], fresh[0])
    o6 = ops.weighted_aggregate(w2_r[0], u[0])
    o6_r = ref.weighted_aggregate(w2_r[0], u[0])
    torch.cuda.synchronize()
    checks.close(PARTIALS, num, num_r, what)
    checks.close(PARTIALS, den, den_r, what)
    checks.close(WAGG, o6, o6_r, what)
    checks.count(PARTIALS, WAGG)


def time_ms(torch, fn, iters, warmup=5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(torch, fn, replays=20) -> float:
    """Device time of one call of ``fn``: the call captured once in a CUDA
    graph, the graph replayed ``replays`` times between CUDA events — the
    card's time for all of the call's kernels, without the host's Python
    and launch time."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()                                 # warm up outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(torch, graph.replay, replays, warmup=2)


def saa_cost(kernel, s, n, d, n_fresh):
    """(bytes, flops) a kernel's function needs: each input read once, each
    output written once; flops of the deviation pass (mixed, difference,
    square, sum: 6 per element), the fresh mean (n_f adds and a divide per
    column), the denominator (2 per column), the aggregate (2 per element)
    and the apply (2 per column)."""
    u_bytes = s * n * d * 4
    masks = s * n * (1 + 1 + 4)             # fresh, valid, tau
    partials = s * d * (6 * n + n_fresh + 1 + 2)
    if kernel in (APPLY, CELL_APPLY):
        return (2 * s * d * 4 + u_bytes + masks + s * 2 * 4 + s * n * 4,
                partials + s * d * (2 * n + 2))
    if kernel in (AGG, CELL_AGG):
        return (u_bytes + masks + s * 4 + s * d * 4 + s * n * 4,
                partials + s * d * 2 * n)
    if kernel == PARTIALS:
        return u_bytes + s * n * (1 + 4) + s * 4, partials
    return n * 4 + u_bytes + d * 4, 2 * n * d          # WAGG


def kernel_calls(torch, ops, ref, kernel, s, n, d, gen):
    """(kernel call, plain call, library call or None, n_fresh) on one set
    of 'mixed' operands at (S, n, D); the single-cell kernels use cell 0."""
    params, u, fresh, tau, valid, scal = saa_inputs(torch, s, n, d, "mixed", gen)
    beta = scal[:, 0].contiguous()
    nf = int(fresh[0].sum())
    p_k, p_r = params.clone(), params.clone()
    b, l = float(beta[0]), float(scal[0, 1])
    w = ref.sweep_fused_staleness_aggregate(u, fresh, tau, beta, valid)[1][0]
    calls = {
        APPLY: (lambda: ops.sweep_fused_staleness_apply(p_k, u, fresh, tau, valid, scal),
                lambda: ref.sweep_fused_staleness_apply(p_r, u, fresh, tau, valid, scal),
                None),
        AGG: (lambda: ops.sweep_fused_staleness_aggregate(u, fresh, tau, beta, valid),
              lambda: ref.sweep_fused_staleness_aggregate(u, fresh, tau, beta, valid),
              None),
        CELL_AGG: (lambda: ops.fused_staleness_aggregate(u[0], fresh[0], tau[0], b,
                                                         valid=valid[0]),
                   lambda: ref.fused_staleness_aggregate(u[0], fresh[0], tau[0],
                                                         beta[:1], valid[0]),
                   None),
        CELL_APPLY: (lambda: ops.fused_staleness_apply(p_k[0], u[0], fresh[0], tau[0],
                                                       b, l, valid=valid[0]),
                     lambda: ref.fused_staleness_apply(p_r[0], u[0], fresh[0], tau[0],
                                                       valid[0], scal[:1]),
                     None),
        PARTIALS: (lambda: ops.deviation_partials(u[0], fresh[0]),
                   lambda: ref.deviation_partials(u[0], fresh[0]), None),
        WAGG: (lambda: ops.weighted_aggregate(w, u[0]),
               lambda: ref.weighted_aggregate(w, u[0]),
               lambda: torch.mv(u[0].t(), w)),
    }
    return (*calls[kernel], nf)


def time_kernel(torch, ops, ref, kernel, s, n, d, iters, gen) -> dict:
    """Events (plain, kernel, kernel, plain: the card's clocks drift over a
    call) and CUDA-graph device times of a kernel, its plain version and
    its library call, beside its bound from these inputs."""
    k, p, lib, nf = kernel_calls(torch, ops, ref, kernel, s, n, d, gen)
    single = kernel not in (APPLY, AGG)
    shape = {"n": n, "D": d} if single else {"S": s, "n": n, "D": d}
    pr1, k1 = time_ms(torch, p, iters), time_ms(torch, k, iters)
    k2, pr2 = time_ms(torch, k, iters), time_ms(torch, p, iters)
    nbytes, flops = saa_cost(kernel, 1 if single else s, n, d, nf)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    res = {"shape": shape, "ms": min(k1, k2), "ms_runs": [k1, k2],
           "plain_ms": min(pr1, pr2), "plain_ms_runs": [pr1, pr2],
           "device_ms": graph_ms(torch, k), "plain_device_ms": graph_ms(torch, p),
           "bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None, "library_device_ms": None}
    if lib is not None:
        res["library_ms"] = min(time_ms(torch, lib, iters), time_ms(torch, lib, iters))
        res["library_device_ms"] = graph_ms(torch, lib)
    return res


def profile_campaign(torch, run) -> dict:
    """Device busy share, host span times and the top GPU kernels of one
    warm campaign, from a ``torch.profiler`` trace.  Busy time is the sum
    of GPU kernel and copy times over the wall time of the synchronized
    run; the pipeline's ``round.*`` spans are host ranges (their device-
    side mirrors are not work and are left out)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name, n_kernels = Counter(), Counter(), 0
    for e in prof.events():
        if e.name.startswith("round."):
            if e.device_type.name == "CPU":
                spans[e.name] += e.cpu_time_total / 1e3
        elif e.device_type.name == "CUDA":
            by_name[e.name] += e.device_time_total / 1e3
            n_kernels += 1
    busy_ms = sum(by_name.values())
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if n_kernels else None,
            "gpu_kernels": n_kernels, "host_spans_ms": dict(spans),
            "top_kernels_ms": dict(by_name.most_common(8))}


def record_bits(rec):
    """A RoundRecord as comparable values (NaN accuracy on non-eval rounds
    compares equal to itself)."""
    return tuple(repr(v) for v in dataclasses.astuple(rec))


def host(r):
    return (r.round_idx, r.sim_time, r.n_selected, r.n_fresh, r.n_stale,
            r.resource_used, r.resource_wasted, r.unique_participants)


def aggregated(acct) -> int:
    return sum(1 for r in acct.records if r.n_fresh + r.n_stale > 0)


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("src/repro_torch is missing beside chip_smoke.py")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import LAUNCHES, _build
    from repro_torch.kernels.staleness_agg import ops as saa_ops
    from repro_torch.kernels.staleness_agg import ref as saa_ref
    from repro_torch.quickstart import CAMPAIGNS, COMMON, table
    from repro_torch.sim import SimConfig, Simulator
    from repro_torch.sim.learner import fp32_matmuls

    fp32_matmuls()        # the plain versions' matmuls in full fp32 too
    report = {"card": card_line(), "kind": torch.cuda.get_device_name(0)}
    print(f"card: {report['card']}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # --- 1. build every kernel (one nvcc per source, in parallel) --------
    t0 = time.perf_counter()
    _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    print(f"built {sorted(_build.SOURCES)} in {report['build_s']:.1f}s")
    for name in _build.SOURCES:
        for line in _build.log_path(name).read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # --- 2. each kernel against its plain version -----------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    rules = ("equal", "dynsgd", "adasgd", "relay")
    cases = ("mixed", "padding", "no_stale", "no_fresh", "all_invalid")
    checks = Checks(torch)

    def check_grid(shapes):
        for s, n, d in shapes:
            for rule in rules:
                for case in cases:
                    check_family(torch, saa_ops, saa_ref, checks, s, n, d,
                                 rule, case, gen, rule_free=rule == rules[0])
    grid = [(1, n, MAIN_D) for n in (1, 2, 10, 16)] + [(3, 10, MAIN_D), LARGE]
    check_grid(grid)
    for k in REPLACES:
        print(f"{k} == plain version in {checks.n[k]} checks "
              f"(max abs err {checks.err[k]:.3g}, relative {checks.rel[k]:.3g})")
    print("apply kernels == aggregate kernels + torch's params + lr * agg, "
          "bitwise, in every check")

    # --- 3. the paths, launch counters zeroed just before each ----------
    yogi = dict(CAMPAIGNS["RELAY"], server_opt="yogi")
    runs = {                       # campaign -> (config, the kernel it runs)
        "Random": (CAMPAIGNS["Random"], APPLY),
        "RELAY": (CAMPAIGNS["RELAY"], APPLY),
        "RELAY+YoGi": (yogi, AGG),
        "Random flat": (dict(CAMPAIGNS["Random"], fused_rounds=False), CELL_AGG),
        "RELAY flat": (dict(CAMPAIGNS["RELAY"], fused_rounds=False), CELL_AGG),
        "RELAY+YoGi flat": (dict(yogi, fused_rounds=False), CELL_AGG),
    }
    gpu, sims, launches = {}, {}, Counter()
    report["paths"] = {}
    for name, (kw, kernel) in runs.items():
        sims[name] = Simulator(SimConfig(**COMMON, **kw), device="cuda")
        LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gpu[name] = sims[name].run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got, n_agg = dict(LAUNCHES), aggregated(gpu[name])
        if n_agg == 0 or got != {kernel: n_agg}:
            fail(f"{name}: launches {got}, expected {{{kernel!r}: {n_agg}}} "
                 "(one per round that aggregated)")
        launches.update(got)
        report["paths"][name] = {"launches": got, "aggregated_rounds": n_agg,
                                 "first_run_s": wall}
        print(f"{name}: {got} over {n_agg} aggregating rounds, {wall:.2f}s "
              "first run")
    print(table(gpu))

    # the host entry points' A/B path over the flat RELAY campaign's rounds
    cfg = SimConfig(**COMMON, **runs["RELAY flat"][0])
    rec_sim = Simulator(cfg, device="cuda")
    rounds, step = [], rec_sim._aggregate

    def recording(fresh, stale, taus):
        agg = step(fresh, stale, taus)
        rounds.append((torch.stack(fresh + stale), len(fresh), list(taus),
                       rec_sim.flat_params, agg))
        return agg
    rec_sim._aggregate = recording
    rec_sim.run()
    LAUNCHES.clear()
    ab_err = 0.0
    for u, nf, taus, p_before, agg in rounds:
        fresh = torch.arange(u.shape[0], device="cuda") < nf
        tau = torch.tensor([0] * nf + taus, dtype=torch.int32, device="cuda")
        agg_ab, _ = saa_ops.staleness_aggregate(
            u, fresh, tau, rule=cfg.scaling_rule, beta=cfg.beta, fused=False)
        p_new, _ = saa_ops.staleness_apply(
            p_before, u, fresh, tau, rule=cfg.scaling_rule, beta=cfg.beta,
            server_lr=cfg.server_lr)
        torch.cuda.synchronize()
        if not torch.allclose(agg_ab, agg, rtol=P_RTOL, atol=P_ATOL):
            fail("A/B path: two-launch aggregate differs from the flat path's")
        if not torch.equal(p_new, p_before + cfg.server_lr * agg):
            fail("A/B path: staleness_apply != params + lr * the flat path's "
                 "aggregate, bitwise")
        ab_err = max(ab_err, (agg_ab - agg).abs().max().item())
    got = dict(LAUNCHES)
    if not rounds or got != {k: len(rounds) for k in (CELL_APPLY, PARTIALS, WAGG)}:
        fail(f"A/B path: launches {got} over {len(rounds)} rounds")
    launches.update(got)
    report["paths"]["A/B host entries"] = {"launches": got,
                                           "aggregated_rounds": len(rounds),
                                           "max_abs_err_vs_flat": ab_err}
    print(f"A/B host entries over {len(rounds)} RELAY flat rounds: {got}; "
          f"aggregate max abs diff from the flat path {ab_err:.3g}; the "
          f"one-cell apply equals the flat step bitwise")

    # each kernel against its plain version at every n the paths ran it at
    ns = {}                          # kernel -> the n it ran at, counted
    for name, (_, kernel) in runs.items():
        ns.setdefault(kernel, Counter()).update(
            r.n_fresh + r.n_stale for r in gpu[name].records
            if r.n_fresh + r.n_stale > 0)
    for kernel in (CELL_APPLY, PARTIALS, WAGG):
        ns[kernel] = Counter(u.shape[0] for u, *_ in rounds)
    path_ns = sorted(set().union(*ns.values()) - {n for _, n, _ in grid})
    before = sum(checks.n.values())
    check_grid([(1, n, MAIN_D) for n in path_ns])
    print(f"kernels == plain versions at the paths' other n {path_ns}: "
          f"{sum(checks.n.values()) - before} more checks; max abs err "
          + ", ".join(f"{k} {checks.err[k]:.3g}" for k in REPLACES))

    # per-campaign rounds/s: a second, warm run of each, then a profile
    report["campaigns"] = {}
    for name, (kw, _) in runs.items():
        sim = Simulator(SimConfig(**COMMON, **kw), device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acct = sim.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        summ = acct.summary()
        report["campaigns"][name] = {
            "rounds": len(acct.records), "seconds": secs,
            "rounds_per_s": len(acct.records) / secs,
            "final_accuracy": summ["final_accuracy"],
            "resource_used": summ["resource_used"],
            "waste_fraction": summ["waste_fraction"]}
        print(f"{name}: {len(acct.records)} rounds in {secs:.3f}s = "
              f"{len(acct.records) / secs:.1f} rounds/s")
        prof = profile_campaign(torch, Simulator(SimConfig(**COMMON, **kw),
                                                 device="cuda").run)
        report["campaigns"][name]["profile"] = prof
        idle = prof["device_idle_share"]
        print(f"{name} profile: {prof['gpu_kernels']} GPU kernels, device busy "
              f"{prof['device_busy_ms']:.1f} of {prof['wall_ms']:.1f} ms "
              f"(idle share {'not measured' if idle is None else f'{idle:.3f}'})")
        print("  host spans (CPU ms): " + ", ".join(
            f"{k} {v:.1f}" for k, v in sorted(prof["host_spans_ms"].items())))
        for kname, ms in prof["top_kernels_ms"].items():
            print(f"  {ms:9.3f} ms  {kname[:90]}")

    # --- 4. the result is right ----------------------------------------
    d_model = sims["Random"].flat_params.numel()
    for name, a in gpu.items():
        if not a.records:
            fail(f"{name}: no rounds recorded")
        evals = [r for r in a.records if r.accuracy == r.accuracy]
        if not evals or not all(0.0 <= r.accuracy <= 1.0 and r.loss == r.loss
                                for r in evals):
            fail(f"{name}: missing or invalid evaluations")
        p = sims[name].flat_params
        if p.shape != (d_model,) or not torch.isfinite(p).all():
            fail(f"{name}: parameters not finite or of the wrong width")
    for fused in ("Random", "RELAY", "RELAY+YoGi"):
        flat = f"{fused} flat"
        if [record_bits(r) for r in gpu[fused].records] != \
                [record_bits(r) for r in gpu[flat].records]:
            fail(f"{flat}: records differ from the fused pipeline's")
        if not torch.equal(sims[fused].flat_params, sims[flat].flat_params):
            fail(f"{flat}: params differ from the fused pipeline's")
    print("flat == fused on the GPU, bitwise: records and params of Random, "
          "RELAY and RELAY+YoGi")
    for name, (kw, _) in runs.items():
        cpu = Simulator(SimConfig(**COMMON, **kw), device="cpu").run()
        if [host(r) for r in gpu[name].records] != [host(r) for r in cpu.records]:
            fail(f"{name}: GPU host records differ from the CPU run")
    small = dict(n_learners=30, rounds=8, eval_every=4, seed=2, n_target=4,
                 mapping="label_uniform", use_agg_kernel=True, selector="priority",
                 saa=True, apt=True, scaling_rule="relay")
    report["small_run_max_abs_diff"] = {}
    for label, kw in (("RELAY", {}), ("RELAY+YoGi", {"server_opt": "yogi"}),
                      ("RELAY flat", {"fused_rounds": False})):
        sims_s = {dv: Simulator(SimConfig(**small, **kw), device=dv)
                  for dv in ("cuda", "cpu")}
        accts = {dv: sim.run() for dv, sim in sims_s.items()}
        p_gpu, p_cpu = sims_s["cuda"].flat_params.cpu(), sims_s["cpu"].flat_params
        if p_gpu.shape != (p_cpu.numel(),) or not torch.isfinite(p_gpu).all():
            fail(f"small {label} run: parameters not finite or of the wrong width")
        err = (p_gpu - p_cpu).abs().max().item()
        if not torch.allclose(p_gpu, p_cpu, rtol=1e-3, atol=1e-4):
            fail(f"small {label} run: GPU params differ from the CPU run by {err}")
        if [host(r) for r in accts["cuda"].records] != \
                [host(r) for r in accts["cpu"].records]:
            fail(f"small {label} run: host records differ")
        report["small_run_max_abs_diff"][label] = err
    print(f"GPU == CPU: host records of all {len(runs)} campaigns equal; small "
          f"runs' params max abs diff {report['small_run_max_abs_diff']} "
          f"(D={p_cpu.numel()})")

    # --- 5. kernel times ------------------------------------------------
    times = {}
    for kernel in REPLACES:
        n_main = ns[kernel].most_common(1)[0][0]
        times[kernel] = {
            "main": time_kernel(torch, saa_ops, saa_ref, kernel, 1, n_main,
                                MAIN_D, 500, gen),
            "large": time_kernel(torch, saa_ops, saa_ref, kernel, *LARGE, 50, gen)}
        for label, t in times[kernel].items():
            lib = ("" if t["library_ms"] is None else
                   f", library {t['library_ms']:.4f} ms (device "
                   f"{t['library_device_ms']:.4f})")
            print(f"{kernel} {label} {t['shape']}: kernel {t['ms']:.4f} ms "
                  f"(device {t['device_ms']:.4f}), plain {t['plain_ms']:.4f} ms "
                  f"(device {t['plain_device_ms']:.4f}){lib}, bound "
                  f"{t['bound_ms']:.6f} ms ({t['bound_by']})")
    # the flat path's per-round D padding (staleness_aggregate's bucket_pad)
    from repro_torch.core.aggregation import bucket_pad
    n_flat = ns[CELL_AGG].most_common(1)[0][0]
    u = torch.randn((n_flat, d_model), generator=gen, device="cuda")
    fresh = torch.arange(n_flat, device="cuda") < n_flat // 2
    tau = torch.zeros(n_flat, dtype=torch.int32, device="cuda")
    pad = lambda: bucket_pad(u, fresh, tau, lane_block=saa_ops.D_BLK)
    times["flat_pad"] = {"shape": {"n": n_flat, "D": d_model},
                         "ms": time_ms(torch, pad, 500),
                         "device_ms": graph_ms(torch, pad)}
    print(f"flat path D pad {times['flat_pad']['shape']} -> {saa_ops.D_BLK}-"
          f"column block: {times['flat_pad']['ms']:.4f} ms (device "
          f"{times['flat_pad']['device_ms']:.4f}) per round")
    report.update(times=times, launches=dict(launches),
                  kernel_checks=dict(checks.n), max_abs_err=dict(checks.err),
                  max_rel_err=dict(checks.rel),
                  main_path_n={k: dict(v) for k, v in ns.items()})
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(report, indent=1))

    kernels = [{
        "name": kernel, "route": "cuda", "source": SOURCE,
        "replaces": REPLACES[kernel], "launches": launches[kernel],
        "max_abs_err": checks.err[kernel],
        "ms": times[kernel]["main"]["ms"],
        "plain_ms": times[kernel]["main"]["plain_ms"],
        "bound_ms": times[kernel]["main"]["bound_ms"],
        "bound_by": times[kernel]["main"]["bound_by"],
        "library_ms": times[kernel]["main"]["library_ms"],
    } for kernel in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
