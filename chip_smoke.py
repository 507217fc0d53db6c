#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

From the repository root, with nothing built beforehand.  It
  1. prints the card's name and power limit;
  2. builds every CUDA kernel from the sources in ``src/repro_torch``;
  3. holds each kernel against its plain PyTorch version on the card (the
     round pipeline's shapes, a large shape, every scaling rule, padding,
     no-stale, no-fresh and all-invalid cells; the params update in place);
  4. drives the port's main path — the quickstart's Random and RELAY
     campaigns at full scale with the SAA kernel on — with the launch
     counters zeroed just before, and checks every kernel was launched once
     per round that aggregated; then times each campaign warm (rounds/s)
     and profiles it (device busy share, top GPU kernels);
  5. checks the result: finite parameters of the model's width, host
     records equal to a CPU run of the same campaigns, and a small run on
     the GPU close to the same run on the CPU;
  6. times each kernel and its plain version and prints their bounds.
It exits non-zero, printing no result, on any failure or without a GPU.
The next-to-last line is the per-kernel JSON summary, the last line
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""
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
# as the JAX package's own kernel tests hold its Pallas kernel
W_RTOL, W_ATOL = 1e-5, 1e-6
P_RTOL, P_ATOL = 1e-4, 1e-5
MAIN_D = 14336        # mlp on speech: D = 12835 padded to the 2048-column block


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip()


def saa_inputs(torch, s, n, d, case, gen):
    """Operands of the SAA kernel for one check; ``case`` picks the masks."""
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


def check_saa(torch, ops, ref, s, n, d, rule, case, gen) -> float:
    params, u, fresh, tau, valid, scal = saa_inputs(torch, s, n, d, case, gen)
    p_k = params.clone()
    ptr = p_k.data_ptr()
    out, w_k = ops.sweep_fused_staleness_apply(p_k, u, fresh, tau, valid, scal,
                                               rule=rule)
    torch.cuda.synchronize()
    if out.data_ptr() != ptr or p_k.data_ptr() != ptr:
        fail(f"SAA kernel did not update params in place ({case})")
    p_r = params.clone()
    _, w_r = ref.sweep_fused_staleness_apply(p_r, u, fresh, tau, valid, scal,
                                             rule=rule)
    torch.cuda.synchronize()
    what = f"S={s} n={n} D={d} rule={rule} case={case}"
    if not (torch.isfinite(p_k).all() and torch.isfinite(w_k).all()):
        fail(f"non-finite kernel output at {what}")
    if not torch.allclose(w_k, w_r, rtol=W_RTOL, atol=W_ATOL):
        fail(f"weights differ at {what}: {(w_k - w_r).abs().max().item()}")
    if not torch.allclose(p_k, p_r, rtol=P_RTOL, atol=P_ATOL):
        fail(f"params differ at {what}: {(p_k - p_r).abs().max().item()}")
    if case == "all_invalid" and not torch.equal(p_k[-1], params[-1]):
        fail(f"an all-invalid cell changed its params at {what}")
    return max((w_k - w_r).abs().max().item(), (p_k - p_r).abs().max().item())


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


def saa_cost(s, n, d, n_fresh):
    """(bytes, flops) the SAA step needs: each input read once, each output
    written once; flops of the deviation pass (mixed, difference, square,
    sum: 6 per element), the fresh mean (n_f adds and a divide per column),
    the denominator (2 per column) and the apply (2 per element, 2 per
    column)."""
    nbytes = (2 * s * d * 4            # params in and out
              + s * n * d * 4          # U
              + s * n * (1 + 1 + 4)    # fresh, valid, tau
              + s * 2 * 4              # scal
              + s * n * 4)             # weights out
    flops = s * d * (6 * n + n_fresh + 1 + 2 + 2 * n + 2)
    return nbytes, flops


def time_saa(torch, ops, ref, s, n, d, iters, gen) -> dict:
    params, u, fresh, tau, valid, scal = saa_inputs(torch, s, n, d, "mixed", gen)
    p_k, p_r = params.clone(), params.clone()
    res = {"shape": {"S": s, "n": n, "D": d}}
    # plain, kernel, kernel, plain: the card's clocks drift over a call
    pr1 = time_ms(torch, lambda: ref.sweep_fused_staleness_apply(
        p_r, u, fresh, tau, valid, scal), iters)
    k1 = time_ms(torch, lambda: ops.sweep_fused_staleness_apply(
        p_k, u, fresh, tau, valid, scal), iters)
    k2 = time_ms(torch, lambda: ops.sweep_fused_staleness_apply(
        p_k, u, fresh, tau, valid, scal), iters)
    pr2 = time_ms(torch, lambda: ref.sweep_fused_staleness_apply(
        p_r, u, fresh, tau, valid, scal), iters)
    nbytes, flops = saa_cost(s, n, d, int(fresh.sum()))
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    res.update(ms=min(k1, k2), ms_runs=[k1, k2], plain_ms=min(pr1, pr2),
               plain_ms_runs=[pr1, pr2],
               device_ms=graph_ms(torch, lambda: ops.sweep_fused_staleness_apply(
                   p_k, u, fresh, tau, valid, scal)),
               plain_device_ms=graph_ms(torch, lambda: ref.sweep_fused_staleness_apply(
                   p_r, u, fresh, tau, valid, scal)),
               bytes=nbytes, flops=flops,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
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
    from repro_torch.quickstart import CAMPAIGNS, COMMON, run_campaigns, table
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
    max_err, n_checks = 0.0, 0
    for s, n, d in ((1, 1, MAIN_D), (1, 10, MAIN_D), (1, 16, MAIN_D),
                    (3, 10, MAIN_D), (1, 64, 1 << 20)):
        for rule in rules:
            for case in cases:
                max_err = max(max_err, check_saa(torch, saa_ops, saa_ref, s, n,
                                                 d, rule, case, gen))
                n_checks += 1
    print(f"SAA kernel == plain version in {n_checks} checks "
          f"(max abs err {max_err:.3g})")

    # --- 3. the main path, launch counters zeroed just before -----------
    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpu = run_campaigns(device="cuda", progress=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    aggregated = sum(1 for a in gpu.values() for rec in a.records
                     if rec.n_fresh + rec.n_stale > 0)
    if launches.get(saa_ops.NAME, 0) == 0:
        fail("the main path never launched the SAA kernel")
    if launches[saa_ops.NAME] != aggregated:
        fail(f"SAA kernel launches {launches[saa_ops.NAME]} != rounds that "
             f"aggregated {aggregated}")
    print(table(gpu))
    print(f"main path: {launches} launches over {aggregated} aggregating "
          f"rounds, {wall:.2f}s wall for both campaigns")

    # per-campaign rounds/s: a second, warm run of each
    report["campaigns"] = {}
    for name, kw in CAMPAIGNS.items():
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
        print(f"  host spans (CPU ms): " + ", ".join(
            f"{k} {v:.1f}" for k, v in sorted(prof["host_spans_ms"].items())))
        for kname, ms in prof["top_kernels_ms"].items():
            print(f"  {ms:9.3f} ms  {kname[:90]}")

    # --- 4. the result is right ----------------------------------------
    def host(r):
        return (r.round_idx, r.sim_time, r.n_selected, r.n_fresh, r.n_stale,
                r.resource_used, r.resource_wasted, r.unique_participants)

    for name, a in gpu.items():
        if not a.records:
            fail(f"{name}: no rounds recorded")
        evals = [r for r in a.records if r.accuracy == r.accuracy]
        if not evals or not all(0.0 <= r.accuracy <= 1.0 and r.loss == r.loss
                                for r in evals):
            fail(f"{name}: missing or invalid evaluations")
    cpu = run_campaigns(device="cpu", progress=False)
    for name in gpu:
        if [host(r) for r in gpu[name].records] != [host(r) for r in cpu[name].records]:
            fail(f"{name}: GPU host records differ from the CPU run")
    small = dict(n_learners=30, rounds=8, eval_every=4, seed=2, n_target=4,
                 mapping="label_uniform", use_agg_kernel=True, selector="priority",
                 saa=True, apt=True)
    sims = {dv: Simulator(SimConfig(**small), device=dv) for dv in ("cuda", "cpu")}
    accts = {dv: sim.run() for dv, sim in sims.items()}
    p_gpu, p_cpu = sims["cuda"].flat_params.cpu(), sims["cpu"].flat_params
    d_model = p_cpu.numel()
    if p_gpu.shape != (d_model,) or not torch.isfinite(p_gpu).all():
        fail("small run: parameters not finite or of the wrong width")
    small_err = (p_gpu - p_cpu).abs().max().item()
    if not torch.allclose(p_gpu, p_cpu, rtol=1e-3, atol=1e-4):
        fail(f"small run: GPU params differ from the CPU run by {small_err}")
    if [host(r) for r in accts["cuda"].records] != [host(r) for r in accts["cpu"].records]:
        fail("small run: host records differ")
    print(f"GPU == CPU: quickstart host records equal; small run params "
          f"max abs diff {small_err:.3g} (D={d_model})")
    report["small_run_max_abs_diff"] = small_err

    # --- 5. kernel times ------------------------------------------------
    ns = Counter(r.n_fresh + r.n_stale for a in gpu.values() for r in a.records
                 if r.n_fresh + r.n_stale > 0)
    n_main = ns.most_common(1)[0][0]
    main_t = time_saa(torch, saa_ops, saa_ref, 1, n_main, MAIN_D, 500, gen)
    large_t = time_saa(torch, saa_ops, saa_ref, 1, 64, 1 << 20, 50, gen)
    report.update(saa_main=main_t, saa_large=large_t, launches=launches,
                  aggregated_rounds=aggregated, kernel_checks=n_checks,
                  max_abs_err=max_err, main_path_n=dict(ns))
    for label, t in (("main-path shape", main_t), ("large shape", large_t)):
        print(f"SAA {label} {t['shape']}: kernel {t['ms']:.4f} ms "
              f"(device {t['device_ms']:.4f}), plain {t['plain_ms']:.4f} ms "
              f"(device {t['plain_device_ms']:.4f}), bound {t['bound_ms']:.4f} "
              f"ms ({t['bound_by']})")
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(report, indent=1))

    kernels = [{
        "name": saa_ops.NAME, "route": "cuda",
        "source": "src/repro_torch/kernels/staleness_agg/csrc/staleness_agg.cu",
        "replaces": "src/repro/kernels/staleness_agg/staleness_agg.py:267",
        "launches": launches[saa_ops.NAME], "max_abs_err": max_err,
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
