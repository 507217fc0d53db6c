#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

From the repository root, with nothing built beforehand.  It
  1. prints the card's name and power limit;
  2. builds every CUDA kernel from the sources in ``src/repro_torch``;
  3. holds each kernel of the SAA family against its plain PyTorch version
     on the card (the round pipeline's shapes, a large shape, every scaling
     rule, padding, no-stale, no-fresh and all-invalid cells, and
     ``screened`` cells: the guard's survivor mask, holes among fresh and
     stale rows with the rejected rows zeroed; the params update in place),
     and holds the apply kernels bit for bit to the
     aggregate kernels followed by torch's ``params + lr * agg``, and the
     one-launch cluster kernel of kernels 1-4 bit for bit to their
     three-launch chain (U in shared memory, U read from L2, one to three
     chunks a block), ``deviation_partials``' cluster kernel bit for bit to
     its two-launch chain (every SAA check case, and every chunk count from
     1 to 16 at n from 1 to 1024), and ``weighted_aggregate`` bit for bit to
     the server step's aggregate on its weights; holds the
     trimmed-mean kernel against its plain version (mixed trim depths and
     valid counts, +inf exclusion rows, D off the 2048 block, ties, -0.0 and
     +0.0 tied, even and odd medians, degenerate cells, n around each
     variant's edges), each of its variants (regs, sort, rank) forced and
     held bit for bit to the row-order plain version; after step 4 it does
     the same at every
     participant count n the paths ran a kernel at; holds the sliding-window
     attention kernels (bf16 on the tensor-core kernel, fp32 on the CUDA-core
     one, each counted; GQA groups 1-8, head dims 64, 112 and 128 (other
     head dims refused on the card), windows 128,
     384 and 8192, S at the query- and key-tile edges and below, at and past
     the window, both layouts) and the WKV6 kernel (head sizes 8-64, S of 1,
     31, 33, 200 and 4096, with and without an initial state, a state
     carried across calls) against their plain versions, each also at the
     serve path's shape and attention at kimi-k2's (64 heads, Dh 112);
  4. drives the port's paths at full width, each with the launch counters
     zeroed just before it and read just after: at the quickstart's scale
     the fused pipeline's Random and RELAY campaigns
     (``sweep_fused_staleness_apply``) and RELAY+YoGi
     (``sweep_fused_staleness_aggregate``), the per-stage flat path's
     Random, RELAY and RELAY+YoGi (``fused_staleness_aggregate``), and the
     host entry points' A/B path over the flat RELAY campaign's rounds
     (``fused_staleness_apply``, ``deviation_partials``,
     ``weighted_aggregate``); then the robustness race of
     ``examples/chaos_round.py`` (100 learners, 40 rounds, a colluding
     sign-flip attack) under five aggregators, each fused and flat:
     attacked saa, multi_krum and norm_median_clip launch no kernel, and
     coord_median and trimmed_mean launch ``sweep_trimmed_aggregate``;
     then ``examples/selector_zoo.py``'s selector race at its full size
     (every registered selector fused, SAFA and Oort flat too) and
     ``benchmarks/figures.py`` fig07's SAFA-vs-RELAY pair, each printing the
     rows a round kernel 1 saw and where the cluster kernel read U.
     Every kernel must launch exactly once per round that aggregated on
     its path (kernels 1-5 each time on the cluster kernel, the trimmed
     mean on the variant its n takes), and no other kernel may launch; a
     launch inside a CUDA graph counts once per replay.  Every fused run
     on kernel 1 or 2 must replay each of its rounds from a captured graph
     (a bounded number of captures, each warm-up at most one launch of its
     kernel), and the robust ones run eagerly; the fused quickstart
     campaigns run again in K = 4 round chunks, bit for bit their K = 1
     runs, with the same launches; then each campaign (and those K = 4
     runs, and the same campaigns with their rounds dispatched eagerly, the
     graphs off) is timed warm (rounds/s, and the graph captures' seconds
     apart) and profiled (device busy share, host spans, top GPU kernels);
     then the model zoo's serve path in bf16: internlm2-1.8b+swa
     prefill and logits (``swa_attention_bhsd``, every launch on its
     tensor-core kernel), rwkv6-1.6b prefill
     (``wkv6_bhsn``) and greedy requests of each; and the chaos harness
     (``chaos_paths``): ``examples/chaos_round.py``'s four guard modes at
     full size under its fault plan, fused and graphed with the guard's
     screen and quorum gate inside the round graph, guard=clip+reject's
     flat twin, a guarded RELAY+YoGi run, guard=reject at K = 4 and eager,
     guard + coord_median under attack (kernels 1, 2, 3 and 7; a round
     whose quorum fails still launches its kernel, so each kernel launches
     once per round with a group, the flat twin's kernel 3 too, with the
     survivor mask), then each kernel against its plain version at the n
     those runs gave it (the screened case included), a soft crash after
     round 15 resumed from its
     snapshot at K = 1 and 4, and the sweep CLI's hard crash (SIGKILL) and
     ``--resume`` in subprocesses; then telemetry (``telemetry_paths``):
     RELAY (kernel 1) and RELAY+YoGi (kernel 2) at the quickstart's size
     at telemetry level 2, the round-stats lane inside the round graph,
     bit for bit their level-0 runs, their round logs at K = 4 and eager
     byte-equal to K = 1's; a level-1 flat twin (kernel 3) and
     coord_median at level 2 under the race's attack (kernel 7); the
     guarded chaos run at level 2 crashed after round 15 and resumed into
     its telemetry directory, its round log byte-equal to the
     uninterrupted run's; the round logs against CPU runs; the sweep CLI
     with ``--telemetry-dir`` and a guarded sweep's ``metrics.prom``
     against its accountings; rounds/s at levels 0, 1 and 2 in turns, the
     lane's device time, d2h bytes a chunk and the snapshot seconds; then
     the federated LM learner (``lm_fl_paths``): ``python -m
     repro_torch.federated_lm``'s cell (tokens_skew, 32 learners, the
     transformer LM, D = 213,312) with random selection, its ``--parity``
     flat rerun, K = 4 and eager, its oort and flips race, rwkv6 and moe
     at their default knobs and a RELAY+YoGi cell: kernels 1, 2 and 3 on
     their chain (105-133 chunks of 2048 columns), once a round with a
     group, kernels 1 and 2 replayed from the round graph; fused == flat,
     K = 4 == K = 1 and eager == graphed bit for bit, host records equal
     to CPU runs, params close to them (rwkv6's gradient), the pad
     columns zero and the eval NLL falling, then kernels 1-4 against their
     plain versions at the LM shapes; warm rounds/s graphed and eager;
     then the zoo's other eight architectures (``arch_paths``) at full
     width in bf16 under the long_500k window of 8192, one model at a
     time, depth cut only where one card cannot hold the weights
     (``ARCH_PATHS``): qwen2.5-3b, minicpm-2b, musicgen-medium,
     deepseek-v2-lite (MLA: plain attention, no kernel 8), qwen2.5-32b,
     internvl2 (256 patch embeddings before the tokens), jamba (Mamba and
     attention) and kimi-k2 (Dh 112): a 1 x 16,384 prefill with exact
     kernel 8 launches and B = 4 requests each (deepseek's with absorbed
     MLA; naive == absorbed decode is held on fp32 weights), its prefill
     profile; and, after the sweep paths, the sharding phase
     (``sharding_paths``): ranks it spawns itself
     (``repro_torch.sim.participant_sharding.run_ranks``) run (a) the
     quickstart's RELAY campaign with ``shard_participants=4`` on a
     one-rank NCCL group, graphed with the round's all-reduce in its graph,
     bit for bit the unsharded run, and on two gloo ranks sharing the card
     (b) 10,000 learners with a 64-learner cohort split over "p", (c) an
     S = 8 YoGi sweep split over "s" whose early stops repack it across
     the boundary and (d) a trimmed-mean cell whose 64-row groups take
     kernel 7's ``sort`` variant; kernels 1, 2 and 7 once a round that
     aggregated on a rank, one all-reduce each; host records equal to the
     unsharded runs, params bit for bit where the cuBLAS probe allows it,
     else within the sweep phase's tolerance;
  5. checks the result: finite parameters of the model's width; each flat
     campaign equal to its fused twin bit for bit (records, params and
     robust counters), each eager run to its graphed one; kernels 1 and 2
     at every n the paths ran them at equal, bit for bit, to the same cells
     padded with invalid zero rows; host records, attacker sets and robust counters
     equal to a CPU run of every campaign (the race's and fig07's too);
     coord_median ahead of attacked
     saa in final accuracy (the example's own pass rule); small RELAY,
     RELAY+YoGi, RELAY flat and attacked coord_median runs on the GPU
     close to the same runs on the CPU; the serve path's logits finite,
     close to a run of the plain versions (bf16: no further from the fp32
     model than the plain versions' bf16 run), prefill equal to decode after
     a short prompt, and the reduced configs of all ten architectures on
     the GPU equal to the CPU; the eight architectures' kernel path against
     the plain versions on the last 1,024 positions' logits (fp32 where a
     copy fits, else bf16 against bf16), and on fp32 weights prefill ==
     decode for MLA naive and absorbed, Mamba and the vision prefix, and
     absorbed == naive MLA decode;
     the guard without faults equal to no guard bit for bit, the guarded
     runs finite and rejecting rows, ``repro_torch.chaos_round --smoke``
     passing the example's own gates on the card (within 0.15 of clean;
     at full size the guarded runs miss it, an open fault whose final
     accuracies are printed beside the CPU runs'), K = 4 and eager
     guarded rounds equal to K = 1 graphed ones bit for bit, host records
     and guard counters equal to CPU runs, each resumed run equal to its
     uninterrupted one bit for bit with no graph captured on resume, and
     the CLI's resumed sweep equal to an uninterrupted one;
  6. times each kernel, its plain version and (where one exists) the one
     PyTorch call that computes the same function, and prints their bounds
     (and, for the LM kernels, the achieved TFLOP/s and share of the bound);
     for kernels 1-4 also the profiler's device time of their kernels, the
     launch floor (one empty block), both variants of the server step from
     the main shape to the large one, kernel 1 at fig07 SAFA's median rows
     a round, kernel 5's two variants in turns at the main and large
     shapes, and the cluster kernel's phases (a
     copy built with its device-clock stamps); for the trimmed mean every
     variant's time at n = 10, 16, 32, 64, 128 and 256; for
     ``weighted_aggregate`` the library call's kernel time, the chain's
     ``saa_apply`` (its route before) and where its host time goes (the
     "wrapper host path" line); kernels 1-3 on the chain at the LM
     cells' shapes, and a profile of the example's LM cell;
     each build's registers and spills, per kernel, are printed after step 2;
  7. right after step 2, before any profiler session (its ~1.5 million
     kernels, run after one, left later profiler reads empty and ran
     slower), the pod FL train step (``train_paths``):
     internlm2-1.8b at full width under train_4k (bf16, loss chunks of
     1,024, remat), 4 participants (one stale) of 1 x 4,096 tokens, one
     local step, through ``repro_torch.launch.train``'s vmap cohort (warm,
     then timed; profiled at the end), its stream cohort and a YoGi step, each
     launching no kernel (kernels 8 and 9 are forward-only), and ``python
     -m repro_torch.launch.train --rounds 10`` in a subprocess; gates: loss
     finite, params changed, weights summing to 1, vmap == stream within
     the reference test's bounds, the vmap weights and aggregate
     recomputed in fp64 from its own deltas, remat on == off bit for bit at
     a 4-layer cut with less peak memory, the reduced model's step on the
     card == on the CPU, and ``lm_loss`` through kernels 8 and 9 refusing
     autograd on the card;
  8. after the sharding phase, the legacy pytree engine and the launch
     layer (``legacy_launch_paths``): the quickstart's three campaigns and
     a trimmed_mean cell at ``fast_path=False`` (kernel 3, kernel 7 once
     an aggregating round; host records == the fused run's), the REDUCED
     internlm2 train step placed on a one-rank (1, 1) NCCL mesh == the
     unplaced step, the REDUCED qwen2.5-32b, deepseek-v2-lite-16b (naive
     and absorbed MLA decode), jamba-v0.1-52b and internlm2-1.8b prefill,
     decode step and train step (both cohorts) placed there == unplaced,
     and the dispatch counter's FLOPs of the full-width vmap round; and
     last, after every timed phase, the pod dry run's ``SMOKE``
     combinations on both meshes in this process (``dryrun_paths``:
     host-only, the fake pod group made and destroyed).
It exits non-zero, printing no result, on any failure or without a GPU.
The next-to-last line is the per-kernel JSON summary, the last line
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""
import ctypes
import dataclasses
import json
import re
import subprocess
import sys
import time
import types
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

# H100 SXM fp32 lane-instruction rate: 132 SMs x 128 lanes x 1.98 GHz, half
# the FMA-counted 67 TFLOP/s; the trimmed mean's min/max work is counted
# against it
PEAK_FP32_LANE_OPS = 33.5e12
SOURCE = "src/repro_torch/kernels/staleness_agg/csrc/staleness_agg.cu"
TRIM_SOURCE = "src/repro_torch/kernels/trimmed_agg/csrc/trimmed_agg.cu"
PALLAS = "src/repro/kernels/staleness_agg/staleness_agg.py"
# SAA kernel -> the line of its TPU def
SAA_REPLACES = {
    "sweep_fused_staleness_apply": f"{PALLAS}:267",
    "sweep_fused_staleness_aggregate": f"{PALLAS}:318",
    "fused_staleness_aggregate": f"{PALLAS}:364",
    "fused_staleness_apply": f"{PALLAS}:410",
    "deviation_partials": f"{PALLAS}:460",
    "weighted_aggregate": f"{PALLAS}:490",
}
APPLY, AGG, CELL_AGG, CELL_APPLY, PARTIALS, WAGG = SAA_REPLACES
FUSED = (APPLY, AGG, CELL_AGG, CELL_APPLY)   # the cluster kernel or the chain
# each kernel's GPU kernels, by name, for the profiler's device time:
# kernels 1-4 by variant, then kernels 5-7
VARIANT_KERNELS = {"cluster": ("saa_cluster(",),
                   "chain": ("saa_partials(", "saa_weights(", "saa_apply(")}
# the cluster kernel is held bitwise to the chain wherever it is cheap to
# force (up to this many 2048-column chunks; past it, it streams U on 8 SMs)
CLUSTER_CHECK_CHUNKS = 64
# the two variants' times: the main shape, n past which U no longer fits in
# shared memory, the large shape, and D around the threshold at n = 10
VARIANT_SHAPES = {"main n=10": (1, 10, MAIN_D), "n=16": (1, 16, MAIN_D),
                  "n=30 (U from L2)": (1, 30, MAIN_D), "large": LARGE,
                  **{f"n=10 {c} chunks": (1, 10, c * 2048)
                     for c in (8, 9, 12, 16, 17, 20, 24, 32, 64)}}
TRIM = "sweep_trimmed_aggregate"
KERNEL_NAMES = {WAGG: ("saa_weighted_agg(",)}
# kernel 5's GPU kernels by variant
PARTIAL_KERNELS = {"cluster": ("saa_partials_cluster(",),
                   "chain": ("saa_partials(", "saa_partials_sum(")}
# kernel 5's bitwise grid: every chunk count the cluster takes by default,
# at n around the server step's shared-memory staging edge (28 / 29 rows)
# and up to the kernels' row limit
PARTIAL_GRID_N = (1, 2, 10, 28, 29, 64, 1024)
# the trimmed mean's GPU kernel by variant
TRIM_KERNELS = {"regs": ("trimmed_regs<",), "sort": ("trimmed_sort<",),
                "rank": ("trimmed_band_mean(",)}
REPLACES = {**SAA_REPLACES,
            TRIM: "src/repro/kernels/trimmed_agg/trimmed_agg.py:61"}
TRIM_D = (2048, 2 * 2048 + 37, 12835)   # the TPU block, off it, the model
TRIM_CASES = ("mixed", "ties", "signed_zero", "median", "degenerate", "equal")
# the trimmed mean's check grid: n around each variant's edges (8 and 16
# register slots; 1, 2 and 8 sorting threads a column), and the race's n
TRIM_GRID_N = (1, 2, 3, 6, 9, 16, 31, 32, 33, 63, 64, 65, 255, 256, 257)
# n around the sort's 1024-row limit (the rank count past it), at D = 2048
TRIM_EDGE_N = (1023, 1024, 1025)
# the most rows at which the kernel is also held to the sort formula: the
# formula sums the band pairwise, the kernel (as the Pallas kernel) in row
# order, and past a few hundred rows the two drift apart by up to ~n ulps
# (4.5e-5 relative for 1,020 equal values at n = 1023), beyond the weights'
# tolerance; there the row-order plain version alone holds it, bit for bit
TRIM_FORMULA_MAX_N = 257
# the trimmed mean's times: (n, D) by label; n = 16 (the regs variant's
# last n), 32 and 128 set the variants' thresholds
TRIM_TIMES = {"n16": (16, 1 << 20), "n32": (32, 1 << 20), "large": (64, 1 << 20),
              "n128": (128, 1 << 20), "n256": (256, 1 << 18)}
# examples/chaos_round.py's robustness race at its full size: the
# quickstart's model, a colluding sign-flip attack on 10% of the learners
RACE = dict(n_learners=100, rounds=40, eval_every=10, n_target=10,
            selector="priority", saa=True, scaling_rule="relay",
            mapping="label_uniform", seed=0, setting="DL", deadline=1e6,
            attack="collude_signflip", attack_frac=0.1, attack_scale=50.0,
            use_agg_kernel=True)
# the model zoo's serve path: the two kernels, their sources and TPU defs
SWA, WKV = "swa_attention_bhsd", "wkv6_bhsn"
LM_SOURCES = {SWA: "src/repro_torch/kernels/swa_attention/csrc/swa_attention.cu",
              WKV: "src/repro_torch/kernels/wkv6/csrc/wkv6.cu"}
LM_REPLACES = {SWA: "src/repro/kernels/swa_attention/swa_attention.py:65",
               WKV: "src/repro/kernels/wkv6/wkv6.py:62"}
# H100 SXM dense bf16 tensor-core rate: attention's bound
PEAK_BF16_FLOPS = 989e12
# kernel 8's edge cases: S at and around its 64-row warpgroup and 128-row
# tile and key-tile edges, and around each window
SWA_EDGE_S = (1, 63, 64, 65, 127, 129)
# kernel vs plain version: fp32 as the JAX package holds its Pallas kernels
# (1e-4 attention, rtol 1e-4 / atol 1e-5 the scan); bf16 outputs compared in
# fp32 after the cast.  bf16 attention: the plain version sums in fp32; the
# tensor-core kernel rounds P to bf16 before P V, as a hi and a lo part
# (p = hi + lo to ~16 bits, each product summed in fp32), and both round
# the output once to bf16 (one ulp is at most 2^-8 of a value).  So bf16
# attention is held to 4 ulps with an atol under a tenth of the path's
# typical output (rms ~0.018 over 8192 keys), and to a relative L2 error of
# SWA_BF16_REL_L2 (output rounding alone gives ~1e-3); the scan's bf16 y at
# the reference's bf16 kernel tolerance, 3e-2
LM_TOL = {(SWA, "fp32"): (1e-4, 1e-4), (SWA, "bf16"): (1.6e-2, 1e-3),
          (WKV, "fp32"): (1e-4, 1e-5), (WKV, "bf16"): (3e-2, 3e-2)}
SWA_BF16_REL_L2 = 5e-3
# whole-model logits, kernel path vs plain versions on the same weights:
# relative L2 error in fp32 (the two sum in other orders; 1e-3 is the
# GPU-vs-CPU rule's rtol).  In bf16 a rounding flip at one layer grows
# through the depth, so the bf16 kernel path is held to be no further from
# the fp32 model (the plain versions in fp32) than the plain versions' own
# bf16 run: relative L2 <= ratio * the plain run's + margin.  Two bf16
# results of one function on the same hidden states (prefill's last
# logits, the full logits' last row) are held to 3e-2.
FP32_REL_L2 = 1e-3
BF16_DRIFT = (1.25, 1e-3)
LOGIT_REL_L2 = 3e-2
# rwkv6's plain scan is ~0.6 s a layer at 4,096 steps: its comparison runs
# the first 512 tokens of the path's batch (same width, same batch)
WKV_PLAIN_S = 512
# the serve path's shapes: internlm2-1.8b+swa prefill (two windows), rwkv6
# prefill at train_4k's length, requests as examples/serve_model.py sends them
SWA_PATH = dict(B=1, S=16_384)
# kernel 8 at kimi-k2's attention (B, S, H, Hkv, Dh, window): 7168 / 64 = 112
KIMI_SWA = (1, 16_384, 64, 8, 112, 8192)
WKV_PATH = dict(B=8, S=4_096)
REQUESTS = dict(B=4, prompt=12, gen=24)
# the zoo's other eight architectures at full width (``arch_paths``): arch ->
# (layers run, None for all; kernel 8 launches a prefill).  Depth is cut
# only where one card cannot hold the bf16 weights: qwen2.5-32b's 64 layers
# to 16, internvl2's 80 to 8, jamba's 32 to one 8-layer super-block (7
# Mamba, 1 attention; 4 MoE, 4 dense), kimi-k2's 61 to its dense first
# layer and one MoE layer of all 384 experts.  deepseek's MLA runs plain
# attention, as in the reference: no kernel 8 launch.
ARCH_PATHS = {"qwen2.5-3b": (None, 36), "minicpm-2b": (None, 40),
              "musicgen-medium": (None, 48), "deepseek-v2-lite-16b": (None, 0),
              "qwen2.5-32b": (16, 16), "internvl2-76b": (8, 8),
              "jamba-v0.1-52b": (8, 1), "kimi-k2-1t-a32b": (2, 2)}
ARCH_S = 16_384               # prefill positions: two windows, so it slides
# the kernel path against the plain versions, in fp32 and in bf16, at full
# width, cut to 2 layers unless listed (jamba: its 8-layer super-block;
# kimi-k2: its dense first layer alone, since a layer of its 384 experts is
# 68 GB in fp32 and an empty MoE stack still draws one layer to shape it),
# on the logits of the last rows of the prefill (all past the window)
ARCH_PLAIN_CUT = {"jamba-v0.1-52b": dict(n_layers=8),
                  "kimi-k2-1t-a32b": dict(n_layers=1, moe=False)}
ARCH_LOGIT_ROWS = 1024
# absorbed vs naive MLA decode logits in fp32: the reference's own test's
# rtol = atol (tests/test_mla_absorb.py)
MLA_ABSORB_TOL = 1e-3
# the requests' profile: 4 prompt + 4 generated tokens (the profiler's cost
# grows with its ~2,000 GPU kernels a decode step)
PROFILE_REQUESTS = dict(prompt=4, gen=4)
# the pod FL train step (``train_paths``): internlm2-1.8b at full width as
# the reference's dryrun lowers it for training (train_4k: bf16, loss chunks
# of 1,024, remat), P participants of which the last is stale at tau 2 (as
# the reference's CLI marks one), a local batch of 1 x 4,096 tokens each,
# one local step, rule relay; the vmap cohort warm once, then timed
TRAIN_ARCH = "internlm2-1.8b"
# (d): the layouts the dry run places, run on the card (arch, config overrides)
PLACED_ARCHS = (("qwen2.5-32b", {}), ("deepseek-v2-lite-16b", {}),
                ("deepseek-v2-lite-16b", {"mla_absorb": True}),
                ("jamba-v0.1-52b", {}), ("internlm2-1.8b", {}))
TRAIN_P = 4
TRAIN_TAU = 2
TRAIN_BATCH = (1, 4_096)
TRAIN_TIMED = 2
TRAIN_REMAT_LAYERS = 4        # the remat on / off cut, full width
TRAIN_CLI_ROUNDS = 10
# vmap == stream: the reference's own test's bounds (tests/test_models_smoke.py)
TRAIN_W_TOL, TRAIN_P_TOL = dict(rtol=1e-3, atol=1e-5), dict(rtol=1e-2, atol=1e-5)
# the CPU tests' bounds for card == CPU at REDUCED in fp32
# (tests/test_torch_fl_train_step.py)
TRAIN_CPU_TOL, TRAIN_UPDATE_REL_L2 = dict(rtol=1e-4, atol=1e-4), 1e-3
BF16_DENSE_PEAK = 989e12      # FLOP/s, H100 SXM data sheet, dense bf16

# examples/selector_zoo.py's race at its full size (zoo_spec, not --smoke),
# seed 0, with the SAA kernels on; flat twins of these two
ZOO_FLAT = ("safa", "oort")
# benchmarks/figures.py fig07's label_uniform pair: SAFA against RELAY under
# DL, dynamic availability, a 688 Mbit model, stale rows up to 5 rounds old
FIG07 = dict(n_learners=100, rounds=60, eval_every=15, seed=0,
             mapping="label_uniform", setting="DL", saa=True,
             staleness_threshold=5, deadline=100.0, model_mbits=688.0,
             use_agg_kernel=True)
FIG07_CELLS = {"fig07 SAFA": dict(FIG07, selector="safa", safa_target_ratio=0.10),
               "fig07 RELAY": dict(FIG07, selector="priority", apt=True)}
# the H100's opt-in shared memory a block (232,448 bytes) less saa_cluster's
# static shared memory: whether its U stays resident
CLUSTER_SMEM = 232_448 - 48

DEFENSES = {               # campaign -> (aggregator settings, its kernel)
    "saa (attacked)": ({}, None),
    "coord_median": (dict(aggregator="coord_median"), TRIM),
    "trimmed_mean": (dict(aggregator="trimmed_mean", trim_k=4), TRIM),
    "multi_krum": (dict(aggregator="multi_krum", krum_f=4), None),
    "norm_median_clip": (dict(aggregator="norm_median_clip",
                              guard_reject_mult=5.0), None),
}

# --- the sweep paths: lockstep batches of S cells (repro_torch.sweeps) ---
# benchmarks/bench_sweeps.py's S = 64 grid at the quickstart's scale, with
# the SAA kernels on: four selector-uniform batches of 16 cells
HARDWARE = ["HS1", "HS2", "HS3", "HS4"]
SWEEP_BASE = dict(n_learners=100, mapping="label_uniform", rounds=40,
                  eval_every=10, use_agg_kernel=True)
SWEEP_GRID = dict(axes={"selector": ["random", "oort", "priority", "safa"],
                        "saa": [False, True], "hardware": HARDWARE},
                  base=SWEEP_BASE, seeds=(0, 1))
# the same grid's 16 cells of seed 0 and HS1 / HS3 (bench_sweeps' S = 16)
SWEEP16_AXES = {"selector": ["random", "oort", "priority", "safa"],
                "saa": [False, True], "hardware": ["HS1", "HS3"]}
# RELAY + YoGi (S = 8), and the robustness race's two coordinate-wise
# defenses (S = 8 each; the race's settings, its seed now a grid axis)
YOGI_SWEEP = dict(axes={"hardware": HARDWARE},
                  base=dict(SWEEP_BASE, selector="priority", apt=True, saa=True,
                            scaling_rule="relay", server_opt="yogi"),
                  seeds=(0, 1))
ROBUST_SWEEPS = {name: dict(axes={"hardware": HARDWARE},
                            base={**{k: v for k, v in RACE.items() if k != "seed"},
                                  **DEFENSES[name][0]}, seeds=(0, 1))
                 for name in ("coord_median", "trimmed_mean")}
# batched vs serial where cuBLAS's batched GEMM gives one matrix other bits
# at another batch count (the probe below): the params' tolerance, the
# small runs' GPU-vs-CPU rule
SWEEP_RTOL, SWEEP_ATOL = 1e-3, 1e-4
# the probe's shapes: the batched MLP's five GEMMs a training step (B = 16
# samples, 64 features, 128 hidden, 35 classes), as (m, k, n)
TRAIN_GEMMS = {"x @ w1": (16, 64, 128), "h @ w2": (16, 128, 35),
               "dlogits @ w2^T": (16, 35, 128), "x^T @ dh": (64, 16, 128),
               "h^T @ dlogits": (128, 16, 35)}
# kernels 1 and 2 at S cells, kernel 7 at S groups
SWEEP_TIME_S = (1, 4, 16, 64)
TRIM_TIME_S = (1, 8)
# K-round chunks: the fused quickstart campaigns and the S = 64 sweep again
# at K = CHUNK_K, held bit for bit to K = 1
QUICK_FUSED = ("Random", "RELAY", "RELAY+YoGi")
# the campaigns profiled at the script's end: the first of each family (one
# profile a campaign cost ~45 s of the script's time limit)
PROFILED = ("Random", "Random K=4", "Random eager", "Random flat", "saa (attacked)",
            "saa (attacked) flat", "zoo random", "zoo safa flat", "fig07 SAFA")
CHUNK_K = 4
# the chaos phase: examples/chaos_round.py's accuracy gate, and its soft
# crash (after this round, a snapshot every that many rounds)
CHAOS_TOLERANCE = 0.15
CHAOS_CRASH = (15, 5)
# the most graphs a serial campaign and a sweep batch may capture (one a
# bucket: training rows x groups x operand rows x cache capacity)
CAPTURE_MAX, SWEEP_CAPTURE_MAX = 24, 48
# the telemetry phase: the lane's graph-replay shape (the main operand:
# 13 valid rows padded to 16), the warm timings' turns a level, and its
# crash's snapshot interval (rounds 12-15 are logged past the last one)
LANE_SHAPE = (1, 16, MAIN_D)
# the LM phase: python -m repro_torch.federated_lm's rounds, --race and the
# zoo's other two LMs at their default knobs
LM_ROUNDS = 30
LM_RACE = ("random", "oort", "flips")
LM_MODELS = ("rwkv6", "moe")
# the LM cells held to CPU runs, and those chaotic in fp32 at their knobs
# (in both packages: tests/test_torch_lm_learner.py), whose params are held
# to the CPU's after one round, within LM_SPREAD_MULT times the most that
# the initial row perturbed by 1e-7 (LM_SPREAD_SEEDS draws) moves the card's
# own; their eager, warm and CPU reruns take LM_CHAOTIC_ROUNDS rounds
LM_CPU = ("LM random", "LM oort", "LM flips", "LM moe", "LM RELAY+YoGi",
          "LM rwkv6")
LM_CHAOTIC = ("LM rwkv6",)
LM_CHAOTIC_ROUNDS = 8
LM_SPREAD_SEEDS = 3
LM_SPREAD_MULT = 2.0
TELEMETRY_REPS = 3
# the sharding phase (sharding_paths): (a) on a one-rank NCCL group, (b)-(d)
# on SHARD_RANKS gloo ranks sharing the card
SHARD_DEVICE, SHARD_NCCL = "cuda", "nccl"
SHARD_RANKS = 2
SHARD_TIMEOUT = 180.0        # a group's collectives; its whole run 2x that
SHARD_10K = dict(n_learners=10_000, rounds=6, eval_every=3, n_target=64,
                 saa=True, selector="priority", mapping="label_uniform",
                 seed=0, use_agg_kernel=True)
SHARD_SWEEP = dict(axes={"saa": [False, True], "hardware": HARDWARE},
                   base=dict(n_learners=30, rounds=12, eval_every=3,
                             n_target=4, mapping="label_uniform",
                             selector="priority", target_accuracy=0.15,
                             server_opt="yogi", use_agg_kernel=True),
                   seeds=(0,))
SHARD_TRIMMED = dict(n_learners=300, rounds=8, eval_every=4, n_target=64,
                     saa=True, selector="priority", mapping="label_uniform",
                     aggregator="trimmed_mean", use_agg_kernel=True, seed=0,
                     dynamic_availability=False)
TELEMETRY_CKPT_EVERY = 6


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip()


def ptxas_summary(log: str) -> list:
    """Per kernel of one ``nvcc -Xptxas -v`` log: its (demangled) name,
    registers and spill bytes."""
    mangled, out = [], []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled.append(m.group(1))
            out.append({"kernel": m.group(1)})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and out:
            out[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
    try:
        names = subprocess.run(["c++filt"], input="\n".join(mangled), capture_output=True,
                               text=True, timeout=60, check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = mangled
    for k, name in zip(out, names):
        k["kernel"] = re.sub(r"\(anonymous namespace\)::|\(.*", "", name)
        k.setdefault("spill_stores", 0)
        k.setdefault("spill_loads", 0)
        k.setdefault("registers", None)
    return out


def saa_inputs(torch, s, n, d, case, gen):
    """Operands of the SAA kernels for one check; ``case`` picks the masks."""
    dev = "cuda"
    u = torch.randn((s, n, d), generator=gen, device=dev)
    params = torch.randn((s, d), generator=gen, device=dev)
    fresh = torch.zeros((s, n), dtype=torch.bool, device=dev)
    valid = torch.ones((s, n), dtype=torch.bool, device=dev)
    nf = max(1, n // 2)
    if case in ("mixed", "padding", "all_invalid", "screened"):
        fresh[:, :nf] = True
    elif case == "no_stale":
        fresh[:] = True
    if case == "padding" and n > 2:
        valid[:, -(n // 4 or 1):] = False
        u[~valid] = 0.0          # the pipeline's padding rows are exact zeros
    if case == "all_invalid":
        valid[-1] = False
    if case == "screened":
        # the guard's survivor mask: holes among fresh and stale rows, the
        # rejected rows zeroed, ``fresh`` left as it was
        valid &= torch.rand((s, n), generator=gen, device=dev) >= 0.3
        u[~valid] = 0.0
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
        self.same = Counter()     # cluster == chain checks, by default variant
        self.cases = Counter()    # SAA checks by case (mixed, screened, ...)
        self.bits = Counter()     # bitwise checks: kernel 6 == the server
        #                           step's aggregate; trimmed mean by variant

    def close(self, kernel, got, want, what, weights=False, tol=None):
        """``weights``: hold to the weights' (and the trimmed mean's)
        tolerance, else to the aggregates'; ``tol``: (rtol, atol) instead.
        Both are compared in fp32."""
        torch = self.torch
        rtol, atol = tol or ((W_RTOL, W_ATOL) if weights else (P_RTOL, P_ATOL))
        got, want = got.float(), want.float()
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


def variant_outputs(ops, params, u, fresh, tau, valid, scal, rule, v):
    """Kernels 1-4 by variant ``v`` on one set of operands (the one-cell
    kernels on the last cell): {output: tensor}."""
    beta = scal[:, 0].contiguous()
    c = u.shape[0] - 1
    b, l = float(scal[c, 0]), float(scal[c, 1])
    p1, p4 = params.clone(), params[c].clone()
    _, w1 = ops.sweep_fused_staleness_apply(p1, u, fresh, tau, valid, scal,
                                            rule=rule, variant=v)
    a2, w2 = ops.sweep_fused_staleness_aggregate(u, fresh, tau, beta, valid,
                                                 rule=rule, variant=v)
    a3, w3 = ops.fused_staleness_aggregate(u[c], fresh[c], tau[c], b, rule=rule,
                                           valid=valid[c], variant=v)
    _, w4 = ops.fused_staleness_apply(p4, u[c], fresh[c], tau[c], b, l,
                                      rule=rule, valid=valid[c], variant=v)
    return {"apply weights": w1, "apply params": p1, "aggregate weights": w2,
            "aggregate": a2, "cell aggregate weights": w3, "cell aggregate": a3,
            "cell apply weights": w4, "cell apply params": p4}


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
    # kernel 6 on the server step's weights: the same aggregate, bitwise
    for cell in range(s):
        if not bits_equal(torch, ops.weighted_aggregate(w2[cell], u[cell]), agg[cell]):
            fail(f"{WAGG} != the server step's aggregate on its weights, bitwise, "
                 f"at {what} cell {cell}")
        checks.bits[WAGG] += 1
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
    checks.cases[case] += 1
    # the cluster kernel == the three-launch chain, bitwise
    if d // ops.D_BLK <= CLUSTER_CHECK_CHUNKS:
        by = {v: variant_outputs(ops, params, u, fresh, tau, valid, scal, rule, v)
              for v in ops.VARIANTS}
        torch.cuda.synchronize()
        for out, got in by["cluster"].items():
            if not torch.equal(got, by["chain"][out]):
                fail(f"cluster kernel != chain, bitwise, in its {out} at {what}")
        checks.same[ops.variant(s, n, d)] += 1
    if not rule_free:
        return
    # 5 and 6: no scaling rule; the partials (the cluster kernel == its
    # chain, bitwise) and a GEMV on given weights
    partials_bitwise(torch, ops, checks, u[0], fresh[0], what)
    num, den = ops.deviation_partials(u[0], fresh[0])
    num_r, den_r = ref.deviation_partials(u[0], fresh[0])
    o6 = ops.weighted_aggregate(w2_r[0], u[0])
    o6_r = ref.weighted_aggregate(w2_r[0], u[0])
    torch.cuda.synchronize()
    checks.close(PARTIALS, num, num_r, what)
    checks.close(PARTIALS, den, den_r, what)
    checks.close(WAGG, o6, o6_r, what)
    checks.count(PARTIALS, WAGG)


def bits_equal(torch, a, b) -> bool:
    """Equal bit for bit (-0.0 and +0.0 differ), fp32."""
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def partials_bitwise(torch, ops, checks, u, fresh, what):
    """Kernel 5's cluster kernel == its two-launch chain, bit for bit
    (num and den as int32 views), on one cell."""
    by = {v: ops.deviation_partials(u, fresh, variant=v) for v in ops.VARIANTS}
    torch.cuda.synchronize()
    for out, a, b in zip(("num", "den"), by["cluster"], by["chain"]):
        if not bits_equal(torch, a, b):
            fail(f"{PARTIALS}: cluster kernel != chain, bitwise, in {out} at {what}")
    checks.bits[f"{PARTIALS} cluster == chain"] += 1


def check_partials_grid(torch, ops, ref, checks, gen):
    """Kernel 5 at every chunk count the cluster takes by default (1 to
    ``CLUSTER_MAX_CHUNKS``) and every n of ``PARTIAL_GRID_N``: the cluster
    kernel == the chain bitwise, the default variant against the plain
    version."""
    for n in PARTIAL_GRID_N:
        for chunks in range(1, ops.CLUSTER_MAX_CHUNKS + 1):
            d = chunks * ops.D_BLK
            _, u, fresh, *_ = saa_inputs(torch, 1, n, d, "mixed", gen)
            what = f"n={n} D={d} ({chunks} chunks)"
            partials_bitwise(torch, ops, checks, u[0], fresh[0], what)
            num, den = ops.deviation_partials(u[0], fresh[0])
            num_r, den_r = ref.deviation_partials(u[0], fresh[0])
            torch.cuda.synchronize()
            checks.close(PARTIALS, num, num_r, what)
            checks.close(PARTIALS, den, den_r, what)
            checks.count(PARTIALS)


def cluster_resident(n, d) -> bool:
    """Whether ``saa_cluster`` stages U in shared memory at (n, D): its
    shared-memory layout (``cluster_floats`` in the CUDA source) within the
    block's budget."""
    nch = d // 2048
    per = -(-nch // 8)
    floats = (per * n * 2048 + per * (n + 1) + n * 8 + 2 * n + nch * (n + 1)
              + n + (n + 1) // 2)
    return floats * 4 <= CLUSTER_SMEM


def trimmed_inputs(torch, n, d, case, gen):
    """Operands of the trimmed-mean kernel for one check, three cells:
    y (3, n, D) with +inf rows past each cell's valid count, k_eff and c
    (3,) int32.  ``case`` picks the values and the trim depths."""
    dev = "cuda"
    y = torch.randn((3, n, d), generator=gen, device=dev)
    if case == "ties":
        y = torch.round(y * 2) / 2          # a few distinct values: many ties
    elif case == "signed_zero":
        y = torch.round(y * 0.7)            # mostly -0.0 and +0.0, tied, and +-1, +-2
    elif case == "equal":
        y = y[:, :1].expand(3, n, d).contiguous()   # one value per column
    c = [0, 1, n] if case == "degenerate" else [n, max(n - 1, 1), max(n - 3, 1)]
    if case in ("median", "degenerate"):
        k = [max((ci - 1) // 2, 0) for ci in c]
    else:
        k = [0, min(1, max((c[1] - 1) // 2, 0)), max((c[2] - 1) // 2, 0)]
    for i, ci in enumerate(c):
        y[i, ci:] = float("inf")
    as_i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    return y, as_i32(k), as_i32(c)


def check_trimmed(torch, ops, ref, checks, n, d, case, gen):
    """The trimmed-mean kernel on one set of operands against its plain
    versions: the default variant against the sort formula up to
    ``TRIM_FORMULA_MAX_N`` rows (the kernel sums the band in row order, the
    formula in sorted order: the weights' tolerance, as the JAX tests hold
    it), and every variant that takes n, forced, against the row-order
    plain version bit for bit."""
    y, k, c = trimmed_inputs(torch, n, d, case, gen)
    got = ops.sweep_trimmed_aggregate(y, k, c)
    want = ref.sweep_trimmed_aggregate(y, k, c)
    rows = ref.sweep_trimmed_aggregate_rows(y, k, c)
    torch.cuda.synchronize()
    what = f"S=3 n={n} D={d} case={case} k={k.tolist()} c={c.tolist()}"
    if n <= TRIM_FORMULA_MAX_N:
        checks.close(TRIM, got, want, what, weights=True)
    if case == "degenerate" and (got[0].any() or not torch.equal(got[1], y[1, 0])):
        fail(f"{TRIM}: c = 0 must give zeros and c = 1 its row, at {what}")
    for v in ops.VARIANTS:
        if ops.MAX_ROWS[v] is not None and n > ops.MAX_ROWS[v]:
            continue
        got_v = ops.sweep_trimmed_aggregate(y, k, c, variant=v)
        if not bits_equal(torch, got_v, rows):
            bad = (got_v.view(torch.int32) != rows.view(torch.int32)).nonzero()
            fail(f"{TRIM} variant {v} != the row-order plain version, bitwise, at "
                 f"{what}: {bad.shape[0]} values, first at {bad[0].tolist()}: "
                 f"{got_v[tuple(bad[0])].item()!r} vs {rows[tuple(bad[0])].item()!r}")
        checks.bits[f"{TRIM}:{v}"] += 1
    checks.count(TRIM)


def trimmed_cost(s, n, d, band):
    """(bytes, lane instructions) the trimmed mean needs: y read once, the
    output written once, k_eff and c (8 bytes a cell); per column, a
    bitonic sorting network over n rounded up to a power of two, p stages
    of (n/2) p (p + 1) / 2 compare-exchanges at 2 instructions each (a min
    and a max), then an add for each of the ``band`` values in the band and
    a divide.  A sort bounds the work from above (a selection needs less),
    and at every shape timed the bytes decide all the same."""
    p = max(n - 1, 0).bit_length()
    exchanges = (1 << p) // 2 * p * (p + 1) // 2
    return (s * n * d * 4 + s * d * 4 + s * 8,
            s * d * (2 * exchanges + band + 1))


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


def kernel_ms(torch, fn, names, calls=200) -> float:
    """Device time of one call of ``fn``, summed over its GPU kernels (each
    name in ``names`` must match one kernel, launched once a call): each
    kernel's mean over its launches in a profiler trace of ``calls`` calls
    (the trace may drop a few records): for a kernel of a few
    microseconds, a graph replay's time is mostly the replay's own cost."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for name in names:
        hits = [e for e in prof.key_averages() if name in e.key and e.count]
        if len(hits) != 1 or hits[0].count > calls:
            fail(f"profiler: expected one {name} kernel launched at most {calls} "
                 f"times, got {[(e.key[:60], e.count) for e in hits]}")
        total += hits[0].device_time_total / hits[0].count
    return total / 1e3


def all_kernels_ms(torch, fn, calls=200) -> float:
    """Device time of one call of ``fn``, summed over every GPU kernel of a
    profiler trace of ``calls`` calls (for a library call whose kernels'
    names this script does not know)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if e.device_time_total > 0]
    if not hits:
        fail("profiler: no device time in a trace of the library call")
    launches = sum(e.count for e in hits)
    return sum(e.device_time_total for e in hits) / 1e3 / calls, launches / calls


def host_path(torch, ops, launch, n, d, gen, calls=10_000) -> dict:
    """Where ``weighted_aggregate``'s host time goes, on the card's host:
    each step of the wrapper timed alone over ``calls`` calls by the host
    clock (ns a call; the launches are not waited for), beside the whole
    wrapper, the route it replaced (the full checks, a ``Stream`` object)
    and ``torch.mv(U.T, w)``."""
    u = torch.randn((n, d), generator=gen, device="cuda")
    w = torch.rand((n,), generator=gen, device="cuda")
    out = torch.empty((d,), device="cuda")
    entry = ops._WAGG
    fn = entry.bind()
    ptrs = (w.data_ptr(), u.data_ptr(), out.data_ptr(), n, d)
    index = u.device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    steps = {
        "whole wrapper": lambda: ops.weighted_aggregate(w, u),
        "signature": lambda: launch.signature((w, u)),
        "memoised plan (signature + lookup)": lambda: ops._plan_weighted((w, u)),
        "full checks (the first call's route)": lambda: ops._plan_weighted.check(w, u),
        "torch.empty": lambda: torch.empty((d,), dtype=torch.float32, device=u.device),
        "new_empty": lambda: u.new_empty((d,)),
        "current device": lambda: torch._C._cuda_getDevice(),
        "raw current stream": lambda: torch._C._cuda_getCurrentRawStream(index),
        "Stream object's pointer (the old route)":
            lambda: torch.cuda.current_stream().cuda_stream,
        "data pointers": lambda: (w.data_ptr(), u.data_ptr(), out.data_ptr()),
        "C call (ctypes, argtypes)": lambda: fn(*ptrs, stream),
        "launch() (device, stream, C call, count)":
            lambda: launch.launch("host path probe", entry, index, ptrs),
        "torch.mv(U.T, w)": lambda: torch.mv(u.t(), w),
    }
    res = {}
    for name, step in steps.items():
        for _ in range(100):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            step()
        res[name] = (time.perf_counter_ns() - t0) / calls
        torch.cuda.synchronize()
    from repro_torch.kernels import LAUNCHES
    LAUNCHES.pop("host path probe", None)
    return res


def launch_floor(torch, lib) -> dict:
    """One launch of one empty block (``saa_empty``) through the same ctypes
    route as the kernels: events, graph replay and profiler — the least a
    one-launch kernel can take."""
    fn = lib.saa_empty
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    call = lambda: fn(torch.cuda.current_stream().cuda_stream)
    if call():
        fail("saa_empty did not launch")
    return {"ms": time_ms(torch, call, 500), "device_ms": graph_ms(torch, call),
            "kernel_ms": kernel_ms(torch, call, ("saa_empty_kernel(",))}


# saa_cluster's phases, between its stamps 0..8 (csrc/staleness_agg.cu)
PHASES = ("U staged", "fresh count", "partials", "cluster barrier",
          "partials gathered", "weights", "apply", "exit barrier")


def cluster_phases(torch, gen, shapes, calls=50) -> dict:
    """Where ``saa_cluster``'s time goes at each (n, D) (S = 1, the apply):
    a copy of the library built with ``-DSAA_PHASE_STAMPS`` records the
    device clock at each phase boundary.  Per phase, the median over
    ``calls`` calls of the time from the last block reaching its start to
    the last block reaching its end; ``total`` from the first block's entry
    to the last block's exit."""
    from repro_torch.kernels import _build
    out = OUT.parent / "libstaleness_agg_stamped.so"
    OUT.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DSAA_PHASE_STAMPS",
                    "-o", str(out), str(_build.SOURCES["staleness_agg"])],
                   check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    fn = lib.saa_cluster_fused_apply
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stamps = (ctypes.c_ulonglong * (8 * (len(PHASES) + 1)))()
    res = {}
    for n, d in shapes:
        params, u, fresh, tau, valid, scal = saa_inputs(torch, 1, n, d, "mixed", gen)
        w = torch.empty((1, n), device="cuda")
        nch = d // 2048
        per = -(-nch // 8)
        blocks = -(-nch // per)
        runs = []
        for _ in range(calls):
            if fn(params.data_ptr(), u.data_ptr(), fresh.data_ptr(), tau.data_ptr(),
                  valid.data_ptr(), scal.data_ptr(), w.data_ptr(), 1, n, d, 3,
                  torch.cuda.current_stream().cuda_stream):
                fail("the stamped saa_cluster did not launch")
            torch.cuda.synchronize()
            if lib.saa_phase_stamps(stamps):
                fail("could not read saa_cluster's stamps")
            rows = [stamps[b * (len(PHASES) + 1):(b + 1) * (len(PHASES) + 1)]
                    for b in range(blocks)]
            reach = [max(r[k] for r in rows) for k in range(len(PHASES) + 1)]
            runs.append([(reach[k + 1] - reach[k]) / 1e6 for k in range(len(PHASES))]
                        + [(reach[-1] - min(r[0] for r in rows)) / 1e6])
        med = lambda xs: sorted(xs)[len(xs) // 2]
        res[f"n={n} D={d}"] = {**{ph: med([r[k] for r in runs])
                                  for k, ph in enumerate(PHASES)},
                               "total": med([r[-1] for r in runs])}
    return res


def time_variants(torch, ops, s, n, d, calls, gen) -> dict:
    """Kernel 1 (``sweep_fused_staleness_apply``) by each variant at (S, n,
    D): events (cluster, chain, chain, cluster), CUDA-graph device time
    and the profiler's device time summed over the variant's kernels.  A
    call of the cluster kernel at the large shape runs for long: there
    ``calls`` is small and events alone time it (a trace of a few calls
    may keep no record of them)."""
    params, u, fresh, tau, valid, scal = saa_inputs(torch, s, n, d, "mixed", gen)
    fns = {v: (lambda v=v: ops.sweep_fused_staleness_apply(
        params, u, fresh, tau, valid, scal, variant=v)) for v in ops.VARIANTS}
    warm = 1 if calls < 10 else 5
    ev = {v: [] for v in ops.VARIANTS}
    for v in ("cluster", "chain", "chain", "cluster"):
        ev[v].append(time_ms(torch, fns[v], calls, warmup=warm))
    long = calls < 10
    return {v: {"ms": min(ev[v]), "ms_runs": ev[v],
                "device_ms": None if long else graph_ms(torch, fns[v]),
                "kernel_ms": None if long else kernel_ms(torch, fns[v],
                                                         VARIANT_KERNELS[v])}
            for v in ops.VARIANTS}


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
    """Events (plain, kernel, kernel, plain, then library, kernel, kernel,
    library: the card's and the host's clocks drift over a call) and
    CUDA-graph device times of a kernel, its plain version and its library
    call, beside its bound from these inputs; for a library call also its
    kernels' time by the profiler, and for kernel 6 the time of its former
    route (the chain's ``saa_apply``) at the same shape."""
    k, p, lib, nf = kernel_calls(torch, ops, ref, kernel, s, n, d, gen)
    single = kernel not in (APPLY, AGG)
    shape = {"n": n, "D": d} if single else {"S": s, "n": n, "D": d}
    pr1, k1 = time_ms(torch, p, iters), time_ms(torch, k, iters)
    k2, pr2 = time_ms(torch, k, iters), time_ms(torch, p, iters)
    if lib is not None:          # the library call in turns with the kernel
        l1, k3 = time_ms(torch, lib, iters), time_ms(torch, k, iters)
        k4, l2 = time_ms(torch, k, iters), time_ms(torch, lib, iters)
    nbytes, flops = saa_cost(kernel, 1 if single else s, n, d, nf)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    res = {"shape": shape, "ms": min(k1, k2), "ms_runs": [k1, k2],
           "plain_ms": min(pr1, pr2), "plain_ms_runs": [pr1, pr2],
           "device_ms": graph_ms(torch, k), "plain_device_ms": graph_ms(torch, p),
           "bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None, "library_device_ms": None}
    if kernel in FUSED or kernel == PARTIALS:
        res["variant"] = ops.variant(1 if single else s, n, d)
    res["kernel_ms"] = kernel_ms(
        torch, k, VARIANT_KERNELS[res["variant"]] if kernel in FUSED else
        PARTIAL_KERNELS[res["variant"]] if kernel == PARTIALS else
        KERNEL_NAMES[kernel])
    if kernel == PARTIALS:       # both variants forced, events in turns
        _, u, fresh, *_ = saa_inputs(torch, 1, n, d, "mixed", gen)
        fns = {v: (lambda v=v: ops.deviation_partials(u[0], fresh[0], variant=v))
               for v in ops.VARIANTS}
        ev = {v: [] for v in ops.VARIANTS}
        for v in ("cluster", "chain", "chain", "cluster"):
            ev[v].append(time_ms(torch, fns[v], iters))
        res["by_variant"] = {v: {"ms": min(ev[v]), "ms_runs": ev[v],
                                 "device_ms": graph_ms(torch, fns[v]),
                                 "kernel_ms": kernel_ms(torch, fns[v],
                                                        PARTIAL_KERNELS[v])}
                             for v in ops.VARIANTS}
    if lib is not None:
        res.update(library_ms=min(l1, l2), library_ms_runs=[l1, l2],
                   ms_runs=[k1, k2, k3, k4], ms=min(k1, k2, k3, k4),
                   library_device_ms=graph_ms(torch, lib))
        res["library_kernel_ms"], res["library_kernels_a_call"] = all_kernels_ms(torch, lib)
    if kernel == WAGG:           # its former route: the chain's saa_apply
        _, u, fresh, tau, valid, scal = saa_inputs(torch, 1, n, d, "mixed", gen)
        chain = lambda: ops.sweep_fused_staleness_aggregate(
            u, fresh, tau, scal[:, 0].contiguous(), valid, variant="chain")
        res["saa_apply_kernel_ms"] = kernel_ms(torch, chain, ("saa_apply(",))
    return res


def time_trimmed(torch, ops, ref, n, d, iters, gen, plain=True) -> dict:
    """As ``time_kernel``, for the trimmed-mean kernel on one cell of n
    valid rows at the median's trim depth (the work does not depend on
    it): the variant the wrapper takes, and under ``variants`` every
    variant that takes n, forced (events, graph replay, the profiler's
    kernel time; the rank count's events in turns with the default's).  No
    single PyTorch call computes the band mean (a sort and a masked sum are
    two), so there is no library time.  ``plain``: time the plain version
    too."""
    y = torch.randn((1, n, d), generator=gen, device="cuda")
    k = torch.tensor([(n - 1) // 2], dtype=torch.int32, device="cuda")
    c = torch.tensor([n], dtype=torch.int32, device="cuda")
    call = lambda v=None: (lambda: ops.sweep_trimmed_aggregate(y, k, c, variant=v))
    kern, default = call(), ops.variant(n)
    nbytes, lane_ops = trimmed_cost(1, n, d, n - 2 * ((n - 1) // 2))
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = lane_ops / PEAK_FP32_LANE_OPS * 1e3
    res = {"shape": {"n": n, "D": d}, "variant": default, "bytes": nbytes,
           "lane_ops": lane_ops, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None, "library_device_ms": None, "variants": {}}
    if plain:
        pl = lambda: ref.sweep_trimmed_aggregate(y, k, c)
        pr1, k1 = time_ms(torch, pl, iters), time_ms(torch, kern, iters)
        k2, pr2 = time_ms(torch, kern, iters), time_ms(torch, pl, iters)
        res.update(ms=min(k1, k2), ms_runs=[k1, k2], plain_ms=min(pr1, pr2),
                   plain_ms_runs=[pr1, pr2], plain_device_ms=graph_ms(torch, pl))
    for v in ops.VARIANTS:
        if ops.MAX_ROWS[v] is not None and n > ops.MAX_ROWS[v]:
            continue
        fn = call(v)
        runs = [time_ms(torch, fn, iters), time_ms(torch, kern, iters),
                time_ms(torch, kern, iters), time_ms(torch, fn, iters)]
        res["variants"][v] = {"ms": min(runs[0], runs[3]), "ms_runs": [runs[0], runs[3]],
                              "default_ms_runs": runs[1:3],
                              "device_ms": graph_ms(torch, fn),
                              "kernel_ms": kernel_ms(torch, fn, TRIM_KERNELS[v])}
    if not plain:
        res["ms"] = res["variants"][default]["ms"]
    res["device_ms"] = res["variants"][default]["device_ms"]
    res["kernel_ms"] = res["variants"][default]["kernel_ms"]
    return res


# --- the model zoo's serve path: kernels 8 and 9 --------------------------


def swa_inputs(torch, b, s, h, hkv, dh, dtype, gen):
    mk = lambda heads: torch.randn((b, s, heads, dh), generator=gen,
                                   device="cuda").to(dtype)
    return mk(h), mk(hkv), mk(hkv)


def wkv_inputs(torch, b, s, h, n, dtype, with_s0, gen):
    """r, k, v (0.5 N(0, 1) in ``dtype``), w in [0.8, 0.999), u, s0 (fp32
    or None), as the JAX package's kernel test draws them."""
    mk = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    r, k, v = (0.5 * mk(b, s, h, n)).to(dtype), (0.5 * mk(b, s, h, n)).to(dtype), \
        (0.5 * mk(b, s, h, n)).to(dtype)
    w = 0.8 + 0.199 * torch.rand((b, s, h, n), generator=gen, device="cuda")
    s0 = 0.1 * mk(b, h, n, n) if with_s0 else None
    return r, k, v, w, 0.1 * mk(h, n), s0


def dtype_label(torch, dtype) -> str:
    return "fp32" if dtype == torch.float32 else "bf16"


def check_swa(torch, ops, ref, checks, b, s, h, hkv, dh, window, dtype, gen,
              bhsd=False):
    """The attention kernel against its plain version on one set of
    operands; ``bhsd`` also runs the TPU layout's entry, which must give the
    same bits (one kernel, other strides).  Returns (max abs error,
    relative L2 error)."""
    from repro_torch.kernels import LAUNCHES
    q, k, v = swa_inputs(torch, b, s, h, hkv, dh, dtype, gen)
    before = Counter(LAUNCHES)
    got = ops.swa_attention(q, k, v, window=window)
    want = ref.swa_attention_ref(q, k, v, window=window)
    torch.cuda.synchronize()
    label = dtype_label(torch, dtype)
    took = {SWA: 1, ops.KERNELS[dtype]: 1}      # bf16: wgmma; fp32: CUDA cores
    if Counter(LAUNCHES) - before != Counter(took):
        fail(f"{SWA}: launches {dict(Counter(LAUNCHES) - before)} for {label} operands, "
             f"expected {took}")
    what = f"B={b} S={s} H={h} Hkv={hkv} Dh={dh} window={window} {label}"
    checks.close(SWA, got, want, what, tol=LM_TOL[(SWA, label)])
    err, rel = (got.float() - want.float()).abs().max().item(), rel_l2(torch, got, want)
    if label == "bf16" and rel > SWA_BF16_REL_L2:
        fail(f"{SWA}: relative L2 error {rel:.3g} from its plain version at {what} "
             f"(limit {SWA_BF16_REL_L2})")
    if bhsd:
        rows = lambda t: t.transpose(1, 2).reshape(-1, s, dh)
        got2 = ops.swa_attention_bhsd(rows(q), rows(k), rows(v), window=window,
                                      n_kv_heads=hkv)
        if not torch.equal(got2, rows(got)):
            fail(f"{SWA}: the (B*H, S, Dh) entry differs from the model layout's at {what}")
    checks.count(SWA)
    return err, rel


def check_wkv(torch, ops, ref, checks, b, s, h, n, dtype, with_s0, gen):
    """The WKV6 kernel against its plain version; the state carried from a
    first call into a second equals one call bit for bit, and the
    (B*H, S, N) entry gives the same bits as the model layout's."""
    r, k, v, w, u, s0 = wkv_inputs(torch, b, s, h, n, dtype, with_s0, gen)
    y, st = ops.wkv6(r, k, v, w, u, state0=s0)
    y_r, st_r = ref.wkv6_scan(r, k, v, w, u, state0=s0)
    torch.cuda.synchronize()
    label = dtype_label(torch, dtype)
    what = f"B={b} S={s} H={h} N={n} {label} s0={with_s0}"
    checks.close(WKV, y, y_r, what, tol=LM_TOL[(WKV, label)])
    checks.close(WKV, st, st_r, what, tol=LM_TOL[(WKV, "fp32")])
    if s > 1:
        c = s // 3 or 1
        y1, s1 = ops.wkv6(r[:, :c], k[:, :c], v[:, :c], w[:, :c], u, state0=s0)
        y2, s2 = ops.wkv6(r[:, c:], k[:, c:], v[:, c:], w[:, c:], u, state0=s1)
        if not (torch.equal(torch.cat([y1, y2], dim=1), y) and torch.equal(s2, st)):
            fail(f"{WKV}: a state carried across calls differs from one call at {what}")
    rows = lambda t: t.transpose(1, 2).reshape(b * h, s, n)
    y3, s3 = ops.wkv6_bhsn(rows(r), rows(k), rows(v), rows(w),
                           u.expand(b, h, n).reshape(b * h, 1, n),
                           (torch.zeros((b, h, n, n), device="cuda") if s0 is None
                            else s0).reshape(b * h, n, n))
    if not (torch.equal(y3, rows(y)) and torch.equal(s3, st.reshape(b * h, n, n))):
        fail(f"{WKV}: the (B*H, S, N) entry differs from the model layout's at {what}")
    checks.count(WKV)


def check_lm_kernels(torch, checks, gen):
    """Kernels 8 and 9 against their plain versions on a grid of shapes and
    at the serve path's own.  Returns attention's largest errors by dtype,
    over the grid and at the path's shape."""
    from repro_torch.kernels.swa_attention import ops as swa_ops
    from repro_torch.kernels.swa_attention import ref as swa_ref
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.kernels.wkv6 import ref as wkv_ref
    dtypes = (torch.float32, torch.bfloat16)
    swa = {}

    def note(where, dt, err_rel):
        key = f"{where} {dtype_label(torch, dt)}"
        old = swa.get(key, {"max_abs": 0.0, "rel_l2": 0.0})
        swa[key] = {"max_abs": max(old["max_abs"], err_rel[0]),
                    "rel_l2": max(old["rel_l2"], err_rel[1])}
    for window in (128, 384):     # S below, at and past the window, off the tile
        for s in sorted({*SWA_EDGE_S, window - 37, window - 1, window, window + 1,
                         window + 200, 3 * window + 5}):
            for g in (1, 2, 4, 8):
                for dh in swa_ops.HEAD_DIMS:
                    for dt in dtypes:
                        note("grid", dt, check_swa(
                            torch, swa_ops, swa_ref, checks, 2, s, 8, 8 // g, dh,
                            window, dt, gen, bhsd=True))
    for s in (8000, 8192, 9000):  # the path's window: 8192 live keys a query
        for dt in dtypes:
            note("grid", dt, check_swa(torch, swa_ops, swa_ref, checks, 1, s, 4, 2,
                                       128, 8192, dt, gen, bhsd=True))
    for dt in dtypes:
        note("path", dt, check_swa(torch, swa_ops, swa_ref, checks, SWA_PATH["B"],
                                   SWA_PATH["S"], 16, 8, 128, 8192, dt, gen))
        # kimi-k2's own shape: Dh 112 on the 128-wide kernels
        note("kimi-k2 path", dt, check_swa(torch, swa_ops, swa_ref, checks,
                                           *KIMI_SWA, dt, gen))
    from repro_torch.kernels import LAUNCHES
    before = Counter(LAUNCHES)
    for dh in (32, 96, 120, 256):    # any other head dim raises on the card
        q, k, v = swa_inputs(torch, 1, 130, 2, 2, dh, torch.bfloat16, gen)
        try:
            swa_ops.swa_attention(q, k, v, window=128)
        except ValueError:
            continue
        fail(f"{SWA}: head dim {dh} on the card did not raise")
    if Counter(LAUNCHES) != before:
        fail(f"{SWA}: a refused head dim launched {dict(Counter(LAUNCHES) - before)}")
    for n in (8, 16, 32, 64):     # S around the 16-step chunk, and long
        for s in (1, 31, 33, 200, 4096):
            for with_s0 in (True, False):
                check_wkv(torch, wkv_ops, wkv_ref, checks, 2, s, 4, n,
                          torch.float32, with_s0, gen)
        check_wkv(torch, wkv_ops, wkv_ref, checks, 2, 200, 4, n, torch.bfloat16,
                  True, gen)
    check_wkv(torch, wkv_ops, wkv_ref, checks, WKV_PATH["B"], WKV_PATH["S"], 32, 64,
              torch.bfloat16, False, gen)
    for k in (SWA, WKV):
        print(f"{k} == plain version in {checks.n[k]} checks (max abs err "
              f"{checks.err[k]:.3g}, relative {checks.rel[k]:.3g}; fp32 with TF32 "
              f"off, bf16 outputs compared in fp32; tolerances {LM_TOL})")
    print(f"{SWA} largest errors (grid at head dims {swa_ops.HEAD_DIMS}, the path's "
          f"1 x {SWA_PATH['S']} x 16 heads and kimi-k2's 1 x {KIMI_SWA[1]} x "
          f"{KIMI_SWA[2]} heads at Dh {KIMI_SWA[4]}, window 8192; head dims 32, 96, "
          f"120, 256 refused): " + "; ".join(
              f"{k} max abs {v['max_abs']:.3g}, relative L2 {v['rel_l2']:.3g}"
              for k, v in swa.items())
          + f" (bf16 relative L2 limit {SWA_BF16_REL_L2})")
    return swa


def rel_l2(torch, got, want, rows=1024) -> float:
    """||got - want|| / ||want|| in fp32, over (B, S, V) in slices of S."""
    num = den = 0.0
    for i in range(0, got.shape[1], rows):
        g, w = got[:, i:i + rows].float(), want[:, i:i + rows].float()
        num += float(((g - w) ** 2).sum())
        den += float((w ** 2).sum())
    return (num / den) ** 0.5


def serve_helpers(torch, out):
    """The serve phases' shared steps, recording into ``out`` ("launches",
    "steps"): ``step`` (a synchronized, timed call with launch counters
    zeroed just before it and held to an exact count after it), ``finite``,
    ``fp32`` (a model's fp32 twin), ``batch_of`` (a batch of tokens, after
    patch embeddings for a vision config), ``versus_plain`` and
    ``identity`` (full-model logits gates), ``requests`` (B = 4 greedy requests through
    ``serve_model.serve``, timed warm and profiled) and ``profile``."""
    import dataclasses
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import decode_step, init_decode_state, prefill
    from repro_torch.models.transformer import load_prefill, tree_map
    from repro_torch.serve_model import serve


    def step(name, fn, want, record=True):
        LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = dict(LAUNCHES)
        if got != want:
            fail(f"{name}: launches {got}, expected {want}")
        if record:
            out["launches"].update(got)
            out["steps"][name] = {"launches": got, "seconds": secs}
            print(f"{name}: launches {got} in {secs:.3f}s")
        return res, secs

    def finite(name, t):
        if not torch.isfinite(t).all():
            fail(f"{name}: non-finite logits")

    def fp32(cfg, params):
        return (dataclasses.replace(cfg, param_dtype=torch.float32),
                tree_map(lambda t: t.float() if t.is_floating_point() else t, params))

    def batch_of(cfg, gen, b, s):
        """(b, s) positions: tokens, after ``n_frontend_tokens`` random patch
        embeddings for a vision config."""
        n_front = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s - n_front),
                                         generator=gen, device="cuda", dtype=torch.int32)}
        if n_front:
            batch["frontend_embeds"] = torch.randn((b, n_front, cfg.d_frontend),
                                                   generator=gen, device="cuda")
        return batch

    def versus_plain(name, cfg, weights, logits_of, extra=None):
        """The kernel path's logits against the plain versions' on the same
        weights: ``weights(c)`` makes them in ``c.param_dtype`` (the same
        values, up to rounding, in bf16 and fp32), ``logits_of(c, p)`` gives
        the logits.  fp32: relative L2 within FP32_REL_L2.  bf16: the kernel
        path's distance from the fp32 model (the plain versions in fp32)
        within BF16_DRIFT of the plain versions' own bf16 distance.
        ``extra(c32, p32)`` runs on the fp32 weights and its dict joins the
        result.  Comparison runs: launches not counted."""
        plain = lambda c, p: logits_of(dataclasses.replace(c, use_kernels=False), p)
        agree = lambda a, b: float((a.argmax(-1) == b.argmax(-1)).float().mean())
        c32 = dataclasses.replace(cfg, param_dtype=torch.float32)
        p32 = weights(c32)
        res = {"params": sum(t.numel() for t in _leaves(p32))}
        with torch.inference_mode():
            ref, got = plain(c32, p32), logits_of(c32, p32)
        finite(f"{name} fp32", got)
        res.update(fp32=rel_l2(torch, got, ref), fp32_argmax_agreement=agree(got, ref))
        if extra is not None:
            res.update(extra(c32, p32))
        del got, p32
        torch.cuda.empty_cache()
        p = weights(cfg)
        with torch.inference_mode():
            got, want = logits_of(cfg, p), plain(cfg, p)
        del p
        finite(f"{name} bf16", got)
        res.update(bf16=rel_l2(torch, got, want), bf16_argmax_agreement=agree(got, want),
                   bf16_kernel_vs_fp32=rel_l2(torch, got, ref),
                   bf16_plain_vs_fp32=rel_l2(torch, want, ref))
        del got, want, ref
        torch.cuda.empty_cache()
        ratio, margin = BF16_DRIFT
        res["bf16_limit"] = ratio * res["bf16_plain_vs_fp32"] + margin
        if res["fp32"] > FP32_REL_L2:
            fail(f"{name}: kernel path vs plain versions, fp32 logits relative L2 "
                 f"{res['fp32']:.3g} (limit {FP32_REL_L2})")
        if res["bf16_kernel_vs_fp32"] > res["bf16_limit"]:
            fail(f"{name}: bf16 kernel path's logits are further from the fp32 model "
                 f"than the plain versions' bf16 run: {res}")
        print(f"{name} ({cfg.n_layers} layers, {res['params'] / 1e9:.2f} B params): "
              f"logits of the kernel path vs the plain versions, relative L2 "
              f"{res['fp32']:.3g} in fp32 (argmax agreement "
              f"{res['fp32_argmax_agreement']:.4f}), {res['bf16']:.3g} in bf16 "
              f"({res['bf16_argmax_agreement']:.4f}); bf16 vs the fp32 model: kernel "
              f"path {res['bf16_kernel_vs_fp32']:.4g}, plain versions "
              f"{res['bf16_plain_vs_fp32']:.4g} (limit {res['bf16_limit']:.4g})")
        return res

    def identity(name, cfg, params, gen, n=64):
        """Prefill's last logits == the same ``n``-token prompt fed through
        decode, in fp32 at full width: relative L2 within FP32_REL_L2,
        beside the kernel path's distance from the plain versions on the
        same prompt (the model's own fp32 noise: prefill and decode run
        their matrix products at other shapes).  An MoE config runs
        one-token groups, as a decode step's (a prefill's larger groups
        drop slots past an expert's capacity).  A vision config prefills
        its patches and the prompt but its last token, loads those states
        into a decode state (``load_prefill``) and decodes the last token.
        Returns (result, the decode steps' logits)."""
        c, p = fp32(cfg, params)
        if c.moe:
            c = dataclasses.replace(c, moe_group_size=1)
        b, n_front = 2, c.n_frontend_tokens if c.frontend == "vision" else 0
        batch = batch_of(c, gen, b, n_front + n)
        toks = batch["tokens"]
        at = lambda t: torch.full((b,), t, dtype=torch.int32, device="cuda")
        with torch.inference_mode():
            lp, _ = prefill(c, p, batch)
            lplain, _ = prefill(dataclasses.replace(c, use_kernels=False), p, batch)
            if n_front:
                _, sh = prefill(c, p, dict(batch, tokens=toks[:, :-1]))
                st = load_prefill(init_decode_state(dataclasses.replace(c, window=None), b,
                                                    n_front + n, "cuda"), sh)
                ld, _ = decode_step(c, p, st, toks[:, -1], at(n_front + n - 1))
                steps = ld[:, None]
            else:
                st, lds = init_decode_state(c, b, n + 1, "cuda"), []
                for t in range(n):
                    ld, st = decode_step(c, p, st, toks[:, t], at(t))
                    lds.append(ld)
                steps = torch.stack(lds, dim=1)
        res = {"rel_l2": rel_l2(torch, ld[:, None], lp),
               "max_abs": (ld - lp[:, 0]).abs().max().item(),
               "kernel_vs_plain_rel_l2": rel_l2(torch, lp, lplain)}
        if res["rel_l2"] > FP32_REL_L2:
            fail(f"{name}: prefill != decode after a {n}-token prompt (fp32): {res}")
        print(f"{name}: prefill == decode after a {n}-token prompt, fp32, full width, "
              f"{c.n_layers} layers: relative L2 {res['rel_l2']:.3g} (max abs "
              f"{res['max_abs']:.3g}; kernel vs plain prefill "
              f"{res['kernel_vs_plain_rel_l2']:.3g})")
        return res, steps

    def requests(name, cfg, params, gen, want):
        b, p, n = REQUESTS["B"], REQUESTS["prompt"], REQUESTS["gen"]
        prompt = torch.randint(0, cfg.vocab_size, (b, p), generator=gen, device="cuda",
                               dtype=torch.int32)
        with torch.inference_mode():
            (toks, logits, _), _ = step(f"{name} requests", lambda: serve(
                cfg, params, prompt, n), want)
            (toks2, _, _), secs = step(f"{name} requests (warm)", lambda: serve(
                cfg, params, prompt, n), want, record=False)
        finite(f"{name} requests", logits)
        if toks.shape != (b, n + 1) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
            fail(f"{name} requests: tokens {tuple(toks.shape)} out of range")
        if not torch.equal(toks, toks2):
            fail(f"{name} requests: a second run generated other tokens")
        pp, pg = PROFILE_REQUESTS["prompt"], PROFILE_REQUESTS["gen"]
        prof = profile(f"{name} requests ({pp} + {pg} tokens)",
                       lambda: serve(cfg, params, prompt[:, :pp], pg))
        print(f"{name} requests: {b * (p + n) / secs:.1f} tokens/s ({b} x {p} prompt "
              f"+ {n} generated, warm)")
        return {"decode_tokens_per_s": b * (p + n) / secs, "decode_seconds": secs,
                "decode_profile": prof, "sample": toks[0, :16].tolist()}

    def profile(name, run, compare_readers=False):
        with torch.inference_mode():
            prof = profile_campaign(torch, run, compare_readers)
        idle = prof["device_idle_share"]
        print(f"{name} profile: {prof['gpu_kernels']} GPU kernels, device busy "
              f"{prof['device_busy_ms']:.1f} of {prof['wall_ms']:.1f} ms (idle share "
              f"{'not measured' if idle is None else f'{idle:.3f}'}); top: " + ", ".join(
                  f"{k[:40]} {v:.1f}" for k, v in list(prof["top_kernels_ms"].items())[:3]))
        return prof

    return types.SimpleNamespace(step=step, finite=finite, fp32=fp32, batch_of=batch_of,
                                 versus_plain=versus_plain, identity=identity,
                                 requests=requests, profile=profile)


def serve_paths(torch) -> dict:
    """The serve path at full width in bf16, weights from a seeded
    ``torch.Generator`` on the card: internlm2-1.8b+swa prefill and
    full-sequence logits on 16,384 tokens, rwkv6-1.6b prefill on 8 x 4,096,
    and requests through ``greedy_generate`` for each; launch counters
    zeroed before each step and read after it.  Held: exact launch counts,
    finite logits, the kernel path's logits against the plain versions'
    on the same weights (fp32, relative L2; bf16, each one's distance from
    the fp32 model), prefill == decode after a short prompt (fp32, full
    width, relative L2), and the reduced configs of all ten architectures
    on the card against the CPU."""
    import dataclasses
    from repro_torch.configs import (ARCH_IDS, adapt_for_shape, get_config, get_reduced,
                                     shape_for)
    from repro_torch.kernels.swa_attention.ops import KERNELS
    from repro_torch.launch.serve import make_decode_step, make_logits_fn, make_prefill_step
    from repro_torch.models import init_decode_state, init_params
    from repro_torch.models.transformer import tree_map

    out = {"launches": Counter(), "steps": {}, "models": {}}
    h = serve_helpers(torch, out)
    step, finite, fp32, versus_plain, identity, requests, profile = (
        h.step, h.finite, h.fp32, h.versus_plain, h.identity, h.requests, h.profile)
    gen = torch.Generator(device="cuda").manual_seed(0)
    # internlm2-1.8b with the repo's sliding-window adaptation (long_500k)
    cfg = dataclasses.replace(adapt_for_shape(get_config("internlm2-1.8b"),
                                              shape_for("long_500k")), use_kernels=True)
    if cfg.window != 8192 or cfg.arch_id != "internlm2-1.8b+swa":
        fail(f"unexpected config {cfg.arch_id} window {cfg.window}")
    params = init_params(cfg, gen)
    n_params = sum(t.numel() for t in _leaves(params))
    b, s = SWA_PATH["B"], SWA_PATH["S"]
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                     device="cuda", dtype=torch.int32)}
    pre = make_prefill_step(cfg)
    swa_24 = {SWA: 24, KERNELS[torch.bfloat16]: 24}     # all on the tensor-core kernel
    (lp, states), _ = step(f"{cfg.arch_id} prefill", lambda: pre(params, batch), swa_24)
    _, t_pre = step(f"{cfg.arch_id} prefill (warm)", lambda: pre(params, batch), swa_24,
                    record=False)
    finite("internlm2 prefill", lp)
    print(f"{cfg.arch_id} prefill: {b * s / t_pre:.0f} tokens/s (warm)")
    prof_pre = profile(f"{cfg.arch_id} prefill", lambda: pre(params, batch),
                       compare_readers=True)
    if lp.shape != (b, 1, cfg.vocab_size) or states["stack"]["sub0"]["k"].shape != \
            (24, b, s, cfg.n_kv_heads, cfg.head_dim):
        fail(f"internlm2 prefill: shapes {tuple(lp.shape)}")
    del states
    la, _ = step(f"{cfg.arch_id} logits", lambda: make_logits_fn(cfg)(params, batch),
                 swa_24)
    finite("internlm2 logits", la)
    rel_last = rel_l2(torch, lp, la[:, -1:])
    if rel_last > LOGIT_REL_L2:
        fail(f"internlm2: prefill's last logits vs the logits' last row, relative L2 "
             f"{rel_last:.3g} (limit {LOGIT_REL_L2})")
    del la, lp
    torch.cuda.empty_cache()
    vs = versus_plain("internlm2", cfg, lambda c: fp32(c, params)[1] if
                      c.param_dtype == torch.float32 else params,
                      lambda c, p: make_logits_fn(c)(p, batch))
    out["models"][cfg.arch_id] = {
        "params": n_params, "prefill_shape": [b, s],
        "prefill_seconds": t_pre, "prefill_tokens_per_s": b * s / t_pre,
        "prefill_profile": prof_pre, "prefill_vs_logits_rel_l2": rel_last,
        "logits_vs_plain_rel_l2": vs,
        "prefill_eq_decode": identity("internlm2", cfg, params, gen)[0],
        **requests(cfg.arch_id, cfg, params, gen, {})}
    del params
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config("rwkv6-1.6b"), use_kernels=True)
    params = init_params(cfg, gen)
    n_params = sum(t.numel() for t in _leaves(params))
    b, s = WKV_PATH["B"], WKV_PATH["S"]
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                     device="cuda", dtype=torch.int32)}
    pre = make_prefill_step(cfg)
    (lp, states), _ = step(f"{cfg.arch_id} prefill", lambda: pre(params, batch), {WKV: 24})
    _, t_pre = step(f"{cfg.arch_id} prefill (warm)", lambda: pre(params, batch),
                    {WKV: 24}, record=False)
    finite("rwkv6 prefill", lp)
    del lp, states
    print(f"{cfg.arch_id} prefill: {b * s / t_pre:.0f} tokens/s (warm)")
    prof_pre = profile(f"{cfg.arch_id} prefill", lambda: pre(params, batch))
    short = {"tokens": batch["tokens"][:, :WKV_PLAIN_S]}
    vs = versus_plain("rwkv6", cfg, lambda c: fp32(c, params)[1] if
                      c.param_dtype == torch.float32 else params,
                      lambda c, p: make_prefill_step(c)(p, short)[0])
    out["models"][cfg.arch_id] = {
        "params": n_params, "prefill_shape": [b, s],
        "prefill_seconds": t_pre, "prefill_tokens_per_s": b * s / t_pre,
        "prefill_profile": prof_pre,
        "logits_vs_plain_rel_l2": dict(vs, shape=[b, WKV_PLAIN_S]),
        "prefill_eq_decode": identity("rwkv6", cfg, params, gen)[0],
        **requests(cfg.arch_id, cfg, params, gen,
                   {WKV: 24 * (REQUESTS["prompt"] + REQUESTS["gen"])})}
    del params
    torch.cuda.empty_cache()

    # the reduced configs of all ten architectures in fp32, a 128-token
    # window wherever there is attention: the card against the CPU
    out["reduced_gpu_vs_cpu_max_abs"] = {}
    for arch in ARCH_IDS:
        cfg = get_reduced(arch)
        over = dict(window=128) if "attn" in cfg.block_pattern else {}
        cfg = dataclasses.replace(cfg, param_dtype=torch.float32, use_kernels=True, **over)
        p_cpu = init_params(cfg, torch.Generator().manual_seed(0))
        cpu_gen = torch.Generator().manual_seed(1)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 200), generator=cpu_gen,
                                         dtype=torch.int32)}
        if cfg.frontend == "vision":
            batch["frontend_embeds"] = torch.randn(
                (2, cfg.n_frontend_tokens, cfg.d_frontend), generator=cpu_gen)
        toks = batch["tokens"]
        res = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(dev), p_cpu)
            bt = {k: v.to(dev) for k, v in batch.items()}
            lp, st = make_prefill_step(cfg)(p, bt)
            la = make_logits_fn(cfg)(p, bt)
            state, dec = init_decode_state(cfg, 2, 9, dev), make_decode_step(cfg)
            lds = []
            for t in range(8):
                ld, state = dec(p, state, toks[:, t].to(dev),
                                torch.full((2,), t, dtype=torch.int32, device=dev))
                lds.append(ld)
            res[dev] = [lp, la, torch.stack(lds)] + list(_leaves(st))
        err = 0.0
        for g, c in zip(res["cuda"], res["cpu"]):
            g = g.cpu()
            err = max(err, (g.float() - c.float()).abs().max().item())
            if not torch.allclose(g.float(), c.float(), rtol=1e-3, atol=1e-4):
                fail(f"reduced {arch}: the card differs from the CPU by {err}")
        out["reduced_gpu_vs_cpu_max_abs"][arch] = err
    print(f"reduced configs of all {len(ARCH_IDS)} architectures, fp32, card == CPU "
          f"(prefill, logits, 8 decode steps, states): max abs diff "
          f"{out['reduced_gpu_vs_cpu_max_abs']}")
    return out


def arch_paths(torch) -> dict:
    """The zoo's other eight architectures served at full width in bf16
    with ``use_kernels=True`` under ``adapt_for_shape(..., long_500k)``
    (window 8192), one model at a time, weights from a seeded
    ``torch.Generator`` on the card, depth cut only where the card cannot
    hold the weights (``ARCH_PATHS``).  Each: a prefill of 1 x 16,384
    tokens (internvl2: 256 random patch embeddings + 16,128 tokens), cold
    and warm, profiled, with exactly ``ARCH_PATHS``' kernel 8 launches, all
    on the tensor-core kernel; B = 4 requests through ``serve`` (deepseek's
    with absorbed MLA).  Then at ``ARCH_PLAIN_CUT``'s depth, full
    width, the kernel path's logits of the last ``ARCH_LOGIT_ROWS``
    positions against the plain versions' on the same seeded weights:
    fp32 (relative L2 <= FP32_REL_L2) and bf16 (no further from the fp32
    model than BF16_DRIFT allows); on those fp32 weights, prefill == decode after a 64-token prompt for MLA naive and absorbed,
    Mamba and the vision prefix, and absorbed == naive decode."""
    import dataclasses
    from repro_torch.configs import SWA_WINDOW, adapt_for_shape, get_config, shape_for
    from repro_torch.kernels.swa_attention.ops import KERNELS
    from repro_torch.launch.serve import make_prefill_step
    from repro_torch.models import forward, init_params
    from repro_torch.models.transformer import _logits

    out = {"launches": Counter(), "steps": {}, "models": {}}
    h = serve_helpers(torch, out)
    t_phase = time.perf_counter()

    def gqa_layers(cfg):
        prefix, specs, n_rep = cfg.segment_plan()
        if cfg.attn_type != "gqa":
            return 0
        return (sum(m == "attn" for m, _ in prefix)
                + n_rep * sum(m == "attn" for m, _ in specs))

    def identities(arch, c, p):
        """The new mixers' prefill == decode on fp32 weights at full width."""
        gen = torch.Generator(device="cuda").manual_seed(7)
        if c.attn_type == "mla":
            naive, steps_n = h.identity(f"{arch} MLA naive", dataclasses.replace(
                c, mla_absorb=False), p, torch.Generator(device="cuda").manual_seed(7))
            absorbed, steps_a = h.identity(f"{arch} MLA absorbed", dataclasses.replace(
                c, mla_absorb=True), p, torch.Generator(device="cuda").manual_seed(7))
            gap = {"rel_l2": rel_l2(torch, steps_a, steps_n),
                   "max_abs": (steps_a - steps_n).abs().max().item()}
            if not torch.allclose(steps_a, steps_n, rtol=MLA_ABSORB_TOL, atol=MLA_ABSORB_TOL):
                fail(f"{arch}: absorbed MLA decode differs from naive: {gap}")
            print(f"{arch}: absorbed == naive MLA decode over 64 steps, fp32, relative L2 "
                  f"{gap['rel_l2']:.3g}, max abs {gap['max_abs']:.3g} (rtol = atol "
                  f"{MLA_ABSORB_TOL})")
            return {"prefill_eq_decode": {"naive": naive, "absorbed": absorbed},
                    "absorbed_vs_naive": gap}
        if "mamba" in c.block_pattern:
            return {"prefill_eq_decode": h.identity(f"{arch} Mamba", c, p, gen)[0]}
        if c.frontend == "vision":
            return {"prefill_eq_decode": h.identity(f"{arch} vision prefix", c, p, gen)[0]}
        return {}

    def plain_share(cfg, params, t_pre):
        """The share of the warm prefill that the parts with no kernel take,
        by events at the prefill's shape: Mamba's scan (its fp32 inputs
        drawn at random) over the Mamba layers, MLA's blocked attention
        over the MLA layers; None for the other configs."""
        from repro_torch.models import attention as attn
        from repro_torch.models import mamba as mb
        prefix, specs, n_rep = cfg.segment_plan()
        count = lambda m: sum(x == m for x, _ in prefix) + n_rep * sum(x == m for x, _ in specs)
        g = torch.Generator(device="cuda").manual_seed(3)
        with torch.inference_mode():
            if "mamba" in cfg.block_pattern:
                d_inner, n = cfg.mamba_expand * cfg.d_model, cfg.mamba_d_state
                i = [m for m, _ in specs].index("mamba")
                A = -torch.exp(params["stack"][f"sub{i}"]["mixer"]["A_log"][0])
                x = torch.randn((1, ARCH_S, d_inner), generator=g, device="cuda")
                dt = torch.nn.functional.softplus(torch.randn(
                    (1, ARCH_S, d_inner), generator=g, device="cuda") - 4)
                bm, cm = (torch.randn((1, ARCH_S, n), generator=g, device="cuda")
                          for _ in range(2))
                h0 = torch.zeros((1, d_inner, n), device="cuda")
                part, layers = "Mamba scan", count("mamba")
                ms = time_ms(torch, lambda: mb._scan(x, dt, bm, cm, A, h0), 2, warmup=1)
            elif cfg.attn_type == "mla":
                mk = lambda d: torch.randn((1, ARCH_S, cfg.n_heads, d), generator=g,
                                           device="cuda").to(cfg.param_dtype)
                dk = cfg.qk_nope_dim + cfg.qk_rope_dim
                q, k, v = mk(dk)[:, :, :, None], mk(dk), mk(cfg.v_head_dim)
                pos = torch.arange(ARCH_S, device="cuda", dtype=torch.int32)[None]
                part, layers = "MLA blocked attention", count("attn")
                ms = time_ms(torch, lambda: attn.blocked_attention(
                    q, k, v, pos, pos, window=cfg.window, softmax_scale=dk ** -0.5), 2,
                    warmup=1)
            else:
                return None
        res = {"part": part, "ms_a_layer": ms, "layers": layers,
               "share": layers * ms / (t_pre * 1e3)}
        print(f"{cfg.arch_id}: {part} {ms:.1f} ms a layer (events, 1 x {ARCH_S}), "
              f"x {layers} layers = {res['share']:.3f} of the warm prefill")
        return res

    for i, (arch, (layers, want_launches)) in enumerate(ARCH_PATHS.items()):
        t_model = time.perf_counter()
        cfg = adapt_for_shape(get_config(arch), shape_for("long_500k"))
        full_layers = cfg.n_layers
        cfg = dataclasses.replace(cfg, use_kernels=True, n_layers=layers or full_layers)
        if cfg.window != SWA_WINDOW or not cfg.arch_id.endswith("+swa"):
            fail(f"{arch}: unexpected config {cfg.arch_id} window {cfg.window}")
        if gqa_layers(cfg) != want_launches:
            fail(f"{arch}: {gqa_layers(cfg)} GQA layers, the table says {want_launches}")
        seed = 100 + i
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = init_params(cfg, gen)
        n_params = sum(t.numel() for t in _leaves(params))
        batch = h.batch_of(cfg, gen, 1, ARCH_S)
        pre = make_prefill_step(cfg)
        want = ({SWA: want_launches, KERNELS[torch.bfloat16]: want_launches}
                if want_launches else {})
        cut = "" if cfg.n_layers == full_layers else \
            f", depth cut to {cfg.n_layers} of {full_layers} layers"
        print(f"{cfg.arch_id}: {n_params / 1e9:.2f} B params ({2 * n_params / 1e9:.1f} GB "
              f"bf16){cut}; Dh {cfg.head_dim if cfg.attn_type == 'gqa' else 'MLA'}")
        (lp, states), t_cold = h.step(f"{cfg.arch_id} prefill", lambda: pre(params, batch), want)
        del states
        _, t_pre = h.step(f"{cfg.arch_id} prefill (warm)", lambda: pre(params, batch), want,
                          record=False)
        h.finite(f"{arch} prefill", lp)
        if lp.shape != (1, 1, cfg.vocab_size):
            fail(f"{arch} prefill: logits {tuple(lp.shape)}")
        del lp
        print(f"{cfg.arch_id} prefill: {ARCH_S / t_pre:.0f} tokens/s (warm)")
        prof = h.profile(f"{cfg.arch_id} prefill", lambda: pre(params, batch))
        share = plain_share(cfg, params, t_pre)
        res = {"params": n_params, "layers": cfg.n_layers, "layers_published": full_layers,
               "prefill_shape": [1, ARCH_S], "kernel8_launches": want_launches,
               "prefill_seconds": t_pre, "prefill_cold_seconds": t_cold,
               "prefill_tokens_per_s": ARCH_S / t_pre, "prefill_profile": prof,
               "plain_part_share": share,
               **h.requests(cfg.arch_id, cfg, params, gen, {})}
        del params
        torch.cuda.empty_cache()
        # the kernel path against the plain versions at ARCH_PLAIN_CUT's
        # depth, each run on weights drawn anew from the model's seed (an
        # fp32 draw cast to bf16 is the bf16 draw), on the last rows' logits
        rows = lambda c, p: _logits(c, p, forward(c, p, batch)[0][:, -ARCH_LOGIT_ROWS:]
                                    )[..., :c.vocab_size]     # not the padded rows' -1e30
        res["logits_vs_plain"] = dict(h.versus_plain(
            arch, dataclasses.replace(cfg, **ARCH_PLAIN_CUT.get(arch, dict(n_layers=2))),
            lambda c: init_params(c, torch.Generator(device="cuda").manual_seed(seed)),
            rows, extra=lambda c, p: identities(arch, c, p)),
            cut=ARCH_PLAIN_CUT.get(arch, dict(n_layers=2)), rows=ARCH_LOGIT_ROWS)
        res["seconds"] = time.perf_counter() - t_model
        out["models"][cfg.arch_id] = res
        print(f"{cfg.arch_id}: {res['seconds']:.1f}s")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"architectures phase: {out['seconds']:.1f}s")
    return out


def train_paths(torch):
    """The pod FL train step (``repro_torch.launch.train``) training
    internlm2-1.8b at full width as the reference's dryrun lowers it for
    training (``adapt_for_shape(..., train_4k)``: bf16 params, ``loss_chunk``
    1,024, ``remat``), weights from a seeded ``torch.Generator``, a cohort of
    ``TRAIN_P`` participants (the last stale at tau ``TRAIN_TAU``) with a
    local batch of 1 x 4,096 tokens each from ``federated_token_shards``,
    one local step, rule relay.  Runs: the vmap cohort once warm (the
    aggregate step, its deltas kept) and ``TRAIN_TIMED`` times timed (the
    FedAvg step), the stream cohort once, a YoGi step on the stream cohort;
    each with the launch counters zeroed just before it and none launched
    (the path runs no kernel: kernels 8 and 9 are forward-only).  Gates:
    (a) loss finite, params changed, weights summing to 1, the fresh ones
    equal; (b) vmap == stream within the reference test's bounds; (c) the
    vmap weights and aggregate recomputed in fp64 from its own deltas, leaf
    by leaf on the card; (d) a ``TRAIN_REMAT_LAYERS``-layer cut at full
    width, one local step with remat on and off: the same bits, less peak
    memory with it; (e) REDUCED internlm2 in fp32, card == the host's CPU
    for a vmap and a YoGi step within the CPU tests' bounds; (f) on the
    card ``lm_loss`` through kernel 8 (window 128) and kernel 9 (rwkv6)
    raises under autograd and launches nothing, and still launches under
    no_grad; (g) ``python -m repro_torch.launch.train --rounds 10`` exits 0
    and prints ``done``.  Reports round seconds, training tokens/s, model
    FLOP/s (6 N tokens) and their share of the card's dense bf16 peak and
    peak memory, and the blocked attention's share of a vmap round.
    Returns (its report, ``profile_train``: a profile of one vmap round,
    run with the script's other profiles)."""
    import dataclasses
    import os

    import numpy as np

    from repro_torch.configs import adapt_for_shape, get_config, get_reduced, shape_for
    from repro_torch.core.aggregation import tree_leaves, yogi_init
    from repro_torch.data.synthetic import federated_token_shards
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch import train as tr
    from repro_torch.models import attention as attn
    from repro_torch.models import init_params, lm_loss
    from repro_torch.models.transformer import tree_map

    out = {"launches": Counter(), "runs": {}, "gates": {}}
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = adapt_for_shape(get_config(TRAIN_ARCH), shape_for("train_4k"))
    if (cfg.param_dtype, cfg.loss_chunk, cfg.remat, cfg.use_kernels) != (
            torch.bfloat16, 1024, True, False):
        fail(f"train: unexpected config {cfg}")
    P, (B, S) = TRAIN_P, TRAIN_BATCH
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(300))
    n_params = sum(t.numel() for t in tree_leaves(params))
    shards = federated_token_shards(cfg.vocab_size, P, B, S, skew=0.3)
    batch = {k: torch.from_numpy(np.stack([sh[k] for sh in shards])).cuda()
             for k in ("tokens", "labels")}
    fresh = torch.arange(P, device="cuda") < P - 1
    tau = torch.where(fresh, 0, TRAIN_TAU).to(torch.int32)
    tokens = P * B * S
    out.update(config=dict(arch=cfg.arch_id, params=n_params, participants=P,
                           local_batch=[B, S], fresh=fresh.tolist(), tau=tau.tolist(),
                           loss_chunk=cfg.loss_chunk, remat=cfg.remat, rule="relay",
                           local_steps=1))
    print(f"train: {cfg.arch_id} (train_4k: bf16, loss_chunk {cfg.loss_chunk}, remat), "
          f"{n_params / 1e9:.3f} B params ({2 * n_params / 1e9:.2f} GB bf16, "
          f"{4 * n_params / 1e9:.2f} GB a fp32 delta); P = {P} ({P - 1} fresh, 1 stale "
          f"at tau {TRAIN_TAU}), {B} x {S} tokens each, one local step")

    def run(name, fn, rounds=1, n_tokens=tokens, n=n_params):
        """``fn()`` ``rounds`` times, synchronized, launch counters zeroed
        just before; the last result.  Its record (``out["runs"][name]``)
        counts ``n_tokens`` training tokens a round of an ``n``-param model."""
        LAUNCHES.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(rounds):
            res = fn()
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t0) / rounds
        if LAUNCHES:
            fail(f"train {name}: launched {dict(LAUNCHES)}; the train path runs no "
                 "kernel (kernels 8 and 9 are forward-only)")
        model_flops = 6 * n * n_tokens
        rec = {"round_s": secs, "rounds": rounds, "tokens_per_s": n_tokens / secs,
               "model_flops_per_s": model_flops / secs,
               "bf16_peak_share": model_flops / secs / BF16_DENSE_PEAK,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        out["runs"][name] = rec
        print(f"train {name}: {secs:.3f} s a round ({rounds} timed), {rec['tokens_per_s']:.0f} "
              f"training tokens/s, model FLOP/s {rec['model_flops_per_s'] / 1e12:.1f} T "
              f"(6 N tokens; {rec['bf16_peak_share']:.4f} of the dense bf16 peak), peak "
              f"memory {rec['peak_gb']:.2f} GB; no kernel launched")
        return res

    def changed(new, old):
        n = sum(int((a != b).sum()) for a, b in zip(tree_leaves(new), tree_leaves(old)))
        return n / n_params

    def check_round(name, new, m):
        """(a): loss finite, params changed, weights sum to 1, fresh equal."""
        w = m["weights"]
        frac = changed(new, params)
        if not (torch.isfinite(m["loss"]) and frac > 0 and abs(float(w.sum()) - 1) <= 1e-4
                and bool((w[fresh] == w[0]).all())):
            fail(f"train {name}: loss {float(m['loss'])}, {frac:.3g} of params changed, "
                 f"weights {w.tolist()}")
        if not all(torch.isfinite(t).all() for t in tree_leaves(new)):
            fail(f"train {name}: non-finite params")
        out["gates"][f"a {name}"] = {"loss": float(m["loss"]), "weights": w.tolist(),
                                     "changed_share": frac}
        print(f"train {name} (a): loss {float(m['loss']):.4f}, weights "
              f"{[round(x, 6) for x in w.tolist()]} (sum {float(w.sum()):.7f}), "
              f"{frac:.4f} of params changed")

    # --- the vmap cohort: the aggregate step warm with its deltas, then the
    # FedAvg step timed on the same params and batch
    kept = {}
    agg, m_agg = run("vmap warm (aggregate step)", lambda: tr.make_fl_aggregate_step(
        cfg, cohort="vmap")(params, batch, fresh, tau, deltas_out=kept))
    # (c) the weights and aggregate recomputed in fp64 from its own deltas
    # (P, columns) slices of each leaf of ~2^26 columns, in fp64 (2 GB)
    slices = lambda leaf: (leaf.flatten(1)[:, c:c + (1 << 26)].double()
                           for c in range(0, leaf[0].numel(), 1 << 26))
    deltas = tree_leaves(kept.pop("deltas"))
    f64 = fresh.double()
    n_f = f64.sum()
    diff_sq = torch.zeros(P, dtype=torch.float64, device="cuda")
    uhat_sq = torch.zeros((), dtype=torch.float64, device="cuda")
    for d in deltas:
        for d64 in slices(d):
            h = f64 @ d64 / n_f
            diff_sq += ((d64 - h) ** 2).sum(1)
            uhat_sq += (h * h).sum()
    lam = torch.where(fresh, 0.0, diff_sq / ((n_f + 1) ** 2 * uhat_sq))
    w64 = tr._relay_weights(fresh, tau, lam, rule="relay", beta=0.35)
    num = den = 0.0
    for d, a in zip(deltas, tree_leaves(agg)):
        for d64, a64 in zip(slices(d), slices(a[None])):
            want = w64 @ d64
            num += float(((a64[0] - want) ** 2).sum())
            den += float((want ** 2).sum())
    gate_c = {"lam": lam.tolist(), "weights_fp64": w64.tolist(),
              "weights_max_abs": (m_agg["weights"].double() - w64).abs().max().item(),
              "aggregate_rel_l2": (num / den) ** 0.5}
    out["gates"]["c vmap fp64"] = gate_c
    del deltas, kept
    if gate_c["weights_max_abs"] > 1e-5 or gate_c["aggregate_rel_l2"] > 1e-5:
        fail(f"train (c): the vmap step's weights or aggregate differ from fp64: {gate_c}")
    print(f"train vmap (c): weights within {gate_c['weights_max_abs']:.3g} of fp64 from its "
          f"own deltas (Lam {[f'{x:.4g}' for x in gate_c['lam']]}), aggregate relative L2 "
          f"{gate_c['aggregate_rel_l2']:.3g}, leaf by leaf on the card")
    vstep = tr.make_fl_train_step(cfg, cohort="vmap")
    new_v, m_v = run("vmap", lambda: vstep(params, batch, fresh, tau), TRAIN_TIMED)
    check_round("vmap", new_v, m_v)
    server = tree_map(lambda p, a: (p.float() + a).to(p.dtype), params, agg)
    if not (torch.equal(m_v["weights"], m_agg["weights"]) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(new_v), tree_leaves(server)))):
        fail("train vmap: the FedAvg step != params + the aggregate step's delta, bitwise")
    del agg, server
    torch.cuda.empty_cache()
    # the blocked attention alone at the path's shape (events), in the same
    # state as the rounds: a local step runs it forward twice (remat) and
    # backward once in each layer
    G = cfg.n_heads // cfg.n_kv_heads
    g = torch.Generator(device="cuda").manual_seed(5)
    mk = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(
        cfg.param_dtype).requires_grad_()
    q, k, v = (mk(B, S, cfg.n_kv_heads, G, cfg.head_dim),
               mk(B, S, cfg.n_kv_heads, cfg.head_dim), mk(B, S, cfg.n_kv_heads, cfg.head_dim))
    pos = torch.arange(S, device="cuda", dtype=torch.int32)[None]
    fwd = lambda: attn.blocked_attention(q, k, v, pos, pos)
    t_f = time_ms(torch, fwd, 3, warmup=1)
    t_fb = time_ms(torch, lambda: torch.autograd.grad(fwd().float().square().sum(),
                                                      (q, k, v)), 3, warmup=1)
    del q, k, v
    out["attention"] = {"fwd_ms": t_f, "fwd_bwd_ms": t_fb, "share": P * cfg.n_layers * (
        t_f + t_fb) / 1e3 / out["runs"]["vmap"]["round_s"]}
    print(f"train vmap: blocked attention {t_f:.2f} ms forward, {t_fb:.2f} ms forward + "
          f"backward a layer (events), x {cfg.n_layers} layers x {P} participants with "
          f"remat = {out['attention']['share']:.3f} of the round")
    # --- the stream cohort, and (b) vmap == stream
    new_s, m_s = run("stream", lambda: tr.make_fl_train_step(cfg, cohort="stream")(
        params, batch, fresh, tau))
    check_round("stream", new_s, m_s)
    w_ok = torch.allclose(m_s["weights"], m_v["weights"], **TRAIN_W_TOL)
    p_ok = all(torch.allclose(a.float(), b.float(), **TRAIN_P_TOL)
               for a, b in zip(tree_leaves(new_s), tree_leaves(new_v)))
    gate_b = {"weights_max_abs": (m_s["weights"] - m_v["weights"]).abs().max().item(),
              "params_differ_share": changed(new_s, new_v),
              "params_max_abs": max((a.float() - b.float()).abs().max().item()
                                    for a, b in zip(tree_leaves(new_s), tree_leaves(new_v))),
              "loss_gap": abs(float(m_s["loss"]) - float(m_v["loss"]))}
    out["gates"]["b vmap == stream"] = gate_b
    if not (w_ok and p_ok):
        fail(f"train (b): vmap != stream beyond the reference test's bounds: {gate_b}")
    print(f"train (b): vmap == stream within weights {TRAIN_W_TOL}, params {TRAIN_P_TOL}: "
          f"{gate_b}")
    del new_s, new_v
    torch.cuda.empty_cache()

    # --- YoGi on the stream cohort
    opt = yogi_init(params)
    new_y, opt, m_y = run("YoGi stream", lambda: tr.make_fl_train_step_yogi(
        cfg, cohort="stream")(params, opt, batch, fresh, tau))
    check_round("YoGi stream", new_y, m_y)
    if int(opt["t"]) != 1 or not torch.equal(m_y["weights"], m_s["weights"]):
        fail(f"train YoGi: t {int(opt['t'])}, weights {m_y['weights'].tolist()} vs the "
             f"stream step's {m_s['weights'].tolist()}")
    del new_y, opt, params
    torch.cuda.empty_cache()

    # --- (d) remat on and off: one local step of a full-width cut
    cut = dataclasses.replace(cfg, n_layers=TRAIN_REMAT_LAYERS)
    p_cut = init_params(cut, torch.Generator(device="cuda").manual_seed(301))
    pb = {k: v[0] for k, v in batch.items()}
    n_cut, res_d = sum(t.numel() for t in tree_leaves(p_cut)), {}
    for remat in (True, False):
        c = dataclasses.replace(cut, remat=remat)
        name = f"{TRAIN_REMAT_LAYERS}-layer cut, remat {'on' if remat else 'off'}, one step"
        d, loss = run(name, lambda: tr._participant_delta_fn(c, 1e-2, 1)(p_cut, pb),
                      n_tokens=B * S, n=n_cut)
        res_d[remat] = (d, loss, out["runs"][name]["peak_gb"])
    same = torch.equal(res_d[True][1], res_d[False][1]) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(res_d[True][0]),
                                          tree_leaves(res_d[False][0])))
    gate_d = {"bitwise": same, "peak_gb_remat": res_d[True][2],
              "peak_gb_no_remat": res_d[False][2],
              "differ_share": changed(res_d[True][0], res_d[False][0])}
    out["gates"]["d remat"] = gate_d
    if not same or gate_d["peak_gb_remat"] >= gate_d["peak_gb_no_remat"]:
        fail(f"train (d): remat on vs off: {gate_d}")
    print(f"train (d): {TRAIN_REMAT_LAYERS} layers at full width, one local step: remat on "
          f"== off bit for bit (loss, delta); peak memory {gate_d['peak_gb_remat']:.2f} GB "
          f"with remat, {gate_d['peak_gb_no_remat']:.2f} GB without")
    del res_d, p_cut
    torch.cuda.empty_cache()

    # --- (e) REDUCED internlm2 in fp32: the card against the host's CPU
    rcfg = dataclasses.replace(get_reduced(TRAIN_ARCH), param_dtype=torch.float32)
    rp = init_params(rcfg, torch.Generator().manual_seed(302))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, rcfg.vocab_size, (3, 2, 17)).astype(np.int32)
    rb = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    rf, rt = np.array([True, True, False]), np.array([0, 0, 2], np.int32)

    def on(dev):
        on_dev = lambda t: torch.as_tensor(t).to(dev)
        return (tree_map(on_dev, rp), {k: on_dev(v) for k, v in rb.items()},
                on_dev(rf), on_dev(rt))
    gate_e = {}
    for name in ("vmap", "YoGi stream"):
        got = {}
        for dev in ("cuda", "cpu"):
            p0, b0, f0, t0_ = on(dev)
            if name == "vmap":
                got[dev] = tr.make_fl_train_step(rcfg)(p0, b0, f0, t0_)
            else:
                new, st, m = tr.make_fl_train_step_yogi(rcfg, cohort="stream")(
                    p0, yogi_init(p0), b0, f0, t0_)
                got[dev] = (new, dict(m, m_state=st["m"], v_state=st["v"]))
        (gp, gm), (cp, cm) = got["cuda"], got["cpu"]
        cpu = lambda t: t.cpu().double()
        upd = lambda p: torch.cat([cpu(a).flatten() - cpu(b).flatten()
                                   for a, b in zip(tree_leaves(p), tree_leaves(rp))])
        rel = float((upd(gp) - upd(cp)).norm() / upd(cp).norm())
        ok = (rel <= TRAIN_UPDATE_REL_L2
              and torch.allclose(cpu(gm["loss"]), cpu(cm["loss"]), **TRAIN_CPU_TOL)
              and torch.allclose(cpu(gm["weights"]), cpu(cm["weights"]), **TRAIN_CPU_TOL)
              and all(torch.allclose(cpu(a), cpu(b), **TRAIN_CPU_TOL)
                      for a, b in zip(tree_leaves(gp), tree_leaves(cp))))
        if name != "vmap":
            ok = ok and all(torch.allclose(cpu(a), cpu(b), rtol=1e-3, atol=1e-8)
                            for a, b in zip(tree_leaves(gm["m_state"]),
                                            tree_leaves(cm["m_state"])))
        gate_e[name] = {"update_rel_l2": rel, "loss": [float(gm["loss"]), float(cm["loss"])],
                        "params_max_abs": max((cpu(a) - cpu(b)).abs().max().item()
                                              for a, b in zip(tree_leaves(gp), tree_leaves(cp)))}
        if not ok:
            fail(f"train (e) {name}: the card differs from the CPU: {gate_e[name]}")
        print(f"train (e) REDUCED fp32 {name}: card == CPU (update relative L2 {rel:.3g}, "
              f"params max abs {gate_e[name]['params_max_abs']:.3g}, losses "
              f"{gate_e[name]['loss']})")
    out["gates"]["e card == CPU"] = gate_e

    # --- (f) the repair: autograd through kernels 8 and 9 raises on the card
    gate_f = {}
    for arch, over, kernel in ((TRAIN_ARCH, dict(window=128), SWA), ("rwkv6-1.6b", {}, WKV)):
        c = dataclasses.replace(get_reduced(arch), use_kernels=True, **over)
        p0 = init_params(c, torch.Generator(device="cuda").manual_seed(303))
        t0_ = torch.randint(0, c.vocab_size, (1, 257), device="cuda")
        b0 = {"tokens": t0_[:, :-1], "labels": t0_[:, 1:]}
        leaves = [l.requires_grad_() for l in tree_leaves(p0)]
        LAUNCHES.clear()
        try:
            torch.autograd.grad(lm_loss(c, p0, b0), leaves)
        except NotImplementedError as e:
            msg = str(e)
        else:
            fail(f"train (f): lm_loss through {kernel} trained on the card")
        if LAUNCHES or "item 13" not in msg:
            fail(f"train (f): {kernel}: launches {dict(LAUNCHES)}, message {msg!r}")
        with torch.no_grad():
            loss = lm_loss(c, p0, b0)
        want = c.n_layers
        if LAUNCHES[kernel] != want or not torch.isfinite(loss):
            fail(f"train (f): {kernel} under no_grad launched {dict(LAUNCHES)} (want "
                 f"{want}), loss {float(loss)}")
        gate_f[kernel] = {"message": msg, "no_grad_launches": dict(LAUNCHES)}
        print(f"train (f): lm_loss through {kernel} under autograd on the card raised "
              f"NotImplementedError before any launch; under no_grad it launched "
              f"{dict(LAUNCHES)}")
    out["gates"]["f repair"] = gate_f
    LAUNCHES.clear()      # the no_grad launches were checks, not the path's

    # --- (g) the CLI
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--rounds",
                          str(TRAIN_CLI_ROUNDS)], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    lines = cli.stdout.strip().splitlines()
    if cli.returncode != 0 or not lines or lines[-1] != "done":
        fail(f"train (g): the CLI exited {cli.returncode}: {cli.stdout[-2000:]} "
             f"{cli.stderr[-2000:]}")
    out["gates"]["g cli"] = {"stdout": lines, "seconds": time.perf_counter() - t0}
    print(f"train (g): python -m repro_torch.launch.train --rounds {TRAIN_CLI_ROUNDS}: "
          f"{' | '.join(lines)} ({out['gates']['g cli']['seconds']:.1f}s)")
    def profile_train():
        """A profile of one vmap round."""
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(300))
        prof = profile_campaign(torch, lambda: vstep(params, batch, fresh, tau))
        del params
        round_s = out["runs"]["vmap"]["round_s"]
        prof["busy_share_of_unprofiled_wall"] = prof["device_busy_ms"] / (round_s * 1e3)
        out["profile_vmap"] = prof
        idle = prof["device_idle_share"]
        print(f"train vmap profile: {prof['gpu_kernels']} GPU kernels, device busy "
              f"{prof['device_busy_ms']:.1f} of {prof['wall_ms']:.1f} ms (idle share "
              f"{'not measured' if idle is None else f'{idle:.3f}'}; "
              f"{prof['busy_share_of_unprofiled_wall']:.3f} of the unprofiled round's "
              f"{round_s * 1e3:.1f} ms); top:")
        for kname, ms in prof["top_kernels_ms"].items():
            print(f"  {ms:9.3f} ms  {kname[:90]}")

    out["seconds"] = time.perf_counter() - t_phase
    print(f"train phase: {out['seconds']:.1f}s")
    return out, profile_train


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def time_swa(torch, swa_ops, swa_ref, gen, b, s, h, hkv, dh, window) -> dict:
    """Kernel 8 in bf16 at one shape: the kernel (events in turns with the
    plain version; CUDA-graph device time), the plain version, and
    ``scaled_dot_product_attention`` with a boolean band mask and
    ``enable_gqa`` (timed here only), beside the bound of the work at the
    real head dim."""
    import torch.nn.functional as F

    from repro_torch.roofline.analysis import swa_cost
    q, k, v = swa_inputs(torch, b, s, h, hkv, dh, torch.bfloat16, gen)
    kern = lambda: swa_ops.swa_attention(q, k, v, window=window)
    plain = lambda: swa_ref.swa_attention_ref(q, k, v, window=window)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    i = torch.arange(s, device="cuda")
    band = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
    lib = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=band,
                                                 enable_gqa=True)
    lib_err = (lib().transpose(1, 2).float() - kern().float()).abs().max().item()
    pr1, k1 = time_ms(torch, plain, 1, warmup=1), time_ms(torch, kern, 5, warmup=1)
    k2, pr2 = time_ms(torch, kern, 5, warmup=0), time_ms(torch, plain, 1, warmup=0)
    l1, l2 = time_ms(torch, lib, 3, warmup=1), time_ms(torch, lib, 3, warmup=0)
    nbytes, flops = swa_cost(b, s, h, hkv, dh, window, 2)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    res = {"shape": {"B": b, "S": s, "H": h, "Hkv": hkv, "Dh": dh, "window": window,
                     "dtype": "bf16"},
           "ms": min(k1, k2), "ms_runs": [k1, k2], "device_ms": graph_ms(torch, kern, 10),
           "plain_ms": min(pr1, pr2), "plain_ms_runs": [pr1, pr2],
           "library_ms": min(l1, l2), "library_ms_runs": [l1, l2],
           "library_max_abs_diff": lib_err, "bytes": nbytes, "flops": flops,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    del q, k, v, qh, kh, vh, band
    torch.cuda.empty_cache()
    return res


def time_lm_kernels(torch, gen) -> dict:
    """Kernels 8 and 9 at the serve path's shapes: events (plain, kernel,
    kernel, plain) and CUDA-graph device time of the kernel, events of the
    plain version (one call of it runs for hundreds of milliseconds: no
    graph), and for attention the one PyTorch call that computes the same
    function (``scaled_dot_product_attention`` with a boolean band mask and
    ``enable_gqa``), timed here only, beside each bound; attention also at
    kimi-k2's shape (Dh 112)."""
    from repro_torch.kernels.swa_attention import ops as swa_ops
    from repro_torch.kernels.swa_attention import ref as swa_ref
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.kernels.wkv6 import ref as wkv_ref
    from repro_torch.roofline.analysis import wkv_cost
    res = {SWA: time_swa(torch, swa_ops, swa_ref, gen, SWA_PATH["B"], SWA_PATH["S"], 16,
                         8, 128, 8192)}
    # kimi-k2's attention: Dh 112 computed on the 128-wide kernel
    res[SWA]["kimi-k2 Dh 112"] = kimi = time_swa(torch, swa_ops, swa_ref, gen, *KIMI_SWA)
    kimi["tflop_s"] = kimi["flops"] / kimi["device_ms"] / 1e9
    kimi["bound_share"] = kimi["bound_ms"] / kimi["device_ms"]
    print(f"{SWA} kimi-k2 {kimi['shape']}: kernel {kimi['ms']:.4f} ms (device "
          f"{kimi['device_ms']:.4f}), plain {kimi['plain_ms']:.4f} ms, library "
          f"{kimi['library_ms']:.4f} ms, bound {kimi['bound_ms']:.6f} ms "
          f"({kimi['bound_by']}); {kimi['tflop_s']:.1f} TFLOP/s of the 112-wide work, "
          f"{kimi['bound_share']:.3f} of the bound")
    b, s, h, n = WKV_PATH["B"], WKV_PATH["S"], 32, 64
    r, k, v, w, u, _ = wkv_inputs(torch, b, s, h, n, torch.bfloat16, False, gen)
    kern = lambda: wkv_ops.wkv6(r, k, v, w, u)
    plain = lambda: wkv_ref.wkv6_scan(r, k, v, w, u)
    pr1, k1 = time_ms(torch, plain, 1, warmup=1), time_ms(torch, kern, 10, warmup=2)
    k2, pr2 = time_ms(torch, kern, 10, warmup=0), time_ms(torch, plain, 1, warmup=0)
    nbytes, flops = wkv_cost(b, s, h, n, 2, False)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    res[WKV] = {"shape": {"B": b, "S": s, "H": h, "N": n, "dtype": "bf16 r/k/v, fp32 w"},
                "ms": min(k1, k2), "ms_runs": [k1, k2], "device_ms": graph_ms(torch, kern),
                "plain_ms": min(pr1, pr2), "plain_ms_runs": [pr1, pr2],
                "library_ms": None, "bytes": nbytes, "flops": flops,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    # decode: one step of the requests' batch (S = 1)
    r, k, v, w, u, s0 = wkv_inputs(torch, REQUESTS["B"], 1, h, n, torch.bfloat16, True, gen)
    step = lambda: wkv_ops.wkv6(r, k, v, w, u, state0=s0)
    nbytes, flops = wkv_cost(REQUESTS["B"], 1, h, n, 2, True)
    res[WKV]["decode_step"] = {"B": REQUESTS["B"], "ms": time_ms(torch, step, 200),
                               "device_ms": graph_ms(torch, step),
                               "kernel_ms": kernel_ms(torch, step, ("wkv6_kernel",)),
                               "bound_ms": max(nbytes / PEAK_BYTES_PER_S,
                                               flops / PEAK_FP32_FLOPS) * 1e3}
    for kname, t in res.items():
        # achieved rate and share of the bound, from the device time
        t["tflop_s"] = t["flops"] / t["device_ms"] / 1e9
        t["bound_share"] = t["bound_ms"] / t["device_ms"]
        lib = "" if t["library_ms"] is None else f", library {t['library_ms']:.4f} ms"
        print(f"{kname} {t['shape']}: kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f}), "
              f"plain {t['plain_ms']:.4f} ms{lib}, bound {t['bound_ms']:.6f} ms "
              f"({t['bound_by']}); {t['tflop_s']:.1f} TFLOP/s, {t['bound_share']:.3f} of "
              f"the bound")
    d = res[WKV]["decode_step"]
    print(f"{WKV} decode step B={d['B']}: {d['ms']:.4f} ms (device {d['device_ms']:.4f}; "
          f"the kernel alone {d['kernel_ms']:.5f}), bound {d['bound_ms']:.6f} ms")
    return res


def profile_campaign(torch, run, compare_readers=False) -> dict:
    """Device busy share, host span times and the top GPU kernels of one
    warm campaign, from a ``torch.profiler`` trace.  Busy time is the sum
    of GPU kernel and copy times over the wall time of the synchronized
    run; the pipeline's ``round.*`` spans are host ranges (their device-
    side mirrors are not work and are left out).  ``compare_readers``
    also reads the trace through ``prof.events()`` and records both."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the trace's raw events: ``prof.events()`` builds a tree of every
    # event first, ~0.1 ms each in Python, minutes for a prefill of 10^5
    # kernels
    spans, by_name, counts = trace_sums(prof, raw=True)
    n_kernels = sum(counts.values())
    busy_ms = sum(by_name.values())
    res = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms if n_kernels else None,
           "gpu_kernels": n_kernels, "host_spans_ms": dict(spans),
           "top_kernels_ms": dict(by_name.most_common(8))}
    if compare_readers:
        res["readers"] = compare_trace_readers(prof, spans, by_name, counts)
    return res


def trace_sums(prof, raw):
    """(host ``round.*`` span ms, GPU ms by name, GPU events by name) of a
    trace, read from its raw events (``raw``) or from ``prof.events()``."""
    spans, by_name, counts = Counter(), Counter(), Counter()
    if raw:
        events = ((e.name(), e.device_type().name, e.duration_ns() / 1e6,
                   e.duration_ns() / 1e6) for e in prof.profiler.kineto_results.events())
    else:
        events = ((e.name, e.device_type.name, e.cpu_time_total / 1e3,
                   e.device_time_total / 1e3) for e in prof.events())
    for name, dev, cpu_ms, dev_ms in events:
        if name.startswith("round."):
            if dev == "CPU":
                spans[name] += cpu_ms
        elif dev == "CUDA":
            by_name[name] += dev_ms
            counts[name] += 1
    return spans, by_name, counts


def compare_trace_readers(prof, spans, by_name, counts) -> dict:
    """The raw-event reader against ``prof.events()`` on one trace: GPU
    events, busy ms and span ms by each, and the events by name that one
    counts and the other does not.  Held: the same events by name, and ms
    by name and by span within 1e-6."""
    spans2, by_name2, counts2 = trace_sums(prof, raw=False)
    res = {"raw": {"gpu_kernels": sum(counts.values()), "device_busy_ms": sum(by_name.values()),
                   "host_spans_ms": dict(spans)},
           "events": {"gpu_kernels": sum(counts2.values()),
                      "device_busy_ms": sum(by_name2.values()),
                      "host_spans_ms": dict(spans2)},
           "only_raw": dict(counts - counts2), "only_events": dict(counts2 - counts),
           "max_abs_ms_by_name": max((abs(by_name[k] - by_name2[k])
                                      for k in by_name | by_name2), default=0.0)}
    print(f"  trace readers on one trace: raw events {res['raw']['gpu_kernels']} GPU "
          f"events, busy {res['raw']['device_busy_ms']:.4f} ms; prof.events() "
          f"{res['events']['gpu_kernels']}, busy {res['events']['device_busy_ms']:.4f} ms; "
          f"largest gap by name {res['max_abs_ms_by_name']:.3g} ms; only raw "
          f"{res['only_raw']}; only prof.events() {res['only_events']}; spans raw "
          f"{spans} vs {spans2}")
    span_gap = max((abs(spans[k] - spans2[k]) for k in spans | spans2), default=0.0)
    if counts != counts2 or res["max_abs_ms_by_name"] > 1e-6 or span_gap > 1e-6:
        fail(f"the trace readers disagree: {res}")
    return res


def record_bits(rec):
    """A RoundRecord as comparable values (NaN accuracy on non-eval rounds
    compares equal to itself)."""
    return tuple(repr(v) for v in dataclasses.astuple(rec))


def host(r):
    return (r.round_idx, r.sim_time, r.n_selected, r.n_fresh, r.n_stale,
            r.resource_used, r.resource_wasted, r.unique_participants)


def aggregated(acct) -> int:
    return sum(1 for r in acct.records if r.n_fresh + r.n_stale > 0)


def expected_launches(saa_ops, trim_ops, kernel, acct, d=MAIN_D) -> dict:
    """The launches a run of ``kernel`` must make: one a round with a
    group, kernels 1-4 each on the variant its shape takes at the run's
    padded width ``d`` (``ops.variant``: the cluster kernel at the
    classifier's 7 chunks, the chain at the LM's 105-133), the trimmed mean
    on the variant each round's n takes (none for ``kernel`` None)."""
    rows = [r.n_fresh + r.n_stale for r in acct.records
            if r.n_fresh + r.n_stale > 0]
    if kernel is None:
        return {}
    want = {kernel: len(rows)}
    if kernel in FUSED:
        want.update(Counter(saa_ops.launch_key(
            kernel, saa_ops.variant(1, n, d)) for n in rows))
    if kernel == TRIM:
        want.update(Counter(saa_ops.launch_key(TRIM, trim_ops.variant(n))
                            for n in rows))
    return want


def robust_counts(acct):
    s = acct.summary()
    return s["robust_rejected"], s["robust_trimmed"]


def guard_counts(acct):
    s = acct.summary()
    return s["rejected_nonfinite"], s["rejected_norm"], s["quorum_skips"]


def attacker_sets(sim):
    """Every round's attacker ids of a Simulator's plan (empty unattacked)."""
    plan = sim.fault_plan
    if plan is None:
        return []
    return [plan.attackers(r).tolist() for r in range(sim.cfg.rounds)]


def drive(sim, eager=False):
    """``sim.run()``, with a fused run's ``RoundPipeline`` stats (None for
    the flat path).  ``eager`` turns the card's round graphs off: the same
    padded rounds, dispatched op by op (this script's comparison only)."""
    from repro_torch.sim.pipeline import RoundPipeline
    if not sim.cfg.fused_rounds:
        return sim.run(), None
    pipe = RoundPipeline([sim])
    if eager:
        pipe.graphs, pipe.stats.graphed = None, False
    acct, = pipe.run()
    return acct, pipe.stats.as_dict()


def graph_gate(name, stats, kernel, n_records, cap_max=CAPTURE_MAX, d=MAIN_D):
    """Fail unless a fused run on kernel 1 or 2 replayed every round from
    its graphs (at most ``cap_max`` captures, none where an earlier run of
    its structure captured them all; each warm-up at most one launch of
    its kernel, on the variant its padded width ``d`` takes), and any
    other fused run ran eagerly."""
    from repro_torch.kernels.staleness_agg import ops
    graphed = kernel in (APPLY, AGG)
    if stats["graphed"] != graphed:
        fail(f"{name}: graphed {stats['graphed']}, expected {graphed}")
    if not graphed:
        return
    warm, caps = stats["warmup_launches"], stats["graph_captures"]
    key = ops.launch_key(kernel, ops.variant(1, 1, d))
    if not (stats["graph_replays"] == stats["rounds"] == n_records
            and caps <= cap_max
            and set(warm) <= {kernel, key}
            and warm.get(kernel, 0) == warm.get(key, 0) <= caps):
        fail(f"{name}: {stats['graph_replays']} replays over {stats['rounds']} "
             f"rounds ({n_records} recorded), {caps} captures (at most "
             f"{cap_max}), warm-up launches {warm}")


def chunk_count(cfg, k, rounds) -> int:
    """The K-round chunks (broken at evaluation rounds) holding one of
    ``rounds``."""
    chunks, cur = [], []
    for r in range(cfg.rounds):
        cur.append(r)
        if len(cur) == k or (r + 1) % cfg.eval_every == 0 or r == cfg.rounds - 1:
            chunks.append(cur)
            cur = []
    return sum(1 for c in chunks if set(c) & set(rounds))


def same_run(torch, acct_a, sim_a, acct_b, sim_b) -> bool:
    """Records, params and YoGi state bit for bit."""
    if [record_bits(r) for r in acct_a.records] != \
            [record_bits(r) for r in acct_b.records]:
        return False
    if not bits_equal(torch, sim_a.flat_params, sim_b.flat_params):
        return False
    opt_a, opt_b = sim_a.flat_opt_state, sim_b.flat_opt_state
    return opt_a is None or all(
        torch.equal(opt_a[k].contiguous().view(torch.int32),
                    opt_b[k].contiguous().view(torch.int32)) for k in ("m", "v"))


def check_padding(torch, ops, checks, ns, gen):
    """Kernels 1 and 2 at n rows against the same cells padded with
    invalid zero rows to the pipeline's operand bucket and to n + 1, bit
    for bit (weights, aggregates, params as int32 views), at S = 1 and 16;
    the padded bucket may cross into the cluster kernel's L2 branch."""
    from repro_torch.core.aggregation import bucket_block
    from repro_torch.sim.pipeline import N_BLOCK
    for s_ in (1, 16):
        for n in ns:
            params, u, fresh, tau, valid, scal = saa_inputs(torch, s_, n, MAIN_D,
                                                            "mixed", gen)
            beta = scal[:, 0].contiguous()
            p1 = params.clone()
            _, w1 = ops.sweep_fused_staleness_apply(p1, u, fresh, tau, valid, scal)
            a2, w2 = ops.sweep_fused_staleness_aggregate(u, fresh, tau, beta, valid)
            for n_b in sorted({bucket_block(n, N_BLOCK), n + 1}):
                if n_b == n:
                    continue

                def pad(t):
                    out = t.new_zeros((s_, n_b) + tuple(t.shape[2:]))
                    out[:, :n] = t
                    return out
                up, fp, tp, vp = pad(u), pad(fresh), pad(tau), pad(valid)
                p2 = params.clone()
                _, w1p = ops.sweep_fused_staleness_apply(p2, up, fp, tp, vp, scal)
                a2p, w2p = ops.sweep_fused_staleness_aggregate(up, fp, tp, beta, vp)
                torch.cuda.synchronize()
                for what, a, b in (("apply params", p1, p2),
                                   ("apply weights", w1, w1p[:, :n]),
                                   ("aggregate", a2, a2p),
                                   ("aggregate weights", w2, w2p[:, :n])):
                    if not bits_equal(torch, a, b):
                        fail(f"kernels 1-2: {what} at S={s_} n={n} differ from "
                             f"n padded to {n_b}, bitwise")
                checks.bits["kernels 1-2 n == padded n"] += 1


# --- the sweep paths -------------------------------------------------------


def gemm_probe(torch, gen, counts) -> dict:
    """Whether cuBLAS's batched GEMM gives one matrix the same bits at every
    batch count: for each of the training step's GEMMs, matrix 0 of a bmm
    over R matrices against the same matrix alone (R = 1), as int32 views.
    {gemm: {R: equal}}."""
    out = {}
    for name, (m, k, n) in TRAIN_GEMMS.items():
        a = torch.randn((max(counts), m, k), generator=gen, device="cuda")
        b = torch.randn((max(counts), k, n), generator=gen, device="cuda")
        one = torch.bmm(a[:1], b[:1])[0]
        out[name] = {r: bits_equal(torch, torch.bmm(a[:r], b[:r])[0], one)
                     for r in counts}
    return out


def batch_rounds(results, idxs):
    """{round: the rows the server step's launch saw (the largest group)}
    over the batch-rounds of cells ``idxs`` in which some cell aggregated."""
    out = {}
    for i in idxs:
        for rec in results[i].acct.records:
            n = rec.n_fresh + rec.n_stale
            if n:
                out[rec.round_idx] = max(out.get(rec.round_idx, 0), n)
    return out


def sweep_launch_gate(saa_ops, trim_ops, runner, results, got, kernel, name):
    """Fail unless ``kernel`` launched once per batch-round that aggregated
    (kernels 1-2 on the cluster kernel, kernel 7 on the variant of the
    round's padded n) and no other kernel launched.  Returns the n each
    launch saw."""
    rows = [n for idxs in runner.batches()
            for n in batch_rounds(results, idxs).values()]
    want = Counter({kernel: len(rows)})
    if kernel == TRIM:
        want.update(saa_ops.launch_key(TRIM, trim_ops.variant(n)) for n in rows)
    else:
        want[saa_ops.launch_key(kernel, "cluster")] = len(rows)
    if not rows or got != dict(want):
        fail(f"{name}: launches {got}, expected {dict(want)} (one per "
             "batch-round that aggregated, and no other kernel)")
    return rows


def rows_line(name, rows) -> str:
    resident = sum(cluster_resident(n, MAIN_D) for n in rows)
    return (f"{name}: rows a launch min {min(rows)}, median "
            f"{sorted(rows)[len(rows) // 2]}, max {max(rows)}; U in shared "
            f"memory in {resident} launches, from L2 in {len(rows) - resident}")


def hold_to_serial(torch, name, cells, results, runner, serial, exact):
    """Each cell of a sweep against its serial run: bit for bit (summaries,
    records, params as int32 views) where ``exact``, else host records
    ``==`` and params within SWEEP_RTOL / SWEEP_ATOL; the robust counters
    and attacker sets ``==`` either way.  Returns (cells bitwise equal,
    largest params difference)."""
    from repro_torch.sweeps import summaries_equal
    bitwise, diff = 0, 0.0
    for i, c in enumerate(cells):
        sim, acct = serial[i]
        mine = runner.sims[i]
        same = (summaries_equal(dict(results[i].summary), acct.summary())
                and [record_bits(r) for r in results[i].acct.records]
                == [record_bits(r) for r in acct.records]
                and bits_equal(torch, mine.flat_params, sim.flat_params))
        bitwise += same
        diff = max(diff, (mine.flat_params - sim.flat_params).abs().max().item())
        if exact and not same:
            fail(f"{name}: cell {c.name} differs from its serial run")
        if [host(r) for r in results[i].acct.records] != \
                [host(r) for r in acct.records]:
            fail(f"{name}: cell {c.name}: host records differ from its serial run")
        if not torch.allclose(mine.flat_params, sim.flat_params,
                              rtol=SWEEP_RTOL, atol=SWEEP_ATOL):
            fail(f"{name}: cell {c.name}: params differ from its serial run "
                 f"by {diff}")
        if robust_counts(results[i].acct) != robust_counts(acct):
            fail(f"{name}: cell {c.name}: robust counters differ from serial")
        if attacker_sets(mine) != attacker_sets(sim):
            fail(f"{name}: cell {c.name}: attacker sets differ from serial")
    return bitwise, diff


def time_sweep_kernel(torch, ops, ref, kernel, s, n, d, gen) -> dict:
    """Kernel 1 or 2 at S cells of n rows ('mixed' operands): events over
    200 calls, CUDA-graph replay, the profiler's kernel time and the plain
    version's graph time, beside the bound from these inputs."""
    k, p, _, nf = kernel_calls(torch, ops, ref, kernel, s, n, d, gen)
    nbytes, flops = saa_cost(kernel, s, n, d, nf)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    v = ops.variant(s, n, d)
    return {"shape": {"S": s, "n": n, "D": d}, "variant": v,
            "ms": time_ms(torch, k, 200), "device_ms": graph_ms(torch, k),
            "kernel_ms": kernel_ms(torch, k, VARIANT_KERNELS[v]),
            "plain_device_ms": graph_ms(torch, p), "bytes": nbytes,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_sweep_trimmed(torch, ops, ref, checks, s, n, d, gen) -> dict:
    """Kernel 7 at S groups of n rows (the median's depth), held to its
    plain version first, timed as ``time_sweep_kernel``."""
    y = torch.randn((s, n, d), generator=gen, device="cuda")
    k = torch.full((s,), (n - 1) // 2, dtype=torch.int32, device="cuda")
    c = torch.full((s,), n, dtype=torch.int32, device="cuda")
    fn = lambda: ops.sweep_trimmed_aggregate(y, k, c)
    checks.close(TRIM, fn(), ref.sweep_trimmed_aggregate(y, k, c),
                 f"S={s} n={n} D={d} (sweep)", weights=True)
    checks.count(TRIM)
    nbytes, lane_ops = trimmed_cost(s, n, d, n - 2 * ((n - 1) // 2))
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = lane_ops / PEAK_FP32_LANE_OPS * 1e3
    v = ops.variant(n)
    return {"shape": {"S": s, "n": n, "D": d}, "variant": v,
            "ms": time_ms(torch, fn, 200), "device_ms": graph_ms(torch, fn),
            "kernel_ms": kernel_ms(torch, fn, TRIM_KERNELS[v]),
            "plain_device_ms": graph_ms(torch, lambda: ref.sweep_trimmed_aggregate(
                y, k, c)), "bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def sweep_paths(torch, gen, checks, launches) -> dict:
    """The five sweep paths on the card, each with the launch counters
    zeroed just before it and read just after; their gates; batched and
    serial wall times; kernels 1, 2 and 7 at S > 1.  Returns (the report,
    a function that profiles each path's first batch: the caller runs it
    after the script's other profiles)."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.staleness_agg import ops as saa_ops
    from repro_torch.kernels.staleness_agg import ref as saa_ref
    from repro_torch.kernels.trimmed_agg import ops as trim_ops
    from repro_torch.kernels.trimmed_agg import ref as trim_ref
    from repro_torch.sim import SimConfig, Simulator, Substrate
    from repro_torch.sim import pipeline as pl
    from repro_torch.sim.engine import substrate_key
    from repro_torch.sweeps import SweepRunner, SweepSpec
    from repro_torch.sweeps import summaries_equal

    out = {"paths": {}}
    probe = gemm_probe(torch, gen, (1, 2, 10, 13, 16, 22, 64, 160, 208, 352, 640))
    exact = all(all(v.values()) for v in probe.values())
    out["gemm_probe"] = {g: {str(r): e for r, e in v.items()} for g, v in probe.items()}
    print("cuBLAS batched GEMM probe (matrix 0 of a bmm over R matrices == the "
          "matrix alone, int32 views), the training step's GEMMs: " + "; ".join(
              f"{g}: differs at R in {[r for r, e in v.items() if not e]}"
              for g, v in probe.items()))
    print("batched vs serial gate: " + (
        "bit for bit" if exact else
        f"host records ==, params within rtol {SWEEP_RTOL} / atol {SWEEP_ATOL} "
        "(cuBLAS gives one matrix other bits at another batch count)"))
    out["exact"] = exact

    cache = {}

    def cells_of(spec):
        cs = SweepSpec(**spec).expand()
        for c in cs:
            key = substrate_key(c.config)
            if key not in cache:
                cache[key] = Substrate.build(c.config)
        return cs

    def batched(name, cells, kernel):
        runner = SweepRunner(cells, device="cuda", substrate_cache=cache)
        LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = runner.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(LAUNCHES)
        rows = sweep_launch_gate(saa_ops, trim_ops, runner, res, got, kernel, name)
        for idxs, st in zip(runner.batches(), runner.batch_stats):
            graph_gate(name, st, kernel,
                       len({x.round_idx for i in idxs for x in res[i].acct.records}),
                       SWEEP_CAPTURE_MAX)
        launches.update(got)
        cell_rounds = sum(len(r.acct.records) for r in res)
        cap = sum(st["graph_capture_s"] for st in runner.batch_stats)
        out["paths"][name] = {"cells": len(cells), "batches": len(runner.batches()),
                              "launches": got, "batch_rounds": len(rows),
                              "rows": dict(Counter(rows)),
                              "batched_s": wall, "cell_rounds": cell_rounds,
                              "batched_cell_rounds_per_s": cell_rounds / wall,
                              "pipelines": runner.batch_stats, "capture_s": cap}
        graphed = [st for st in runner.batch_stats if st["graphed"]]
        print(f"{name}: {len(cells)} cells in {len(runner.batches())} batches, "
              f"{got} over {len(rows)} batch-rounds that aggregated; "
              f"{cell_rounds} cell-rounds in {wall:.2f}s batched = "
              f"{cell_rounds / wall:.1f} cell-rounds/s" + (
                  f"; {sum(st['graph_replays'] for st in graphed)} batch-rounds "
                  f"replayed from {sum(st['graph_captures'] for st in graphed)} "
                  f"graphs, captures {cap:.3f}s (the rest "
                  f"{cell_rounds / (wall - cap):.1f} cell-rounds/s)" if graphed
                  else ""))
        print("  " + rows_line(name, rows))
        return runner, res, rows

    jobs = []        # profiles, taken after the script's other profiles

    def profiled(name, cells, runner, res):
        """Queue a profile of the path's first batch, run again."""
        first = runner.batches()[0]
        # the batch-rounds in which some cell of the batch took part
        rounds = len({x.round_idx for i in first for x in res[i].acct.records})
        jobs.append((name, [cells[i] for i in first], rounds))

    def profile_paths():
        for name, batch, rounds in jobs:
            prof = profile_campaign(torch, lambda: SweepRunner(
                batch, device="cuda", substrate_cache=cache).run())
            prof.update(cells=len(batch), batch_rounds=rounds,
                        gpu_kernels_per_batch_round=prof["gpu_kernels"] / rounds)
            out["paths"][name]["profile"] = prof
            idle = prof["device_idle_share"]
            print(f"{name}: profile of its first batch ({len(batch)} "
                  f"{batch[0].config.selector} cells, {rounds} batch-rounds): "
                  f"{prof['gpu_kernels']} GPU kernels "
                  f"({prof['gpu_kernels_per_batch_round']:.1f} a batch-round), "
                  f"busy {prof['device_busy_ms']:.1f} of {prof['wall_ms']:.1f} ms "
                  f"(idle share {'not measured' if idle is None else f'{idle:.3f}'})"
                  "; host spans (CPU ms): " + ", ".join(
                      f"{k} {v:.1f}" for k, v in sorted(prof["host_spans_ms"].items())))

    def serially(name, cells):
        sims = [Simulator(c.config, substrate=cache[substrate_key(c.config)],
                          device="cuda") for c in cells]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        accts = [sim.run() for sim in sims]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        p = out["paths"][name]
        p.update(serial_s=wall, serial_cell_rounds_per_s=p["cell_rounds"] / wall,
                 speedup=wall / p["batched_s"])
        print(f"  serial: {wall:.2f}s = {p['cell_rounds'] / wall:.1f} "
              f"cell-rounds/s; batched {p['speedup']:.2f}x")
        return list(zip(sims, accts))

    def gate_serial(name, cells, runner, res, serial):
        bitwise, diff = hold_to_serial(torch, name, cells, res, runner,
                                       serial, exact)
        out["paths"][name].update(cells_bitwise_to_serial=bitwise,
                                  max_params_diff_to_serial=diff)
        print(f"  batched vs serial: host records, robust counters and attacker "
              f"sets ==; {bitwise} of {len(cells)} cells bit for bit; params max "
              f"abs diff {diff:.3g}")

    # 1. S = 64, fused: kernel 1 once a batch-round; then in K-round chunks,
    # bit for bit the K = 1 sweep
    grid = cells_of(SWEEP_GRID)
    runner64, res64, rows64 = batched("sweep S=64 fused", grid, APPLY)
    profiled("sweep S=64 fused", grid, runner64, res64)
    name_k = f"sweep S=64 fused K={CHUNK_K}"
    grid_k = [dataclasses.replace(c, config=dataclasses.replace(
        c.config, rounds_per_dispatch=CHUNK_K)) for c in grid]
    runner_k, res_k, _ = batched(name_k, grid_k, APPLY)
    for i, c in enumerate(grid):
        if not (summaries_equal(dict(res_k[i].summary), dict(res64[i].summary))
                and same_run(torch, res64[i].acct, runner64.sims[i],
                             res_k[i].acct, runner_k.sims[i])):
            fail(f"{name_k}: cell {c.name} differs from the K = 1 sweep")
    chunks = [st["dispatches"]["round"] for st in runner_k.batch_stats]
    print(f"  {name_k} == K = 1 sweep, bit for bit (summaries, records, params) "
          f"in all {len(grid)} cells; chunks a batch {chunks}")
    profiled(name_k, grid_k, runner_k, res_k)
    serial64 = serially("sweep S=64 fused", grid)
    gate_serial("sweep S=64 fused", grid, runner64, res64, serial64)
    # the 16 seed-0 HS1 / HS3 cells' host records against a CPU run
    pick = [i for i, c in enumerate(grid) if c.config.seed == 0
            and c.config.hardware_scenario in ("HS1", "HS3")]
    cpu = SweepRunner([grid[i] for i in pick], device="cpu").run()
    for i, r in zip(pick, cpu):
        if [host(x) for x in res64[i].acct.records] != \
                [host(x) for x in r.acct.records]:
            fail(f"sweep S=64 fused: cell {grid[i].name}: host records differ "
                 "from a CPU run")
    print(f"  host records of the {len(pick)} seed-0 HS1/HS3 cells == a CPU run's")
    # 2. the same grid on the per-stage path: kernel 2, equal to the fused sweep
    flat = [dataclasses.replace(c, config=dataclasses.replace(
        c.config, fused_rounds=False)) for c in grid]
    runner_f, res_f, _ = batched("sweep S=64 per-stage", flat, AGG)
    for i, c in enumerate(grid):
        if not (summaries_equal(dict(res_f[i].summary), dict(res64[i].summary))
                and [record_bits(r) for r in res_f[i].acct.records]
                == [record_bits(r) for r in res64[i].acct.records]
                and bits_equal(torch, runner_f.sims[i].flat_params,
                               runner64.sims[i].flat_params)):
            fail(f"sweep S=64 per-stage: cell {c.name} differs from the fused sweep")
    print("  per-stage sweep == fused sweep, bit for bit (summaries, records, "
          "params) in all 64 cells")
    profiled("sweep S=64 per-stage", flat, runner_f, res_f)
    gate_serial("sweep S=64 per-stage", flat, runner_f, res_f,
                serially("sweep S=64 per-stage", flat))
    # 3. RELAY + YoGi: kernel 2
    cells = cells_of(YOGI_SWEEP)
    runner, res, _ = batched("sweep YoGi S=8", cells, AGG)
    profiled("sweep YoGi S=8", cells, runner, res)
    gate_serial("sweep YoGi S=8", cells, runner, res,
                serially("sweep YoGi S=8", cells))
    # 4. the robustness race's coordinate-wise defenses: kernel 7
    for dname, spec in ROBUST_SWEEPS.items():
        name = f"sweep {dname} S=8"
        cells = cells_of(spec)
        runner, res, _ = batched(name, cells, TRIM)
        profiled(name, cells, runner, res)
        gate_serial(name, cells, runner, res, serially(name, cells))
    # 5. early stop: the S = 16 grid with a target at the upper quartile of
    # its cells' accuracies at their last evaluation before the final round
    # of the S = 64 sweep: a quarter of them stop there or earlier
    last = SWEEP_BASE["rounds"] - 1
    before_last = sorted([x.accuracy for x in res64[i].acct.records
                          if x.round_idx < last and x.accuracy == x.accuracy][-1]
                         for i in pick)
    target = before_last[3 * len(before_last) // 4]
    cells = cells_of(dict(axes=SWEEP16_AXES, base=dict(
        SWEEP_BASE, target_accuracy=target), seeds=(0,)))
    rounds_in = Counter()        # device rounds each cell took part in
    pack = pl.RoundPipeline._pack

    def recording(pipe, work):
        rounds_in.update(id(pipe.sims[i]) for i in work.order)
        return pack(pipe, work)
    pl.RoundPipeline._pack = recording
    try:
        runner, res, _ = batched("sweep early stop S=16", cells, APPLY)
    finally:
        pl.RoundPipeline._pack = pack
    stopped = [i for i, r in enumerate(res) if r.summary["stopped_early"]]
    before = [i for i in stopped if res[i].acct.records[-1].round_idx < last]
    if not before:
        fail(f"early stop: {len(stopped)} of {len(cells)} cells stopped at "
             f"target {target}, none before the last round")
    for i, r in enumerate(res):     # a round a record: none after a stop
        if rounds_in[id(runner.sims[i])] != len(r.acct.records):
            fail(f"early stop: cell {cells[i].name} took part in "
                 f"{rounds_in[id(runner.sims[i])]} device rounds over "
                 f"{len(r.acct.records)} recorded rounds")
    out["paths"]["sweep early stop S=16"].update(
        target_accuracy=target, stopped=len(stopped),
        stopped_before_last_round=len(before),
        rounds_run=sum(r.summary["rounds"] for r in res))
    print(f"  target accuracy {target:.4f} (the upper quartile before the "
          "final round): "
          f"{len(stopped)} of {len(cells)} cells stopped, {len(before)} before "
          f"round {SWEEP_BASE['rounds']}; no cell took part in a device round "
          "after its stop")
    profiled("sweep early stop S=16", cells, runner, res)
    gate_serial("sweep early stop S=16", cells, runner, res,
                serially("sweep early stop S=16", cells))
    # each sweep kernel against its plain version at every (S, n) it ran at
    ns = {APPLY: Counter(rows64), AGG: Counter(out["paths"]["sweep YoGi S=8"]["rows"])}
    for kernel, n_seen in ns.items():
        for n_ in sorted(n_seen):
            for s_ in (len(runner64.batches()[0]), 8):
                check_family(torch, saa_ops, saa_ref, checks, s_, n_, MAIN_D,
                             "relay", "padding", gen, rule_free=False)
    # kernels 1 and 2 at S cells, kernel 7 at S groups, at the paths' n
    n1 = Counter(rows64).most_common(1)[0][0]
    n2 = Counter(out["paths"]["sweep YoGi S=8"]["rows"]).most_common(1)[0][0]
    n7 = Counter(out["paths"]["sweep trimmed_mean S=8"]["rows"]).most_common(1)[0][0]
    out["times"] = {
        APPLY: {s_: time_sweep_kernel(torch, saa_ops, saa_ref, APPLY, s_, n1,
                                      MAIN_D, gen) for s_ in SWEEP_TIME_S},
        AGG: {s_: time_sweep_kernel(torch, saa_ops, saa_ref, AGG, s_, n2,
                                    MAIN_D, gen) for s_ in SWEEP_TIME_S},
        TRIM: {s_: time_sweep_trimmed(torch, trim_ops, trim_ref, checks, s_, n7,
                                      TRIM_D[-1], gen) for s_ in TRIM_TIME_S}}
    for kernel, by_s in out["times"].items():
        for s_, t in by_s.items():
            print(f"{kernel} S={s_} {t['shape']} [{t['variant']}]: {t['ms']:.4f} ms "
                  f"events, {t['device_ms']:.4f} graph, {t['kernel_ms']:.5f} kernel "
                  f"by the profiler; plain {t['plain_device_ms']:.4f} graph; bound "
                  f"{t['bound_ms']:.6f} ms ({t['bound_by']})")
    return out, profile_paths


# --- the chaos harness -----------------------------------------------------


def chaos_paths(torch, launches) -> dict:
    """``examples/chaos_round.py`` at full size on the card (100 learners,
    40 rounds, eval every 10, n_target 10, priority + SAA relay,
    label_uniform, seed 0; kernels on), through ``repro_torch.chaos_round``:
    the four guard modes fused and graphed under its fault plan (nan 0.08,
    inf 0.04, scale 0.08 x1e4, post_drop 0.05, replay 0.10, seed 42), the
    guard on without faults, guard=clip+reject's flat twin, a guarded
    RELAY+YoGi run (kernel 2), guard=reject at K = 4 and with its rounds
    dispatched eagerly, and guard + coord_median under the race's
    collude_signflip (kernel 7).  A round whose quorum fails still runs its
    server step (the reference computes it, then keeps the old rows), so
    each kernel must launch once per round with a group, counted per
    replay; on the flat twin too, where kernel 3 takes the survivor mask
    as ``valid``.  Then the crash:
    the guard=reject run crashed (soft) after round 15 with a snapshot
    every 5 and resumed, at K = 1 and 4, against the uninterrupted run;
    and the sweep CLI's hard crash (SIGKILL) and its resume in
    subprocesses.  Returns the report's "chaos" entry and, for each kernel,
    the rows a round it ran at (``main`` holds it against its plain
    version at those n)."""
    import os
    import tempfile
    from repro_torch import chaos_round
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.staleness_agg import ops as saa_ops
    from repro_torch.kernels.trimmed_agg import ops as trim_ops
    from repro_torch.sim import SimConfig, Simulator
    from repro_torch.sweeps import run_batched
    from repro_torch.sweeps.__main__ import demo_spec
    common, plan = chaos_round.build(False)
    common = dict(common, use_agg_kernel=True)
    modes = {label: extra for label, extra, _ in chaos_round.GUARD_MODES}
    reject, clip = modes["guard=reject"], modes["guard=clip+reject"]
    runs = {              # name -> (config, faulted, the kernel it runs)
        "clean": (common, False, APPLY),
        "guard, no faults": (dict(common, guard=True, quorum=1), False, APPLY),
        "guard=off": (common, True, APPLY),
        "guard=reject": (dict(common, **reject), True, APPLY),
        "guard=clip+reject": (dict(common, **clip), True, APPLY),
        "guard=clip+reject flat": (dict(common, **clip, fused_rounds=False),
                                   True, CELL_AGG),
        "RELAY+YoGi guard=reject": (dict(common, **reject, server_opt="yogi"),
                                    True, AGG),
        f"guard=reject K={CHUNK_K}": (dict(common, **reject,
                                           rounds_per_dispatch=CHUNK_K),
                                      True, APPLY),
        "coord_median guard": (dict(chaos_round.attack_config(False),
                                    use_agg_kernel=True,
                                    aggregator="coord_median", **reject),
                               True, TRIM),
        # kernels off: each group screened and weighed on its own rows
        "guard=clip+reject, kernels off": (dict(common, **clip,
                                                use_agg_kernel=False),
                                           True, None),
        "guard=clip+reject, kernels off flat": (
            dict(common, **clip, use_agg_kernel=False, fused_rounds=False),
            True, None),
    }
    guarded = [n for n, (kw, _, _) in runs.items() if kw.get("guard")
               and n != "guard, no faults"]
    gpu, sims, rep, ns = {}, {}, {"paths": {}}, {}
    for name, (kw, faulted, kernel) in runs.items():
        sims[name] = sim = Simulator(SimConfig(**kw), device="cuda",
                                     fault_plan=plan if faulted else None)
        LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gpu[name], stats = drive(sim)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got, n_grp = dict(LAUNCHES), aggregated(gpu[name])
        want = expected_launches(saa_ops, trim_ops, kernel, gpu[name])
        if (kernel is not None and n_grp == 0) or got != want:
            fail(f"chaos {name}: launches {got}, expected {want} (one per "
                 "round with a group)")
        if kernel is not None:
            ns.setdefault(kernel, Counter()).update(
                r.n_fresh + r.n_stale for r in gpu[name].records
                if r.n_fresh + r.n_stale > 0)
        if stats is not None:
            graph_gate(f"chaos {name}", stats, kernel, len(gpu[name].records))
        launches.update(got)
        s = gpu[name].summary()
        rep["paths"][name] = {
            "launches": got, "rounds_with_a_group": n_grp, "first_run_s": wall,
            **{k: s[k] for k in ("final_accuracy", "rejected_nonfinite",
                                 "rejected_norm", "quorum_skips",
                                 "robust_rejected", "robust_trimmed")},
            "pipeline": stats}
        print(f"chaos {name}: {got} over {n_grp} rounds with a group; accuracy "
              f"{s['final_accuracy']:.3f}, rejected non-finite "
              f"{s['rejected_nonfinite']}, norm {s['rejected_norm']}, quorum "
              f"skips {s['quorum_skips']}" + ("" if stats is None else (
                  f"; {stats['graph_replays']} rounds replayed from "
                  f"{stats['graph_captures']} new graphs" if stats["graphed"]
                  else "; eager rounds")))
    # the gates
    if not same_run(torch, gpu["clean"], sims["clean"], gpu["guard, no faults"],
                    sims["guard, no faults"]):
        fail("chaos: the guard without faults differs from no guard, bitwise")
    clean_acc = gpu["clean"].summary()["final_accuracy"]
    for name in guarded:
        s = gpu[name].summary()
        if not torch.isfinite(sims[name].flat_params).all() or \
                s["rejected_nonfinite"] + s["rejected_norm"] == 0:
            fail(f"chaos {name}: non-finite params or nothing rejected ({s})")
        rep["paths"][name]["gap_to_clean"] = s["final_accuracy"] - clean_acc
    # the example's accuracy gate at the size its own check runs; at full
    # size the guarded runs end far below clean, an open fault (ROADMAP
    # queue 3) whose gaps are printed below, beside the CPU runs'
    print("chaos: examples/chaos_round.py's own check (--smoke) on the card:")
    if chaos_round.main(["--smoke", "--device", "cuda",
                         "--tolerance", str(CHAOS_TOLERANCE)]) != 0:
        fail("chaos: repro_torch.chaos_round --smoke failed its gates")
    k4 = f"guard=reject K={CHUNK_K}"
    if not same_run(torch, gpu["guard=reject"], sims["guard=reject"], gpu[k4],
                    sims[k4]):
        fail(f"chaos {k4}: differs from K = 1, bitwise")
    if rep["paths"][k4]["launches"] != rep["paths"]["guard=reject"]["launches"]:
        fail(f"chaos {k4}: launches differ from K = 1's")
    off = "guard=clip+reject, kernels off"
    if not same_run(torch, gpu[off], sims[off], gpu[f"{off} flat"],
                    sims[f"{off} flat"]) or \
            guard_counts(gpu[off]) != guard_counts(gpu[f"{off} flat"]):
        fail(f"chaos {off}: the flat path differs from the fused one, bitwise")
    flat, fused = gpu["guard=clip+reject flat"], gpu["guard=clip+reject"]
    if [host(r) for r in flat.records] != [host(r) for r in fused.records] or \
            guard_counts(flat) != guard_counts(fused):
        fail("chaos guard=clip+reject flat: host records or guard counters "
             "differ from the fused run's")
    cpu_acc = {}
    for name, (kw, faulted, _) in runs.items():
        cpu = Simulator(SimConfig(**kw), device="cpu",
                        fault_plan=plan if faulted else None).run()
        if [host(r) for r in gpu[name].records] != [host(r) for r in cpu.records] \
                or guard_counts(gpu[name]) != guard_counts(cpu) \
                or robust_counts(gpu[name]) != robust_counts(cpu):
            fail(f"chaos {name}: host records or guard / robust counters "
                 "differ from the CPU run's")
        cpu_acc[name] = cpu.summary()["final_accuracy"]
        rep["paths"][name]["cpu_final_accuracy"] = cpu_acc[name]
    print("chaos full size (open fault: the example's 0.15 gate is not met), "
          "final accuracy on the card / on the CPU (plain versions): "
          + ", ".join(f"{n} {gpu[n].summary()['final_accuracy']:.4f} / "
                      f"{cpu_acc[n]:.4f}" for n in
                      ("clean", "guard=off", "guard=reject",
                       "guard=clip+reject")))
    print("chaos gates: guard without faults == no guard bitwise; guarded runs "
          f"finite and rejecting rows; K = {CHUNK_K} == K = 1 bitwise; kernels "
          "off, flat == fused bitwise; the flat twin's host records and guard "
          "counters == fused; host records and guard / robust counters of all "
          f"{len(runs)} runs == CPU runs")
    # warm runs: rounds/s, captures; the eager twin bitwise the graphed run
    rep["timed"] = {}
    timed = {n: (runs[n][0], False) for n in
             ("clean", "guard=off", "guard=reject", "guard=clip+reject",
              "RELAY+YoGi guard=reject", k4)}
    timed["guard=reject eager"] = (runs["guard=reject"][0], True)
    for name, (kw, eager) in timed.items():
        sim = Simulator(SimConfig(**kw), device="cuda",
                        fault_plan=None if name == "clean" else plan)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acct, stats = drive(sim, eager)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if eager and not same_run(torch, gpu["guard=reject"],
                                  sims["guard=reject"], acct, sim):
            fail("chaos guard=reject: the eager rounds differ from the "
                 "graphed ones, bitwise")
        rep["timed"][name] = {"rounds": len(acct.records), "seconds": secs,
                              "rounds_per_s": len(acct.records) / secs,
                              "graph_captures": stats["graph_captures"],
                              "graph_capture_s": stats["graph_capture_s"]}
        print(f"chaos {name}: {len(acct.records)} rounds in {secs:.3f}s = "
              f"{len(acct.records) / secs:.1f} rounds/s warm, "
              f"{stats['graph_captures']} captures ({card_line()})")
    # the screen: host and device ms from a profile of the eager run, and
    # alone at the path's padded shape
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        n_rec = len(drive(Simulator(SimConfig(**runs["guard=reject"][0]),
                                    device="cuda", fault_plan=plan), True)[0]
                    .records)
        torch.cuda.synchronize()
    # the host-side span events (their device-side mirrors are ranges,
    # not work): host time, and the device time of the kernels inside
    spans = [e for e in prof.events() if e.name == "round.screen"
             and e.device_type.name == "CPU"]
    if not spans:
        fail("chaos: no round.screen span in the eager guard=reject profile")
    dev_ms = sum(e.device_time_total for e in spans) / 1e3
    rep["screen_profile"] = {"rounds": n_rec, "calls": len(spans),
                             "host_ms": sum(e.cpu_time_total for e in spans) / 1e3,
                             "device_ms": dev_ms or None}
    from repro_torch.core.aggregation import screen_rows
    n_pad = 16
    u = torch.randn((1, n_pad, MAIN_D), generator=torch.Generator(
        device="cuda").manual_seed(1), device="cuda")
    u[..., 12835:] = 0.0
    valid = torch.arange(n_pad, device="cuda")[None] < 13
    screen = lambda: screen_rows(u, valid, clip=None, reject_mult=5.0,
                                 norm_d=12835)
    rep["screen_alone"] = {"shape": [1, n_pad, MAIN_D],
                           "ms": time_ms(torch, screen, 200),
                           "device_ms": graph_ms(torch, screen)}
    print(f"chaos screen: profile of the eager guard=reject run, {len(spans)} "
          f"calls: host {rep['screen_profile']['host_ms']:.2f} ms, device "
          + ("not measured" if not dev_ms else f"{dev_ms:.3f} ms")
          + f" ({n_rec} rounds); alone at (1, {n_pad}, {MAIN_D}): "
          f"{rep['screen_alone']['ms']:.4f} ms events, "
          f"{rep['screen_alone']['device_ms']:.4f} ms graph replay ({card_line()})")
    # the crash: soft, after round 15, snapshots every 5, resumed
    rep["crash_resume"] = {}
    for k in (1, CHUNK_K):
        cfg = SimConfig(**runs["guard=reject"][0], rounds_per_dispatch=k)
        out = chaos_round.crash_resume(cfg, plan, device="cuda",
                                       crash_after=CHAOS_CRASH[0],
                                       checkpoint_every=CHAOS_CRASH[1])
        (ref, ref_sim), (got, sim) = out["ref"], out["resumed"]
        st = out["pipeline"].stats
        tail = sum(1 for r in ref.records if r.round_idx >= out["next_round"])
        if not same_run(torch, ref, ref_sim, got, sim) or \
                guard_counts(got) != guard_counts(ref):
            fail(f"chaos crash K={k}: the resumed run differs from the "
                 "uninterrupted one, bitwise")
        if st.graph_captures or st.graph_replays != tail:
            fail(f"chaos crash K={k}: the resume captured {st.graph_captures} "
                 f"graphs and replayed {st.graph_replays} of {tail} rounds")
        rep["crash_resume"][f"K={k}"] = {"next_round": out["next_round"],
                                          "resumed_rounds": tail,
                                          "captures_on_resume": 0}
        print(f"chaos crash K={k}: crashed after round {CHAOS_CRASH[0]}, resumed "
              f"at {out['next_round']}; {tail} rounds replayed from the crashed "
              "run's graphs, 0 captures; records, params and guard counters "
              "== the uninterrupted run, bitwise")
    # the sweep CLI: a hard crash (SIGKILL) after round 3, then --resume
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, out_json = os.path.join(tmp, "sweep.pkl"), os.path.join(tmp, "r.json")

        def cli(*args):
            return subprocess.run([sys.executable, "-m", "repro_torch.sweeps",
                                   *args], cwd=ROOT, env=env, text=True,
                                  capture_output=True, timeout=600)
        crashed = cli("--smoke", "--checkpoint", ckpt, "--crash-after", "3",
                      "--crash-hard")
        if crashed.returncode not in (137, -9):
            fail(f"sweep CLI --crash-hard exited {crashed.returncode}, not 137: "
                 f"{crashed.stderr[-2000:]}")
        resumed = cli("--resume", ckpt, "--out", out_json)
        if resumed.returncode != 0:
            fail(f"sweep CLI --resume failed: {resumed.stderr[-2000:]}")
        got = json.loads(Path(out_json).read_text())["results"]
    clean, _ = run_batched(demo_spec(True).expand(), device="cuda")
    if got != json.loads(json.dumps(clean.to_json_dict())):
        fail("sweep CLI: the resumed sweep's results differ from an "
             "uninterrupted smoke sweep's")
    rep["cli_hard_crash"] = {"exit": crashed.returncode,
                             "resumed_cells": len(got["cells"])}
    print(f"sweep CLI --crash-after 3 --crash-hard: killed by SIGKILL (exit "
          f"{crashed.returncode}); --resume: {len(got['cells'])} cells == the "
          "uninterrupted smoke sweep")
    return rep, ns


def log_diff(got, want, n_test):
    """Two round logs (event lists) compared: (the first int or host field
    that differs, as (round, key, got, want), or None; the largest
    relative difference of their l2 and loss columns; the largest accuracy
    difference in test samples)."""
    from repro_torch.telemetry.schema import LANE_INT_FIELDS
    exact = LANE_INT_FIELDS | {"event", "cell", "sim_time", "resource_used",
                               "resource_wasted", "unique_participants"}
    if len(got) != len(want):
        return ("length", len(got), len(want)), None, None
    first, rel, acc = None, 0.0, 0.0
    for a, b in zip(got, want):
        if list(a) != list(b):
            return ("keys", a["round"]), None, None
        for k in a:
            if k in exact:
                if a[k] != b[k] and first is None:
                    first = (a["round"], k, a[k], b[k])
            elif k == "accuracy":
                if (a[k] is None) != (b[k] is None):
                    first = first or (a["round"], k, a[k], b[k])
                elif a[k] is not None:
                    acc = max(acc, abs(a[k] - b[k]) * n_test)
            elif a[k] is not None and b[k] is not None:
                rel = max(rel, abs(a[k] - b[k]) / max(abs(b[k]), 1e-4))
    return first, rel, acc


def telemetry_paths(torch, launches) -> dict:
    """Telemetry on the card (``repro_torch.telemetry``; level 2 = the
    round-stats lane inside the round's CUDA graph and the per-round JSONL
    log).  Gates: (a) level-2 RELAY (kernel 1) and RELAY+YoGi (kernel 2)
    at the quickstart's full size graphed, each bit for bit its level-0
    run in params, records and launches; (b) each one's level-2 round log
    at K = 4 and with its rounds dispatched eagerly byte-equal to its
    K = 1 graphed log; (c) the chaos harness's guard=reject run at level 2
    crashed after round 15 (snapshots every 6, so rounds 12-15 are logged
    past the last one) and resumed into its directory, at K = 1 and 4:
    the round log byte-equal and the in-memory round events equal to the
    uninterrupted run's, no graph captured on resume; (d) the card's round
    logs against CPU runs: int and host fields equal at full size (RELAY,
    guard=reject), the l2 and loss columns within rtol 1e-3 (relative to
    at least 1e-4) and accuracy within one test sample on small runs
    (the small-run GPU-vs-CPU rule; the full-size float gaps are printed);
    (e) the sweep CLI with ``--telemetry-dir`` on the ``--smoke`` grid (a
    line a cell and recorded round, a trace that loads, guard counters
    equal to the cells') and a guarded sweep under the chaos plan in
    process (``metrics.prom``'s guard counters equal the accountings').
    Also a level-1 flat twin (kernel 3, spans, no round log) and
    coord_median at level 2 under the race's attack (kernel 7, eager;
    its robust columns sum to its counters), each bit for bit its level-0
    run.  Numbers: warm rounds/s of RELAY at levels 0, 1 and 2,
    interleaved ``TELEMETRY_REPS`` times; the lane's device ms alone at
    ``LANE_SHAPE`` and a level-2 round graph's replay beside the level-0
    one of the same bucket; d2h bytes a chunk; the snapshot seconds from
    the ``checkpoint`` span's histogram."""
    import os
    import tempfile
    from repro_torch import chaos_round
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.staleness_agg import ops as saa_ops
    from repro_torch.kernels.trimmed_agg import ops as trim_ops
    from repro_torch.faults import FaultPlan, FaultSpec
    from repro_torch.quickstart import CAMPAIGNS, COMMON
    from repro_torch.sim import SimConfig, Simulator
    from repro_torch.sim.pipeline import RoundPipeline, lane_norms
    from repro_torch.sweeps import SweepRunner, SweepSpec
    from repro_torch.telemetry import TelemetrySession
    from repro_torch.telemetry.schema import GUARD_COUNTERS
    common, plan = chaos_round.build(False)
    modes = {label: extra for label, extra, _ in chaos_round.GUARD_MODES}
    chaos_reject = dict(common, use_agg_kernel=True, **modes["guard=reject"])
    yogi = dict(CAMPAIGNS["RELAY"], server_opt="yogi")
    runs = {     # name -> (config, faulted, kernel)
        "RELAY": (dict(COMMON, **CAMPAIGNS["RELAY"]), False, APPLY),
        "RELAY+YoGi": (dict(COMMON, **yogi), False, AGG),
        "RELAY flat": (dict(COMMON, **CAMPAIGNS["RELAY"], fused_rounds=False),
                       False, CELL_AGG),
        "coord_median": (dict(RACE, aggregator="coord_median"), False, TRIM),
        "chaos guard=reject": (chaos_reject, True, APPLY),
    }
    rep = {"paths": {}}
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    n_dirs = [0]

    def run(name, level, k=1, eager=False, device="cuda", gate=True):
        """``runs[name]`` at ``level`` (from level 1 with a session logging
        into a directory of its own), the launches gated; returns
        (Accounting, Simulator, stats dict or None, the round log's bytes,
        launches, session, seconds from the pipeline's construction to the
        run's end)."""
        kw, faulted, kernel = runs[name]
        n_dirs[0] += 1
        d = os.path.join(tmp, f"run{n_dirs[0]}")
        sim = Simulator(SimConfig(**kw, telemetry=level, rounds_per_dispatch=k),
                        device=device, fault_plan=plan if faulted else None)
        sess = TelemetrySession(d if level else None)
        LAUNCHES.clear()
        stats = None
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if sim.cfg.fused_rounds:
            pipe = RoundPipeline([sim], telemetry=sess)
            if eager:
                pipe.graphs, pipe.stats.graphed = None, False
            acct, = pipe.run()
            stats = pipe.stats.as_dict()
        else:
            acct = sim.run(telemetry=sess)
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        sess.close()
        got = dict(LAUNCHES)
        if gate and device == "cuda":
            want = expected_launches(saa_ops, trim_ops, kernel, acct)
            if got != want or not want:
                fail(f"telemetry {name} level {level}: launches {got}, expected "
                     f"{want} (one per round with a group)")
            if stats is not None and not eager:
                graph_gate(f"telemetry {name} level {level} K={k}", stats,
                           kernel, len(acct.records))
            launches.update(got)
        log = Path(d, "rounds.jsonl").read_bytes() if level else b""
        if level >= 2 and sim.cfg.fused_rounds:
            n_logged = log.count(b"\n")
            if n_logged != len(acct.records) or \
                    len(acct.round_events) != len(acct.records):
                fail(f"telemetry {name}: {n_logged} logged rounds, "
                     f"{len(acct.round_events)} in memory, "
                     f"{len(acct.records)} recorded")
        elif log or acct.round_events:
            fail(f"telemetry {name} level {level}: a round log below level 2 "
                 "or on the flat path")
        return acct, sim, stats, log, got, sess, secs

    # (a), (b): level 2 == level 0; K = 4 and eager logs == the K = 1 log
    out = {}
    for name in ("RELAY", "RELAY+YoGi"):
        a0, s0, st0, _, got0, _, _ = run(name, 0)
        a2, s2, st2, log2, got2, _, _ = run(name, 2)
        if not same_run(torch, a0, s0, a2, s2) or got0 != got2:
            fail(f"telemetry {name}: level 2 differs from level 0 (records, "
                 f"params, launches {got2} vs {got0})")
        if not st2["graphed"]:
            fail(f"telemetry {name}: level 2 not graphed")
        a4, s4, st4, log4, got4, _, _ = run(name, 2, k=CHUNK_K)
        ae, se, _, loge, _, _, _ = run(name, 2, eager=True, gate=False)
        if log4 != log2 or got4 != got2 or not same_run(torch, a2, s2, a4, s4):
            fail(f"telemetry {name} K={CHUNK_K}: round log or run differs from "
                 "K = 1's")
        if loge != log2 or not same_run(torch, a2, s2, ae, se):
            fail(f"telemetry {name}: the eager round log or run differs from "
                 "the graphed one")
        out[name] = (a2, st2, st4)
        rep["paths"][name] = {
            "launches": got2, "rounds": len(a2.records),
            "log_bytes": len(log2), "d2h_bytes": st2["d2h_bytes"],
            "chunks": st2["dispatches"]["round"],
            "d2h_bytes_per_chunk": st2["d2h_bytes"] / st2["dispatches"]["round"],
            f"d2h_bytes_per_chunk_K{CHUNK_K}":
                st4["d2h_bytes"] / st4["dispatches"]["round"],
            "graph_replays": st2["graph_replays"]}
        print(f"telemetry {name}: level 2 graphed == level 0 bitwise (records, "
              f"params, launches {got2}); round log {len(log2)} bytes, "
              f"K={CHUNK_K} and eager logs byte-equal; d2h "
              f"{rep['paths'][name]['d2h_bytes_per_chunk']:.0f} B a chunk at K = 1, "
              f"{rep['paths'][name][f'd2h_bytes_per_chunk_K{CHUNK_K}']:.0f} at "
              f"K = {CHUNK_K}")
    # the level-1 flat twin (kernel 3) and coord_median at level 2 (kernel 7)
    f0, fs0, _, _, fg0, _, _ = run("RELAY flat", 0)
    f1, fs1, _, _, fg1, fsess, _ = run("RELAY flat", 1)
    spans = {e["name"] for e in fsess.tracer.events}
    if not same_run(torch, f0, fs0, f1, fs1) or fg0 != fg1 or \
            not {"schedule", "dispatch", "fetch", "eval"} <= spans:
        fail(f"telemetry RELAY flat level 1: differs from level 0 or spans "
             f"{sorted(spans)} incomplete")
    c0, cs0, _, _, cg0, _, _ = run("coord_median", 0)
    c2, cs2, cst2, _, cg2, _, _ = run("coord_median", 2)
    trimmed = sum(e["robust_trimmed"] for e in c2.round_events)
    if not same_run(torch, c0, cs0, c2, cs2) or cg0 != cg2 or cst2["graphed"] \
            or trimmed != c2.summary()["robust_trimmed"] or not trimmed:
        fail(f"telemetry coord_median level 2: differs from level 0, graphed, or "
             f"its robust_trimmed column sums to {trimmed}, not "
             f"{c2.summary()['robust_trimmed']}")
    rep["paths"]["RELAY flat level 1"] = {"launches": fg1, "spans": sorted(spans)}
    rep["paths"]["coord_median"] = {"launches": cg2, "robust_trimmed": trimmed}
    print(f"telemetry RELAY flat level 1 (spans {sorted(spans)}, no round log) "
          f"and coord_median level 2 (eager, robust_trimmed column {trimmed}) "
          f"== level 0 bitwise; launches {fg1}, {cg2}")
    # (c) crash after round 15 (snapshots every 6) and resume, K = 1 and 4
    rep["crash_resume"] = {}
    snap = []
    for k in (1, CHUNK_K):
        cfg = SimConfig(**chaos_reject, telemetry=2, rounds_per_dispatch=k)
        res = chaos_round.crash_resume(cfg, plan, device="cuda",
                                       crash_after=CHAOS_CRASH[0],
                                       checkpoint_every=TELEMETRY_CKPT_EVERY)
        (ref, ref_sim), (got, sim) = res["ref"], res["resumed"]
        st = res["pipeline"].stats
        size, offset = res["truncated"]
        clean_log, resumed_log = res["logs"]
        if not same_run(torch, ref, ref_sim, got, sim) or \
                clean_log != resumed_log or not clean_log or \
                got.round_events != ref.round_events:
            fail(f"telemetry crash K={k}: the resumed run or its round log "
                 "differs from the uninterrupted one")
        if not 0 < offset < size or st.graph_captures:
            fail(f"telemetry crash K={k}: log {size} B, snapshot offset {offset}, "
                 f"{st.graph_captures} captures on resume")
        n_snap, snap_s = res["snapshots"]
        snap.append((snap_s, n_snap))
        rep["crash_resume"][f"K={k}"] = {
            "next_round": res["next_round"], "crashed_log_bytes": size,
            "snapshot_offset": offset, "log_bytes": len(clean_log),
            "snapshots": n_snap, "snapshot_s_sum": snap_s}
        print(f"telemetry crash K={k}: crashed after round {CHAOS_CRASH[0]} with "
              f"{size - offset} B of rounds past the last snapshot; resumed at "
              f"{res['next_round']} with 0 captures; round log byte-equal "
              f"({len(clean_log)} B), round events == the uninterrupted run's")
    n_snap = sum(c for _, c in snap)
    rep["snapshot_s_mean"] = sum(s for s, _ in snap) / n_snap
    print(f"telemetry snapshots: {n_snap} taken, "
          f"{rep['snapshot_s_mean'] * 1e3:.3f} ms each on average (checkpoint "
          f"span histogram; chaos guard=reject, full size) ({card_line()})")
    # (d) the card's round logs against CPU runs
    rep["cpu"] = {}
    for name in ("RELAY", "chaos guard=reject"):
        a_gpu = out[name][0] if name in out else run(name, 2)[0]
        a_cpu, sim_cpu = run(name, 2, device="cpu", gate=False)[:2]
        n_test = len(sim_cpu.substrate.data.y_test)
        first, rel, acc = log_diff(a_gpu.round_events, a_cpu.round_events, n_test)
        if first is not None:
            fail(f"telemetry {name}: the card's round log differs from the "
                 f"CPU's at {first}")
        rep["cpu"][name] = {"float_max_rel": rel, "accuracy_max_samples": acc}
        print(f"telemetry {name} (full size): round log int and host fields == "
              f"the CPU run's; l2/loss columns max rel diff {rel:.3g}, accuracy "
              f"max {acc:.0f} test samples (free-running, not gated)")
    small = dict(n_learners=30, rounds=8, eval_every=4, seed=2, n_target=4,
                 mapping="label_uniform", use_agg_kernel=True, selector="priority",
                 saa=True, apt=True, scaling_rule="relay", telemetry=2)
    small_plan = FaultPlan(n_learners=30, rounds=8, specs=plan.specs,
                           seed=plan.seed)
    for label, kw, fp in (("RELAY", {}, None),
                          ("guard=reject", modes["guard=reject"], small_plan)):
        sims = {dv: Simulator(SimConfig(**small, **kw), device=dv,
                              fault_plan=fp) for dv in ("cuda", "cpu")}
        accts = {dv: sim.run() for dv, sim in sims.items()}
        n_test = len(sims["cpu"].substrate.data.y_test)
        first, rel, acc = log_diff(accts["cuda"].round_events,
                                   accts["cpu"].round_events, n_test)
        if first is not None or rel > 1e-3 or acc > 1:
            fail(f"telemetry small {label}: round log vs CPU: first exact "
                 f"difference {first}, float max rel {rel}, accuracy {acc} "
                 "test samples")
        rep["cpu"][f"small {label}"] = {"float_max_rel": rel,
                                        "accuracy_max_samples": acc}
    print(f"telemetry small RELAY and guard=reject: round logs == CPU runs' "
          f"(int fields equal, floats rel "
          f"{max(rep['cpu'][f'small {x}']['float_max_rel'] for x in ('RELAY', 'guard=reject')):.3g}"
          f" <= 1e-3)")
    # (e) the sweep CLI with --telemetry-dir, and a guarded sweep in process
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    d = os.path.join(tmp, "cli")
    out_json = os.path.join(tmp, "cli.json")
    cli = subprocess.run([sys.executable, "-m", "repro_torch.sweeps", "--smoke",
                          "--telemetry-dir", d, "--out", out_json], cwd=ROOT,
                         env=env, text=True, capture_output=True, timeout=600)
    if cli.returncode != 0:
        fail(f"sweep CLI --telemetry-dir failed: {cli.stderr[-2000:]}")
    cells = json.loads(Path(out_json).read_text())["results"]["cells"]
    lines = Path(d, "rounds.jsonl").read_text().splitlines()
    names = Counter(json.loads(x)["cell"] for x in lines)
    trace = json.loads(Path(d, "trace.json").read_text())["traceEvents"]
    prom = Path(d, "metrics.prom").read_text()
    want_guard = {k: sum(c["summary"][k[len("guard_"):]] for c in cells)
                  for k in GUARD_COUNTERS}
    got_guard = {k: int(re.search(rf"^{k} (\d+)$", prom, re.M).group(1))
                 for k in GUARD_COUNTERS}
    if names != {c["name"]: c["summary"]["rounds"] for c in cells} or \
            not trace or got_guard != want_guard:
        fail(f"sweep CLI --telemetry-dir: lines a cell {dict(names)}, "
             f"{len(trace)} trace events, guard counters {got_guard} vs {want_guard}")
    guard_cells = SweepSpec(axes={"hardware": HARDWARE[:2]},
                            base=dict(small, **modes["guard=reject"]),
                            seeds=(0, 1)).expand()
    dense = FaultPlan(n_learners=30, rounds=8, seed=2, specs=(
        FaultSpec("nan", prob=0.3), FaultSpec("scale", prob=0.2, scale=1e4)))
    sess = TelemetrySession(os.path.join(tmp, "guarded_sweep"))
    res = SweepRunner(guard_cells, device="cuda", fault_plan=dense,
                      telemetry=sess).run()
    sess.close()
    prom = Path(tmp, "guarded_sweep", "metrics.prom").read_text()
    got_guard = {k: int(re.search(rf"^{k} (\d+)$", prom, re.M).group(1))
                 for k in GUARD_COUNTERS}
    want_guard = {k: sum(r.summary[k[len("guard_"):]] for r in res)
                  for k in GUARD_COUNTERS}
    if got_guard != want_guard or not want_guard["guard_rejected_nonfinite"] \
            or not want_guard["guard_rejected_norm"]:
        fail(f"guarded sweep: metrics.prom {got_guard}, accountings {want_guard}")
    rep["sweep_cli"] = {"cells": len(cells), "lines": len(lines),
                        "trace_events": len(trace)}
    rep["guarded_sweep"] = got_guard
    print(f"telemetry sweep CLI --smoke --telemetry-dir: {len(lines)} round log "
          f"lines for {len(cells)} cells (one a cell and recorded round), "
          f"{len(trace)} trace events, guard counters == the cells'; guarded "
          f"sweep of {len(guard_cells)} cells: metrics.prom guard counters "
          f"{got_guard} == the accountings'")
    # rounds/s at levels 0, 1 and 2, interleaved in turns (warm: each
    # level's graphs captured by a first run)
    timed = {level: [] for level in (0, 1, 2)}
    for level in timed:
        run("RELAY", level, gate=False)
    for _ in range(TELEMETRY_REPS):
        for level in timed:
            res = run("RELAY", level, gate=False)
            timed[level].append(len(res[0].records) / res[-1])
    rep["rounds_per_s"] = {f"level {lv}": v for lv, v in timed.items()}
    print("telemetry RELAY warm rounds/s (in turns): " + "; ".join(
        f"level {lv} " + ", ".join(f"{x:.1f}" for x in v)
        for lv, v in timed.items()) + f" ({card_line()})")
    # the lane alone, and a level-2 round graph beside the level-0 one
    gen = torch.Generator(device="cuda").manual_seed(3)
    u = torch.randn(LANE_SHAPE, generator=gen, device="cuda")
    u[..., 12835:] = 0.0
    valid = torch.arange(LANE_SHAPE[1], device="cuda")[None] < 13
    rep["lane_alone"] = {"shape": list(LANE_SHAPE),
                         "device_ms": graph_ms(torch, lambda: lane_norms(
                             u, valid, 12835), 200)}
    wss = {}
    for level in (0, 2):
        sim = Simulator(SimConfig(**runs["RELAY"][0], telemetry=level),
                        device="cuda")
        pipe = RoundPipeline([sim])
        wss[level] = pipe._ws
        pipe.run()
    common_b = set(wss[0]._graphs) & set(wss[2]._graphs)
    bucket = max(common_b, key=lambda b: (b.n, b.rows))
    rep["round_graph"] = {"bucket": list(bucket), **{
        f"level {lv}_ms": time_ms(torch, wss[lv]._graphs[bucket].graph.replay,
                                  200) for lv in (0, 2)}}
    print(f"telemetry lane: alone at {LANE_SHAPE} {rep['lane_alone']['device_ms']:.4f} "
          f"ms graph replay; a RELAY round graph at bucket {tuple(bucket)}: "
          f"level 0 {rep['round_graph']['level 0_ms']:.4f} ms, level 2 "
          f"{rep['round_graph']['level 2_ms']:.4f} ms a replay ({card_line()})")
    tmp_dir.cleanup()
    return rep


# --- the federated LM learner ---------------------------------------------


# ---------------------------------------------------------------------------
# The sharding phase: participant and sweep-axis sharding on ranks of a
# torch.distributed group (repro_torch.sim.participant_sharding)
# ---------------------------------------------------------------------------


def _sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _shard_result(torch, acct, sim, stats=None, launched=None, wall=None):
    """A run as host objects a rank can send back: its records (every
    field, and the host fields), params and YoGi state (CPU tensors), the
    pipeline's stats, the launches counted over it, its wall seconds."""
    opt = sim.flat_opt_state
    return {"records": [record_bits(r) for r in acct.records],
            "host": [host(r) for r in acct.records],
            "summary": dict(acct.summary()),
            "params": sim.flat_params.detach().cpu(),
            "opt": None if opt is None else {k: v.detach().cpu()
                                             for k, v in opt.items()},
            "stats": stats, "launches": dict(launched or {}), "s": wall,
            "aggregated": aggregated(acct), "rows": [
                r.n_fresh + r.n_stale for r in acct.records
                if r.n_fresh + r.n_stale > 0]}


def _timed_run(torch, sim, eager=False):
    """``sim``'s fused run with the launch counters zeroed just before it
    and read just after, timed to the card's last kernel; ``eager`` turns
    the round graphs off (``drive``'s switch)."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.sim.pipeline import RoundPipeline
    pipe = RoundPipeline([sim])
    if eager:
        pipe.graphs, pipe.stats.graphed = None, False
    _sync(torch)
    LAUNCHES.clear()
    t0 = time.perf_counter()
    acct = pipe.run()[0]
    _sync(torch)
    return _shard_result(torch, acct, sim, pipe.stats.as_dict(), LAUNCHES,
                         time.perf_counter() - t0)


def _reduce_ms(torch, group, n, reps=50):
    """ms of one ``all_reduce`` of a (1, n, MAIN_D) operand on ``group``
    (host clock to the card's last kernel: gloo stages through the host)."""
    import torch.distributed as dist
    u = torch.zeros((n, MAIN_D), device=SHARD_DEVICE)
    for _ in range(3):
        dist.all_reduce(u, group=group)
    _sync(torch)
    t0 = time.perf_counter()
    for _ in range(reps):
        dist.all_reduce(u, group=group)
    _sync(torch)
    return (time.perf_counter() - t0) * 1e3 / reps


def _shard_prepare(torch):
    """A spawned rank's set-up: the kernels built by the parent, loaded;
    the plain versions' matmuls in fp32, as in the parent."""
    from repro_torch.kernels import _build
    from repro_torch.sim.learner import fp32_matmuls
    if SHARD_DEVICE == "cuda":
        _build.build_all()
    fp32_matmuls()


def _shard_rank_nccl(rank, relay, reps):
    """Check (a) on a one-rank NCCL group: the quickstart's RELAY campaign
    unsharded and with ``shard_participants=4`` (clamped to the group's one
    rank), in turns, ``reps`` times each; then the reduction's time on the
    campaign's operand shape."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.aggregation import bucket_block
    from repro_torch.sim import SimConfig, Simulator
    from repro_torch.sim.pipeline import N_BLOCK
    _shard_prepare(torch)
    runs = []
    for _ in range(reps):
        for n_p in (0, 4):
            sim = Simulator(SimConfig(**relay, shard_participants=n_p),
                            device=SHARD_DEVICE)
            runs.append(_timed_run(torch, sim))
    rows = sorted(runs[-1]["rows"])
    n = bucket_block(rows[len(rows) // 2], N_BLOCK)
    u = torch.zeros((n, MAIN_D), device=SHARD_DEVICE)
    return {"runs": runs, "reduce_n": n,
            "reduce_ms": _reduce_ms(torch, dist.group.WORLD, n, reps=200),
            "reduce_graph_ms": graph_ms(torch, lambda: dist.all_reduce(u),
                                        replays=200)}


def _shard_rank_gloo(rank, sub10k):
    """Checks (b)-(d) on this rank of a two-rank gloo group sharing the
    card: 10,000 learners split over "p", an S = 8 YoGi sweep split over
    "s" (early stops repack it across the boundary), a trimmed-mean cell
    of 64-row groups; then the reduction's time on (b)'s operand shape."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.aggregation import bucket_block
    from repro_torch.kernels import LAUNCHES
    from repro_torch.sim import SimConfig, Simulator
    from repro_torch.sim.pipeline import N_BLOCK
    from repro_torch.sweeps import SweepRunner, SweepSpec
    _shard_prepare(torch)
    cells = SweepSpec(**SHARD_SWEEP).expand()
    for _ in range(2):     # the first pass pays the process's first uses
        out = {"10k": _timed_run(torch, Simulator(
            SimConfig(**SHARD_10K, shard_participants=True), sub10k,
            device=SHARD_DEVICE))}
        _sync(torch)
        LAUNCHES.clear()
        t0 = time.perf_counter()
        runner = SweepRunner(cells, device=SHARD_DEVICE, shard=True)
        res = runner.run()
        _sync(torch)
        wall = time.perf_counter() - t0
        out["sweep"] = {"cells": [_shard_result(torch, r.acct, sim)
                                  for r, sim in zip(res, runner.sims)],
                        "stats": runner.batch_stats,
                        "launches": dict(LAUNCHES), "s": wall,
                        "mesh": runner.mesh.shape}
        out["trimmed"] = _timed_run(torch, Simulator(
            SimConfig(**SHARD_TRIMMED, shard_participants=True),
            device=SHARD_DEVICE))
    rows = sorted(out["10k"]["rows"])
    n = bucket_block(rows[len(rows) // 2], N_BLOCK)
    out["reduce_n"] = n
    out["reduce_ms"] = _reduce_ms(torch, dist.group.WORLD, n)
    return out


def sharding_paths(torch, launches) -> dict:
    """The sharding phase: the checks (a)-(d) below, each in ranks this
    script spawns (``run_ranks``), with the launch counters of each rank
    zeroed just before each sharded run and read just after; the
    unsharded runs they are held to run in this process.

      (a) the quickstart's RELAY campaign with ``shard_participants=4`` on
          a one-rank NCCL group (clamped to one shard), graphed, the
          round's all-reduce inside its graph: records, params bit for bit
          the unsharded run's (int32 views, the signs of zeros included);
          kernel 1 once a round that aggregated, one all-reduce each;
      (b) two gloo ranks sharing the card, 10,000 learners, a 64-learner
          cohort split over "p": host records ``==`` the unsharded run's,
          stragglers landing across the split, kernel 1 once a round that
          aggregated on each rank;
      (c) two gloo ranks, an S = 8 YoGi sweep on "s" whose early stops
          repack cells across the boundary: each cell's host records
          ``==`` the unsharded sweep's, kernel 2 once a rank's batch-round;
      (d) two gloo ranks, trimmed_mean with 64-row groups: kernel 7 on its
          ``sort`` variant, once a round that aggregated.

    Params of (b)-(d) are held bit for bit where the cuBLAS probe finds a
    batched GEMM's matrix the same at every batch count the runs take
    (each rank trains about half the rows), else within SWEEP_RTOL /
    SWEEP_ATOL (the sweep phase's gate).  Two ranks sharing one card
    measure correctness and overhead, not a multi-card speed-up."""
    from repro_torch.kernels.staleness_agg import ops as saa_ops
    from repro_torch.kernels.trimmed_agg import ops as trim_ops
    from repro_torch.sim import SimConfig, Simulator, Substrate
    from repro_torch.sim.participant_sharding import run_ranks
    from repro_torch.sweeps import SweepRunner, SweepSpec
    from repro_torch.quickstart import CAMPAIGNS, COMMON
    out = {}
    gen = torch.Generator(device=SHARD_DEVICE).manual_seed(7)
    counts = (1, 2, 4, 8, 16, 32, 64, 128)
    probe = gemm_probe(torch, gen, counts)
    exact = all(all(v.values()) for v in probe.values())
    out["exact"] = exact
    gate = ("bit for bit" if exact else
            f"host records ==, params within rtol {SWEEP_RTOL} / atol {SWEEP_ATOL}")
    print(f"sharding: cuBLAS batched GEMM probe at R in {counts}: " + "; ".join(
        f"{g}: differs at R in {[r for r, e in v.items() if not e]}"
        for g, v in probe.items()) + f"; gate for (b)-(d): {gate}")

    def same_bits(a, b) -> bool:
        return (a["records"] == b["records"]
                and bits_equal(torch, a["params"], b["params"])
                and (a["opt"] is None or all(
                    bits_equal(torch, a["opt"][k], b["opt"][k])
                    if a["opt"][k].is_floating_point()
                    else torch.equal(a["opt"][k], b["opt"][k])
                    for k in a["opt"])))

    def held(name, got, want):
        if got["host"] != want["host"]:
            fail(f"sharding {name}: host records differ from the unsharded run")
        if got["summary"]["rounds"] != want["summary"]["rounds"]:
            fail(f"sharding {name}: rounds differ")
        same = same_bits(got, want)
        if exact and not same:
            fail(f"sharding {name}: not bit for bit the unsharded run")
        diff = (got["params"] - want["params"]).abs().max().item()
        if not torch.allclose(got["params"], want["params"], rtol=SWEEP_RTOL,
                              atol=SWEEP_ATOL):
            fail(f"sharding {name}: params differ from the unsharded run by {diff}")
        return same, diff

    def launch_gate(name, run, kernel):
        recs = [types.SimpleNamespace(n_fresh=n, n_stale=0) for n in run["rows"]]
        want = expected_launches(saa_ops, trim_ops, kernel,
                                 types.SimpleNamespace(records=recs))
        if run["launches"] != want:
            fail(f"sharding {name}: launches {run['launches']}, expected {want}")
        coll = run["stats"]["collectives"]
        if coll.get("all_reduce", 0) != run["aggregated"]:
            fail(f"sharding {name}: {coll} collectives, "
                 f"{run['aggregated']} rounds aggregated")

    # --- (a) one-rank NCCL group, graphed --------------------------------
    relay = dict(COMMON, **CAMPAIGNS["RELAY"])
    t0 = time.perf_counter()
    a = run_ranks(_shard_rank_nccl, 1, relay, 2, backend=SHARD_NCCL,
                  timeout=SHARD_TIMEOUT)[0]
    spawn_a = time.perf_counter() - t0
    runs = a["runs"]
    for k in range(0, len(runs), 2):
        plain, shard = runs[k], runs[k + 1]
        if not same_bits(shard, plain):
            fail("sharding (a): the one-rank NCCL run is not bit for bit the "
                 "unsharded run")
        st = shard["stats"]
        if not (st["graphed"] and st["n_pshards"] == 1
                and st["graph_replays"] == st["rounds"] == len(shard["records"])):
            fail(f"sharding (a): graphed {st['graphed']}, {st['graph_replays']} "
                 f"replays over {st['rounds']} rounds, n_pshards {st['n_pshards']}")
        launch_gate("(a)", shard, APPLY)
        if set(st["collectives"]) != {"all_reduce"}:
            fail(f"sharding (a): collectives {st['collectives']}")
        launches.update(shard["launches"])
    t_plain, t_shard = runs[-2], runs[-1]
    out["a"] = {"rounds": t_shard["stats"]["rounds"],
                "aggregated": t_shard["aggregated"],
                "launches": t_shard["launches"],
                "collectives": t_shard["stats"]["collectives"],
                "graph_replays": t_shard["stats"]["graph_replays"],
                "graph_captures": [r["stats"]["graph_captures"] for r in runs],
                "rounds_per_s_sharded": t_shard["stats"]["rounds"] / t_shard["s"],
                "rounds_per_s_unsharded": t_plain["stats"]["rounds"] / t_plain["s"],
                "reduce_shape": (1, a["reduce_n"], MAIN_D),
                "reduce_ms": a["reduce_ms"],
                "reduce_graph_ms": a["reduce_graph_ms"], "spawn_s": spawn_a}
    print(f"sharding (a) RELAY, shard_participants=4 on a one-rank NCCL group "
          f"(clamped to 1 x 1), graphed: records, params bit for bit (int32) the "
          f"unsharded run's in {len(runs) // 2} pairs; {APPLY} "
          f"{t_shard['launches'].get(APPLY, 0)} launches == "
          f"{t_shard['aggregated']} rounds that aggregated == all-reduces "
          f"{t_shard['stats']['collectives']}; {t_shard['stats']['graph_replays']} "
          f"replays; rounds/s sharded {out['a']['rounds_per_s_sharded']:.1f} vs "
          f"unsharded {out['a']['rounds_per_s_unsharded']:.1f} (second pair); "
          f"all_reduce of (1, {a['reduce_n']}, {MAIN_D}) fp32 "
          f"{a['reduce_ms']:.4f} ms eager (host clock, 200 calls), "
          f"{a['reduce_graph_ms']:.4f} ms by graph replay")

    # --- (b)-(d): the unsharded runs here, then two gloo ranks -----------
    t0 = time.perf_counter()
    sub = Substrate.build(SimConfig(**SHARD_10K))
    build_s = time.perf_counter() - t0
    _timed_run(torch, Simulator(SimConfig(**SHARD_10K), sub,
                                device=SHARD_DEVICE))   # captures its graphs
    want_b = _timed_run(torch, Simulator(SimConfig(**SHARD_10K), sub,
                                         device=SHARD_DEVICE))
    eager_b = _timed_run(torch, Simulator(SimConfig(**SHARD_10K), sub,
                                          device=SHARD_DEVICE), eager=True)
    cells = SweepSpec(**SHARD_SWEEP).expand()
    _sync(torch)
    t0 = time.perf_counter()
    runner = SweepRunner(cells, device=SHARD_DEVICE)
    res = runner.run()
    _sync(torch)
    want_c = {"cells": [_shard_result(torch, r.acct, sim)
                        for r, sim in zip(res, runner.sims)],
              "s": time.perf_counter() - t0, "stats": runner.batch_stats}
    want_d = _timed_run(torch, Simulator(SimConfig(**SHARD_TRIMMED),
                                         device=SHARD_DEVICE))
    t0 = time.perf_counter()
    ranks = run_ranks(_shard_rank_gloo, SHARD_RANKS,
                      dataclasses.replace(sub, _on_device={}),
                      backend="gloo", timeout=SHARD_TIMEOUT)
    spawn_bd = time.perf_counter() - t0
    out.update(substrate_10k_s=build_s, gloo_spawn_s=spawn_bd)

    # (b)
    bits_b = []
    for rank, got in enumerate(ranks):
        run = got["10k"]
        same, diff = held(f"(b) rank {rank}", run, want_b)
        bits_b.append((same, diff))
        launch_gate(f"(b) rank {rank}", run, APPLY)
        if run["stats"]["n_pshards"] != SHARD_RANKS or run["stats"]["graphed"]:
            fail(f"sharding (b): n_pshards {run['stats']['n_pshards']}, "
                 f"graphed {run['stats']['graphed']} (gloo runs eagerly)")
        if run["stats"]["cross_shard_landings"] < 1:
            fail("sharding (b): no straggler landed across the split")
    b0 = ranks[0]["10k"]
    launches.update(b0["launches"])
    wall_b = max(r["10k"]["s"] for r in ranks)
    out["b"] = {"rounds": b0["stats"]["rounds"], "aggregated": b0["aggregated"],
                "launches": b0["launches"], "collectives": b0["stats"]["collectives"],
                "cross_shard_landings": b0["stats"]["cross_shard_landings"],
                "bitwise": [s for s, _ in bits_b],
                "max_abs_diff": max(d for _, d in bits_b),
                "rounds_per_s_sharded": b0["stats"]["rounds"] / wall_b,
                "rounds_per_s_unsharded": want_b["stats"]["rounds"] / want_b["s"],
                "rounds_per_s_unsharded_eager":
                    eager_b["stats"]["rounds"] / eager_b["s"],
                "reduce_shape": (1, ranks[0]["reduce_n"], MAIN_D),
                "reduce_ms": ranks[0]["reduce_ms"]}
    print(f"sharding (b) 10,000 learners, n_target 64, on {SHARD_RANKS} gloo ranks "
          f"sharing the card: host records == the unsharded run's on every rank, "
          f"params bit for bit {out['b']['bitwise']} (max abs diff "
          f"{out['b']['max_abs_diff']:.3g}); {APPLY} {b0['launches'].get(APPLY, 0)} "
          f"launches a rank == {b0['aggregated']} rounds that aggregated; "
          f"collectives {b0['stats']['collectives']}; cross-shard landings "
          f"{out['b']['cross_shard_landings']}; rounds/s sharded "
          f"{out['b']['rounds_per_s_sharded']:.2f} (eager) vs unsharded "
          f"{out['b']['rounds_per_s_unsharded']:.2f} graphed, "
          f"{out['b']['rounds_per_s_unsharded_eager']:.2f} eager (warm runs); "
          f"gloo all_reduce of "
          f"(1, {ranks[0]['reduce_n']}, {MAIN_D}) fp32 {ranks[0]['reduce_ms']:.3f} ms")

    # (c)
    bits_c, repacks = [], []
    for rank, got in enumerate(ranks):
        sw = got["sweep"]
        if sw["mesh"] != {"s": SHARD_RANKS, "p": 1}:
            fail(f"sharding (c): mesh {sw['mesh']}")
        for k, (g, w) in enumerate(zip(sw["cells"], want_c["cells"])):
            bits_c.append(held(f"(c) rank {rank} cell {cells[k].name}", g, w))
        reduces = sum(b["collectives"].get("all_reduce", 0) for b in sw["stats"])
        kernel = sw["launches"].get(AGG, 0)
        if not (kernel == reduces > 0 and sw["launches"].get(
                saa_ops.launch_key(AGG, "cluster"), 0) == kernel
                and set(sw["launches"]) == {AGG, saa_ops.launch_key(AGG, "cluster")}):
            fail(f"sharding (c) rank {rank}: launches {sw['launches']}, "
                 f"{reduces} round all-reduces")
        repacks.append(sum(b["dispatches"]["repack"] for b in sw["stats"]))
    if len(set(repacks)) != 1 or repacks[0] < 1:
        fail(f"sharding (c): repacks by rank {repacks}: the early stops must "
             "repack the sweep across the boundary")
    c0 = ranks[0]["sweep"]
    launches.update(c0["launches"])
    wall_c = max(r["sweep"]["s"] for r in ranks)
    out["c"] = {"cells": len(cells), "repacks": repacks[0],
                "launches": c0["launches"],
                "collectives": [b["collectives"] for b in c0["stats"]],
                "bitwise": sum(s for s, _ in bits_c), "compared": len(bits_c),
                "max_abs_diff": max(d for _, d in bits_c),
                "wall_s_sharded": wall_c, "wall_s_unsharded": want_c["s"]}
    print(f"sharding (c) S = {len(cells)} YoGi sweep on {SHARD_RANKS} x 1 (gloo): "
          f"every cell's host records == the unsharded sweep's on every rank, "
          f"{out['c']['bitwise']} of {len(bits_c)} cell runs bit for bit (max abs "
          f"diff {out['c']['max_abs_diff']:.3g}); {repacks[0]} repack(s) across the "
          f"boundary; rank 0: {AGG} {c0['launches'].get(AGG, 0)} launches == its "
          f"batch-round all-reduces; collectives by batch "
          f"{out['c']['collectives']}; wall {wall_c:.2f} s sharded vs "
          f"{want_c['s']:.2f} s unsharded")

    # (d)
    bits_d = []
    for rank, got in enumerate(ranks):
        run = got["trimmed"]
        bits_d.append(held(f"(d) rank {rank}", run, want_d))
        launch_gate(f"(d) rank {rank}", run, TRIM)
        if not run["launches"].get(saa_ops.launch_key(TRIM, "sort")):
            fail(f"sharding (d): kernel 7's sort variant never launched "
                 f"({run['launches']})")
    d0 = ranks[0]["trimmed"]
    launches.update(d0["launches"])
    out["d"] = {"rounds": d0["stats"]["rounds"], "aggregated": d0["aggregated"],
                "rows": d0["rows"], "launches": d0["launches"],
                "collectives": d0["stats"]["collectives"],
                "bitwise": [s for s, _ in bits_d],
                "max_abs_diff": max(d for _, d in bits_d),
                "rounds_per_s_sharded": d0["stats"]["rounds"] / max(
                    r["trimmed"]["s"] for r in ranks),
                "rounds_per_s_unsharded": want_d["stats"]["rounds"] / want_d["s"]}
    print(f"sharding (d) trimmed_mean, groups of {min(d0['rows'])}-{max(d0['rows'])} "
          f"rows, on {SHARD_RANKS} gloo ranks: host records == the unsharded run's, "
          f"params bit for bit {out['d']['bitwise']}; {TRIM} launches "
          f"{d0['launches']} == rounds that aggregated ({d0['aggregated']}), the "
          f"sort variant on a live path; rounds/s sharded "
          f"{out['d']['rounds_per_s_sharded']:.2f} vs unsharded "
          f"{out['d']['rounds_per_s_unsharded']:.2f}")
    print("sharding: two ranks sharing one card measure correctness and the "
          "collectives' overhead, not a multi-card speed-up (one card here)")
    return out


def lm_cells() -> dict:
    """The LM phase's cells: name -> (SimConfig, kernel).  The example's
    cell (``python -m repro_torch.federated_lm``: tokens_skew, 32 learners,
    6 a round, the transformer 2 x 64 wide) with random selection, its
    ``--parity`` flat rerun, its ``--race``, rwkv6 and moe at their default
    knobs, and the transformer under the quickstart's RELAY+YoGi."""
    from repro_torch.federated_lm import cell_config
    ex = lambda sel, **kw: cell_config(sel, LM_ROUNDS, 0, **kw)
    cells = {"LM random": (ex("random"), APPLY),
             "LM random flat": (ex("random", fused_rounds=False), CELL_AGG)}
    for sel in LM_RACE[1:]:
        cells[f"LM {sel}"] = (ex(sel), APPLY)
    for model in LM_MODELS:
        cells[f"LM {model}"] = (ex("random", model=model, model_params=()),
                                APPLY)
    cells["LM RELAY+YoGi"] = (ex("priority", apt=True, scaling_rule="relay",
                                 server_opt="yogi"), AGG)
    return cells


def lm_chaotic_gap(torch, cfg, kernel, run) -> dict:
    """A chaotic LM cell's first round on the card against the CPU, beside
    the card's own spread.  The loss gradient at the initial row on the
    first two learners' first ``local_batch`` sequences: card and CPU in
    fp32 against each other and against the CPU in fp64.  The first
    round's update: card against CPU, and the card's against its own from
    the initial row perturbed by 1e-7 (relative; ``LM_SPREAD_SEEDS`` seeded
    draws, the largest kept), and the CPU's likewise for the first draw.
    Each gap as its largest difference (abs) and as the largest share of a
    leaf's largest element (leaf_rel)."""
    from repro_torch.core.aggregation import unflatten_update
    from repro_torch.sim import Simulator, Substrate
    sub = Substrate.build(cfg)
    fns, spec = sub.model_fns, sub.flat_spec
    b = cfg.local_batch
    idx = [*sub.data.shards[0][:b], *sub.data.shards[1][:b]]
    x = torch.from_numpy(sub.data.x_train[idx])
    y = torch.from_numpy(sub.data.y_train[idx]).long()
    grads = {}
    for dev, d, dt in (("cuda", "cuda", torch.float32),
                       ("cpu", "cpu", torch.float32),
                       ("cpu64", "cpu", torch.float64)):
        p = torch.from_numpy(sub.flat_params0).to(d, dt).repeat(2, 1)
        p.requires_grad_(True)
        mean, _ = fns.loss(unflatten_update(p, spec), x.view(2, b, -1).to(d),
                           y.view(2, b, -1).to(d))
        grads[dev] = torch.autograd.grad(mean.sum(), p)[0].cpu()
    one = dataclasses.replace(cfg, rounds=1)
    p0 = torch.from_numpy(sub.flat_params0)

    def update(dev, row=None):
        if row is None:
            return run(one, kernel, device=dev)[1].flat_params.cpu() - p0
        sim = Simulator(one, Substrate.build(one, flat_params0=row.numpy()),
                        device=dev)
        sim.run()
        return sim.flat_params.cpu() - p0

    def bumped(seed):
        noise = torch.randn(p0.shape, generator=torch.Generator().manual_seed(seed))
        return p0 * (1 + 1e-7 * noise)

    def leaf_rel(a, b):
        return max((a[..., lo:hi] - b[..., lo:hi]).abs().max().item()
                   / b[..., lo:hi].abs().max().item()
                   for lo, hi in zip(spec.offsets[:-1], spec.offsets[1:])
                   if b[..., lo:hi].any())

    def gap(a, b):
        return {"abs": (a - b).abs().max().item(), "leaf_rel": leaf_rel(a, b)}
    upd = {dev: update(dev) for dev in ("cuda", "cpu")}
    card_spread = [gap(update("cuda", bumped(s)), upd["cuda"])
                   for s in range(LM_SPREAD_SEEDS)]
    return {"grad": gap(grads["cuda"], grads["cpu"]),
            "grad_cuda_vs_fp64": gap(grads["cuda"], grads["cpu64"]),
            "grad_cpu_vs_fp64": gap(grads["cpu"], grads["cpu64"]),
            "update": gap(upd["cuda"], upd["cpu"]),
            "update_max_abs": upd["cpu"].abs().max().item(),
            "card_spread": {k: max(g[k] for g in card_spread)
                            for k in ("abs", "leaf_rel")},
            "card_spreads": card_spread,
            "cpu_spread": gap(update("cpu", bumped(0)), upd["cpu"])}


def lm_fl_paths(torch, launches, checks, check_grid, gen):
    """The federated LM learner on the card: each LM cell once with
    the launch counters zeroed (kernels 1-3 once a round with a group, on
    the chain at the LM's d_pad; kernels 1 and 2 replayed from the round
    graph, one a round), the example's cell again at K = 4 and eager;
    gates: fused == flat, K = 4 == K = 1 and eager == graphed bitwise
    (eager runs of every fused cell), host records == the port's CPU runs
    (``LM_CPU``) with params within rtol 1e-3 / atol 1e-4 (``LM_CHAOTIC``
    cells over ``LM_CHAOTIC_ROUNDS`` rounds: their loss gradient within
    1e-4 of each leaf's largest element, their first round's update within
    ``LM_SPREAD_MULT`` times the card's own spread), the pad columns of
    the params (and YoGi state) exactly zero, the last eval's NLL below the
    first's; then kernels 1-4 against their plain versions at every n and
    d_pad the runs gave them.  Numbers: warm rounds/s graphed and eager a
    cell.  Returns (report, a function timing kernels 1-3 on the chain at
    the LM shapes, a function profiling the example's cell), the last two
    run later with the other kernel times and profiles."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.staleness_agg import ops as saa_ops
    from repro_torch.kernels.staleness_agg import ref as saa_ref
    from repro_torch.kernels.trimmed_agg import ops as trim_ops
    from repro_torch.sim import Simulator
    from repro_torch.sim.pipeline import RoundPipeline
    cells = lm_cells()
    rep = {"paths": {}, "rounds_per_s": {}}
    ns = {}                                  # (kernel, d_pad) -> n counted

    def run(cfg, kernel, device="cuda", eager=False):
        """One run: (Accounting, Simulator, stats, launches, d_pad,
        seconds); the pad columns checked on a fused run."""
        sim = Simulator(cfg, device=device)
        d = sim.flat_params.numel()
        d_pad = d + (-d) % saa_ops.D_BLK
        LAUNCHES.clear()
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = None
        if cfg.fused_rounds:
            pipe = RoundPipeline([sim])
            if eager:
                pipe.graphs, pipe.stats.graphed = None, False
            acct, = pipe.run()
            stats = pipe.stats.as_dict()
            if pipe.d_pad != d_pad:
                fail(f"LM {cfg.model}: pipeline d_pad {pipe.d_pad}, expected {d_pad}")
            pads = [pipe.params[:, d:]] + ([pipe.opt_state[k][:, d:]
                                            for k in ("m", "v")]
                                           if pipe.yogi else [])
            if any(t.any() for t in pads):
                fail(f"LM {cfg.model} {cfg.selector}: pad columns D..d_pad not zero")
        else:
            acct = sim.run()
        if device == "cuda":
            torch.cuda.synchronize()
        return (acct, sim, stats, dict(LAUNCHES), d_pad,
                time.perf_counter() - t0)

    gpu = {}
    for name, (cfg, kernel) in cells.items():
        acct, sim, stats, got, d_pad, secs = run(cfg, kernel)
        want = expected_launches(saa_ops, trim_ops, kernel, acct, d=d_pad)
        if not want or got != want or saa_ops.launch_key(kernel, "chain") not in got:
            fail(f"{name}: launches {got}, expected {want} (one a round with a "
                 f"group, on the chain at d_pad {d_pad})")
        if stats is not None:
            graph_gate(name, stats, kernel, len(acct.records), d=d_pad)
        losses = [r.loss for r in acct.records if r.loss == r.loss]
        if len(losses) < 2 or not losses[-1] < losses[0] or \
                not torch.isfinite(sim.flat_params).all():
            fail(f"{name}: eval NLL {losses} does not fall, or params not finite")
        launches.update(got)
        gpu[name] = (acct, sim)
        rows = [r.n_fresh + r.n_stale for r in acct.records
                if r.n_fresh + r.n_stale > 0]
        ns.setdefault((kernel, d_pad), Counter()).update(rows)
        rep["paths"][name] = {
            "model": cfg.model, "D": sim.flat_params.numel(), "d_pad": d_pad,
            "launches": got, "rounds": len(acct.records), "first_run_s": secs,
            "nll_first_last": [losses[0], losses[-1]],
            "final_accuracy": acct.summary()["final_accuracy"],
            "rows_a_round": sorted(set(rows)), "pipeline": stats}
        print(f"{name} ({cfg.model}, D={sim.flat_params.numel()}, d_pad {d_pad}): "
              f"{got} over {len(rows)} aggregating rounds, {secs:.2f}s first run"
              + ("" if stats is None else
                 f"; {stats['graph_replays']} replays of {stats['graph_captures']} "
                 "graphs") + f"; eval NLL {losses[0]:.4f} -> {losses[-1]:.4f}")
    # fused == flat, K = 4 == K = 1, eager == graphed, bitwise
    ex_cfg, _ = cells["LM random"]
    if not same_run(torch, *gpu["LM random"], *gpu["LM random flat"]):
        fail("LM random flat: differs from the fused pipeline, bitwise")
    acct4, sim4, st4, got4, d_pad, _ = run(
        dataclasses.replace(ex_cfg, rounds_per_dispatch=CHUNK_K), APPLY)
    graph_gate(f"LM random K={CHUNK_K}", st4, APPLY, len(acct4.records), d=d_pad)
    if got4 != rep["paths"]["LM random"]["launches"] or \
            not same_run(torch, *gpu["LM random"], acct4, sim4):
        fail(f"LM random K={CHUNK_K}: differs from K = 1 (launches {got4})")
    launches.update(got4)
    print(f"LM random: flat == fused and K={CHUNK_K} ({st4['dispatches']['round']} "
          "chunks) == K = 1, bitwise")
    # warm rounds/s, graphed and eager, each eager run == its graphed one
    # (a chaotic cell's over its first LM_CHAOTIC_ROUNDS rounds, the
    # graphed run then the one held to the CPU's)
    warm = {}
    for name, (cfg, kernel) in cells.items():
        if not cfg.fused_rounds:
            continue
        if name in LM_CHAOTIC:
            cfg = dataclasses.replace(cfg, rounds=LM_CHAOTIC_ROUNDS)
        g_acct, g_sim, _, _, _, g_s = run(cfg, kernel)
        e_acct, e_sim, _, _, _, e_s = run(cfg, kernel, eager=True)
        warm[name] = (g_acct, g_sim)
        base = warm[name] if name in LM_CHAOTIC else gpu[name]
        if not (same_run(torch, *base, g_acct, g_sim)
                and same_run(torch, *base, e_acct, e_sim)):
            fail(f"{name}: a warm graphed or eager run differs, bitwise")
        n = len(g_acct.records)
        rep["rounds_per_s"][name] = {"graphed": n / g_s, "eager": n / e_s,
                                     "rounds": n}
        print(f"{name}: warm {n / g_s:.1f} rounds/s graphed, {n / e_s:.1f} "
              f"eager (== graphed, bitwise; {n} rounds) ({card_line()})")
    # the card against the port's CPU runs of the same cells (the flat cell
    # equals the fused random one bitwise).  rwkv6 at its default knobs is
    # chaotic in fp32 in both packages (tests/test_torch_lm_learner.py:
    # a 1e-7 perturbation of the initial row parts its params past this
    # tolerance within four rounds on the CPU): its params are held after
    # one round, within LM_SPREAD_MULT times the card's own spread
    rep["cpu_max_abs_diff"], rep["cpu_chaotic"] = {}, {}
    for name in LM_CPU:
        cfg, kernel = cells[name]
        acct, sim = gpu[name]
        if name in LM_CHAOTIC:
            cfg = dataclasses.replace(cfg, rounds=LM_CHAOTIC_ROUNDS)
            acct, sim = warm[name]
        c_acct, c_sim = run(cfg, kernel, device="cpu")[:2]
        if [host(r) for r in acct.records] != [host(r) for r in c_acct.records]:
            fail(f"{name}: host records differ from the CPU run")
        if name in LM_CHAOTIC:
            g = rep["cpu_chaotic"][name] = lm_chaotic_gap(torch, cfg, kernel, run)
            if g["grad"]["leaf_rel"] > 1e-4 or any(
                    g["update"][k] > LM_SPREAD_MULT * g["card_spread"][k]
                    for k in ("abs", "leaf_rel")):
                fail(f"{name}: the loss gradient (leaf_rel > 1e-4) or the "
                     f"first round's update (> {LM_SPREAD_MULT} x the card's "
                     f"spread) differs from the CPU's: {g}")
            continue
        p_gpu = sim.flat_params.cpu()
        err = (p_gpu - c_sim.flat_params).abs().max().item()
        if not torch.allclose(p_gpu, c_sim.flat_params, rtol=1e-3, atol=1e-4):
            fail(f"{name}: params differ from the CPU run by {err}")
        rep["cpu_max_abs_diff"][name] = err
    print("LM cells " + ", ".join(LM_CPU) + ": host records == CPU runs; "
          "params max abs diff " + ", ".join(
              f"{k} {v:.3g}" for k, v in rep["cpu_max_abs_diff"].items())
          + " (rtol 1e-3, atol 1e-4)")
    for k, v in rep["cpu_chaotic"].items():
        print(f"{k} (first {LM_CHAOTIC_ROUNDS} rounds against the CPU): loss "
              f"gradient card vs CPU {v['grad']['leaf_rel']:.3g} of a leaf's "
              f"largest element (<= 1e-4; against fp64: card "
              f"{v['grad_cuda_vs_fp64']['leaf_rel']:.3g}, CPU "
              f"{v['grad_cpu_vs_fp64']['leaf_rel']:.3g}); first round's "
              f"update (largest {v['update_max_abs']:.4g}) card vs CPU "
              f"{v['update']['abs']:.3g} abs, {v['update']['leaf_rel']:.3g} "
              f"leaf_rel (<= {LM_SPREAD_MULT} x the card's spread: "
              f"{v['card_spread']['abs']:.3g} abs, "
              f"{v['card_spread']['leaf_rel']:.3g} leaf_rel, the most of "
              f"{LM_SPREAD_SEEDS} draws of a 1e-7 perturbation); the CPU's "
              f"spread (one draw) {v['cpu_spread']['abs']:.3g} abs, "
              f"{v['cpu_spread']['leaf_rel']:.3g} leaf_rel ({card_line()})")
    # kernels 1-4 against their plain versions at the LM runs' n and d_pad
    before = sum(checks.n.values())
    shapes = sorted({(1, n, d_pad) for (_, d_pad), c in ns.items() for n in c})
    check_grid(shapes)
    rep["kernel_checks"] = {"shapes": shapes,
                            "checks": sum(checks.n.values()) - before}
    print(f"LM shapes: kernels == plain versions at {shapes} (every rule and "
          f"case): {sum(checks.n.values()) - before} more checks")

    def time_chain():
        """Kernels 1-3 at the LM shapes (n the cells saw most, their
        d_pad), events / graph / profiler ms beside bound and plain."""
        out = {}
        for (kernel, d_pad), c in sorted(ns.items()):
            n = c.most_common(1)[0][0]
            t = time_kernel(torch, saa_ops, saa_ref, kernel, 1, n, d_pad, 200, gen)
            out[f"{kernel} n={n} d_pad={d_pad}"] = t
            print(f"LM {kernel} n={n} d_pad={d_pad} [{t['variant']}]: kernel "
                  f"{t['ms']:.4f} ms events, {t['device_ms']:.4f} graph, "
                  f"{t['kernel_ms']:.5f} its kernels (profiler); plain "
                  f"{t['plain_ms']:.4f} (graph {t['plain_device_ms']:.4f}); bound "
                  f"{t['bound_ms']:.6f} ms ({t['bound_by']}) ({card_line()})")
        return out

    def profile_example():
        """A profile of the example's cell, warm and graphed."""
        prof = profile_campaign(torch, lambda: run(ex_cfg, APPLY))
        n = len(gpu["LM random"][0].records)
        prof["gpu_kernels_a_round"] = prof["gpu_kernels"] / n
        idle = prof["device_idle_share"]
        print(f"LM random profile: wall {prof['wall_ms']:.1f} ms, GPU busy "
              f"{prof['device_busy_ms']:.1f} ms (idle share "
              f"{'not measured' if idle is None else f'{idle:.3f}'}), "
              f"{prof['gpu_kernels']} GPU kernels, "
              f"{prof['gpu_kernels_a_round']:.1f} a round; host spans (CPU ms): "
              + ", ".join(f"{k} {v:.1f}" for k, v in
                          sorted(prof["host_spans_ms"].items()))
              + f" ({card_line()})")
        for kname, ms in prof["top_kernels_ms"].items():
            print(f"  {ms:9.3f} ms  {kname[:90]}")
        rep["profile"] = prof
        return prof

    return rep, time_chain, profile_example


# --- the legacy engine, the pod launch layer and the roofline counter ---
LEGACY_QUICK = ("Random", "RELAY", "RELAY+YoGi")
LEGACY_ROBUST = "trimmed_mean"
TRAIN_VMAP_TOKENS = 4 * 4_096          # the train phase's vmap round: P x S


def legacy_launch_paths(torch, launches, gpu, sims, runs, paths, train):
    """The legacy pytree engine on the card and the pod launch layer.

    (a) the quickstart's Random, RELAY and RELAY+YoGi at ``fast_path=False``
    (kernel 3 on every aggregating round's exact rows): launches == the
    rounds that aggregated; host records and summary counters == the fused
    run's and == the same legacy run on the CPU; params within
    ``P_RTOL`` / ``P_ATOL`` of the flat run's; rounds/s beside both.
    (b) the robustness race's trimmed_mean cell at ``fast_path=False``:
    kernel 7 on every aggregated round, host records and robust counters
    == the fused run's.  ((c), the dry run, is ``dryrun_paths``, after
    every timed phase.)  (d) the REDUCED internlm2 fp32
    train step with ``param_specs`` on a one-rank (1, 1) NCCL mesh, new
    params bit for bit the unplaced step's; on that mesh the layouts the
    dry run places (``PLACED_ARCHS``: uneven kv groups, MLA naive and
    absorbed, Mamba with MoE, internlm2's vmap cohort with its prefill and
    decode), each REDUCED fp32 prefill, decode step and
    train step (vmap and stream) with the pod layout's pins on, bit for
    bit the unplaced ones (``placed_layouts``); and the dispatch counter's
    FLOPs of the train phase's full-width vmap round (on meta tensors)
    beside 6 N T and the measured round time."""
    import dataclasses
    import socket

    import torch.distributed as dist

    from repro_torch.configs import adapt_for_shape, get_config, get_reduced, shape_for
    from repro_torch.core.aggregation import flatten_update
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.staleness_agg import ops as saa_ops
    from repro_torch.kernels.trimmed_agg import ops as trim_ops
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import make_fl_train_step
    from repro_torch.models import init_params
    from repro_torch.models.transformer import shape_params
    from repro_torch.roofline import H100, CostCounter
    from repro_torch.sim import SimConfig, Simulator
    t_phase = time.perf_counter()
    out = {"legacy": {}}
    robust = {LEGACY_ROBUST: (dict(RACE, **DEFENSES[LEGACY_ROBUST][0]), TRIM)}
    legacy = {name: (runs[name][0], CELL_AGG) for name in LEGACY_QUICK}
    legacy.update(robust)
    for name, (kw, kernel) in legacy.items():
        cfg = SimConfig(**dict(kw, fast_path=False))
        sim = Simulator(cfg, device="cuda")
        LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acct = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got, n_agg = dict(LAUNCHES), aggregated(acct)
        want = expected_launches(saa_ops, trim_ops, kernel, acct)
        if n_agg == 0 or got != want:
            fail(f"legacy {name}: launches {got}, expected {want} (one a round "
                 "that aggregated, and no other kernel)")
        launches.update(got)
        fused = gpu[name]
        if [host(r) for r in acct.records] != [host(r) for r in fused.records]:
            fail(f"legacy {name}: host records differ from the fused run's")
        if guard_counts(acct) != guard_counts(fused) or \
                robust_counts(acct) != robust_counts(fused):
            fail(f"legacy {name}: summary counters differ from the fused run's")
        rec = {"launches": got, "aggregated_rounds": n_agg, "wall_s": wall,
               "rounds_per_s": len(acct.records) / wall,
               "fused_first_run_rounds_per_s":
                   len(fused.records) / paths[name]["first_run_s"],
               "robust": robust_counts(acct)}
        if name in LEGACY_QUICK:
            cpu = Simulator(cfg, device="cpu").run()
            if [host(r) for r in cpu.records] != [host(r) for r in acct.records]:
                fail(f"legacy {name}: host records differ from the CPU legacy run's")
            flat_name = f"{name} flat"
            flat_p = sims[flat_name].flat_params
            mine = flatten_update(sim.params)[0]
            err = (mine - flat_p).abs().max().item()
            if not torch.allclose(mine, flat_p, rtol=P_RTOL, atol=P_ATOL):
                fail(f"legacy {name}: params differ from the flat run's by {err}")
            rec.update(params_max_abs_vs_flat=err,
                       flat_first_run_rounds_per_s=len(gpu[flat_name].records)
                       / paths[flat_name]["first_run_s"])
        out["legacy"][name] = rec
        print(f"legacy {name}: {got} over {n_agg} aggregating rounds; host records "
              f"and counters == the fused run"
              + (" and the CPU legacy run; params within "
                 f"{rec['params_max_abs_vs_flat']:.2e} of the flat run"
                 if name in LEGACY_QUICK else f", robust {rec['robust']}")
              + f"; {rec['rounds_per_s']:.1f} rounds/s (fused first run "
              f"{rec['fused_first_run_rounds_per_s']:.1f}"
              + (f", flat {rec['flat_first_run_rounds_per_s']:.1f}"
                 if name in LEGACY_QUICK else "") + ")")

    # (d) the placed train step on one rank, and the counted vmap round
    cfg = dataclasses.replace(get_reduced(TRAIN_ARCH), param_dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(7))
    g = torch.Generator(device="cuda").manual_seed(8)
    batch = {k: torch.randint(0, cfg.vocab_size, (3, 2, 64), generator=g,
                              device="cuda", dtype=torch.int32)
             for k in ("tokens", "labels")}
    fresh = torch.tensor([True, True, False], device="cuda")
    tau = torch.tensor([0, 0, 2], dtype=torch.int32, device="cuda")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh()
        specs = sh.param_pspecs(cfg, params, mesh)
        dparams = sh.distribute(params, specs, mesh)
        dbatch = sh.distribute(batch, {k: sh.P(None, "data", None) for k in batch},
                               mesh)
        out["placed"] = {}
        for cohort in ("vmap", "stream"):
            LAUNCHES.clear()
            new_p, _ = make_fl_train_step(cfg, cohort=cohort)(params, batch, fresh, tau)
            new_d, _ = make_fl_train_step(cfg, cohort=cohort, param_specs=specs)(
                dparams, dbatch, fresh, tau)
            torch.cuda.synchronize()
            flat_p = flatten_update(new_p)[0]
            flat_d = flatten_update(sh.map_tree(lambda _, t: t.full_tensor(),
                                                new_d))[0]
            same = bits_equal(torch, flat_d, flat_p)
            err = (flat_d - flat_p).abs().max().item()
            if not same or LAUNCHES:
                fail(f"placed train step ({cohort}): differs from the unplaced "
                     f"step by {err} (launches {dict(LAUNCHES)})")
            out["placed"][cohort] = {"bitwise": same, "max_abs": err}
            print(f"placed train step ({cohort}, REDUCED {TRAIN_ARCH} fp32, one-rank "
                  "(1, 1) NCCL mesh): new params == the unplaced step's, bit for bit")
        out["placed_layouts"] = placed_layouts(torch, mesh)
    finally:
        dist.destroy_process_group()

    full = adapt_for_shape(get_config(TRAIN_ARCH), shape_for("train_4k"))
    _, _, n_rep = full.segment_plan()
    counts = []
    for reps in (1, 2):
        c = dr._depth(full, reps)
        p_meta = shape_params(c)
        b_meta = {k: torch.empty((TRAIN_P,) + TRAIN_BATCH, dtype=torch.int32,
                                 device="meta") for k in ("tokens", "labels")}
        with CostCounter() as counter:
            make_fl_train_step(c, cohort="vmap")(
                p_meta, b_meta, torch.empty(TRAIN_P, dtype=torch.bool, device="meta"),
                torch.empty(TRAIN_P, dtype=torch.int32, device="meta"))
        counts.append(counter.totals())
    counted = counts[0]["flops"] + (n_rep - 1) * (counts[1]["flops"]
                                                 - counts[0]["flops"])
    n_params = sum(t.numel() for t in sh.leaves(shape_params(full)))
    model = 6 * n_params * TRAIN_VMAP_TOKENS
    round_s = train["runs"]["vmap"]["round_s"]
    out["counted_vmap_round"] = {
        "counted_flops": counted, "model_flops": model, "ratio": counted / model,
        "round_s": round_s,
        "counted_bf16_peak_share": counted / round_s / H100["peak_flops_bf16"]}
    print(f"counted vmap round ({TRAIN_ARCH}, P = {TRAIN_P} x {TRAIN_BATCH[1]:,} "
          f"tokens, meta tensors): {counted:.4e} FLOPs beside 6 N T = {model:.4e} "
          f"(ratio {counted / model:.3f}); at the measured {round_s:.3f} s round, "
          f"{out['counted_vmap_round']['counted_bf16_peak_share']:.3f} of the "
          "dense bf16 peak")

    out["seconds"] = time.perf_counter() - t_phase
    return out


def placed_layouts(torch, mesh) -> dict:
    """(d) On the one-rank (1, 1) NCCL ``mesh``: for each of
    ``PLACED_ARCHS`` (REDUCED, fp32) the prefill, a decode step and the
    train step in both cohorts, params placed by ``param_pspecs`` and the
    inputs on "data", run with the pod layout's pins on (``shard_hints``)
    and held bit for bit to the same call on plain tensors; no kernel may
    launch (the REDUCED configs' paths run none)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import base, get_reduced
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.train import make_fl_train_step
    from repro_torch.models import init_params, shard_hints
    from repro_torch.models.transformer import decode_step, init_decode_state, prefill

    full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
    flat = lambda tree: [full(t) for t in sh.leaves(tree)]
    out = {}
    for arch, overrides in PLACED_ARCHS:
        cfg = dataclasses.replace(get_reduced(arch), param_dtype=torch.float32,
                                  **overrides)
        name = arch + "".join(f" {k}={v}" for k, v in overrides.items())
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(11))
        specs = sh.param_pspecs(cfg, params, mesh)
        dparams = sh.distribute(params, specs, mesh)
        g = torch.Generator(device="cuda").manual_seed(12)
        tok = lambda *shape: torch.randint(0, cfg.vocab_size, shape, generator=g,
                                           device="cuda", dtype=torch.int32)
        place = lambda t, spec: sh.distribute({"x": t}, {"x": spec}, mesh)["x"]
        pins = dict(batch_axes=("data",), model_axis="model")
        res = {}
        LAUNCHES.clear()
        with torch.no_grad():
            batch = {"tokens": tok(2, 64), "labels": tok(2, 64)}
            want = prefill(cfg, params, batch)
            with shard_hints.hints(**pins), implicit_replication():
                got = prefill(cfg, dparams, {k: place(v, sh.P("data", None))
                                             for k, v in batch.items()})
            res["prefill"] = (flat(list(got)), flat(list(want)))
            spec = sh.input_specs(cfg, base.InputShape("decode", 64, 2, "decode"), mesh)
            state = init_decode_state(cfg, 2, 64, device="cuda")
            tokens, pos = tok(2), torch.tensor([5, 40], dtype=torch.int32, device="cuda")
            want = decode_step(cfg, params, state, tokens, pos)
            with shard_hints.hints(**pins), implicit_replication():
                got = decode_step(cfg, dparams, sh.distribute(state, spec.arg_specs["state"], mesh),
                                  place(tokens, spec.arg_specs["tokens"]),
                                  place(pos, spec.arg_specs["position"]))
            res["decode"] = (flat(list(got)), flat(list(want)))
        batch = {"tokens": tok(4, 2, 32), "labels": tok(4, 2, 32)}
        fresh = torch.tensor([True, False, True, True], device="cuda")
        tau = torch.tensor([0, 2, 0, 0], dtype=torch.int32, device="cuda")
        for cohort in ("vmap", "stream"):
            lead = sh.P("data", None, None) if cohort == "vmap" else sh.P(None, "data", None)
            want = make_fl_train_step(cfg, cohort=cohort)(params, batch, fresh, tau)
            with shard_hints.hints(batch_axes=("data",) if cohort == "stream" else None,
                                   model_axis="model"):
                got = make_fl_train_step(cfg, cohort=cohort, param_specs=specs)(
                    dparams, {k: place(v, lead) for k, v in batch.items()}, fresh, tau)
            res[f"train {cohort}"] = (flat(list(got)), flat(list(want)))
        torch.cuda.synchronize()
        rec = {}
        for kind, (got, want) in res.items():
            same = len(got) == len(want) and all(
                a.shape == b.shape and bits_equal(torch, a, b) for a, b in zip(got, want))
            err = max(((a.double() - b.double()).abs().max().item() for a, b in zip(got, want)
                       if a.is_floating_point() and a.numel() and a.shape == b.shape),
                      default=0.0)
            if not same:
                fail(f"placed layouts (d) {name} {kind}: differs from the unplaced call "
                     f"by {err}")
            rec[kind] = {"bitwise": same, "max_abs": err, "leaves": len(got)}
        if LAUNCHES:
            fail(f"placed layouts (d) {name}: launched {dict(LAUNCHES)}")
        out[name] = rec
        print(f"placed layouts (d) {name} (REDUCED fp32, one-rank (1, 1) NCCL mesh, "
              f"pins on): prefill, decode step, train step vmap and stream == the "
              f"unplaced calls, bit for bit ({sum(r['leaves'] for r in rec.values())} "
              "tensors)", flush=True)
    return out


def dryrun_paths():
    """(c) The dry run's ``SMOKE`` combinations (``repro_torch.launch.dryrun``)
    on both meshes, in this process: each ``lower_one`` creates its fake
    pod group and destroys it.  Host-only, so it runs after every timed
    phase.  Each step must be counted, with FLOPs and bytes a chip above 0
    and the model's FLOPs over the counted ones in (0, 1.05]
    (``dryrun.useful_ok``); per-shard
    argument bytes, FLOPs, bytes and collective bytes a chip by kind, the
    roofline's bottleneck and the mesh each was counted on printed.  The
    rest of the grid runs as its own command
    (``python -m repro_torch.launch.dryrun --arch all --shape all
    --both-meshes``)."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun as dr
    t0 = time.perf_counter()
    recs = []
    for arch, shape, cohort in dr.SMOKE:
        for multi_pod in (False, True):
            rec = dr.lower_one(arch, shape, multi_pod=multi_pod, cohort=cohort,
                               save=False, verbose=False)
            if dist.is_initialized():
                fail("dry run: the fake pod group outlived its combination")
            name = f"dry run {rec['arch']} {rec['shape']} mesh {rec['mesh']}"
            if rec.get("step") != "counted":
                fail(f"{name}: step not run: {rec.get('error')}")
            if not (rec["flops_per_chip"] > 0 and rec["bytes_per_chip"] > 0
                    and dr.useful_ok(rec, dr.get_config(arch))):
                fail(f"{name}: counted {rec['flops_per_chip']} FLOPs, "
                     f"{rec['bytes_per_chip']} bytes, useful ratio "
                     f"{rec['roofline']['useful_ratio']}")
            coll = {k: v for k, v in rec["collectives"].items() if k != "total"}
            print(f"{name} ({rec['cohort']}, counted on {rec['counted_on']}): args/chip "
                  f"{rec['arg_bytes_per_chip']['total']:.4e} B, FLOPs/chip "
                  f"{rec['flops_per_chip']:.4e}, bytes/chip "
                  f"{rec['bytes_per_chip']:.4e}, collective bytes/chip {coll}, "
                  f"bottleneck {rec['roofline']['bottleneck']} "
                  f"({rec['step_s']:.1f} s)", flush=True)
            recs.append(rec)
    return {"records": recs, "seconds": time.perf_counter() - t0}


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
    from repro_torch.kernels.trimmed_agg import ops as trim_ops
    from repro_torch.kernels.trimmed_agg import ref as trim_ref
    from repro_torch.quickstart import CAMPAIGNS, COMMON, table
    from repro_torch.selection import SELECTOR_TABLE
    from repro_torch.selector_zoo import text_table, zoo_base, zoo_cells
    from repro_torch.sim import SimConfig, Simulator
    from repro_torch.sim.learner import fp32_matmuls

    fp32_matmuls()        # the plain versions' matmuls in full fp32 too
    report = {"card": card_line(), "kind": torch.cuda.get_device_name(0),
              "torch": f"{torch.__version__} cuda {torch.version.cuda}",
              "phase_s": {}}
    t_phase = [time.perf_counter()]

    def lap(phase):
        """Seconds since the last phase ended, into the report."""
        now = time.perf_counter()
        report["phase_s"][phase] = now - t_phase[0]
        print(f"phase {phase}: {now - t_phase[0]:.1f}s", flush=True)
        t_phase[0] = now
    print(f"card: {report['card']}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # --- 1. build every kernel (one nvcc per source, in parallel) --------
    t0 = time.perf_counter()
    _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    print(f"built {sorted(_build.SOURCES)} in {report['build_s']:.1f}s")
    lap("build")
    report["ptxas"] = {name: ptxas_summary(_build.log_path(name).read_text())
                       for name in _build.SOURCES}
    for name, kerns in report["ptxas"].items():
        for k in kerns:
            print(f"  ptxas {name}: {k['kernel']}: {k['registers']} registers, spill "
                  f"stores {k['spill_stores']} / loads {k['spill_loads']} bytes")

    # --- 2. each kernel against its plain version -----------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    rules = ("equal", "dynsgd", "adasgd", "relay")
    cases = ("mixed", "padding", "no_stale", "no_fresh", "all_invalid",
             "screened")
    checks = Checks(torch)

    def check_grid(shapes):
        for s, n, d in shapes:
            for rule in rules:
                for case in cases:
                    check_family(torch, saa_ops, saa_ref, checks, s, n, d,
                                 rule, case, gen, rule_free=rule == rules[0])
    # n = 30: the cluster kernel reads U from L2; 9 chunks: two a block;
    # 17: three a block, past the threshold (the chain by default)
    grid = [(1, n, MAIN_D) for n in (1, 2, 10, 16, 30)] + [
        (3, 10, MAIN_D), (2, 10, 9 * saa_ops.D_BLK), (1, 16, 17 * saa_ops.D_BLK),
        LARGE]
    check_grid(grid)

    def check_trim_grid(ns, ds):
        for n in ns:
            for d in ds:
                for case in TRIM_CASES:
                    check_trimmed(torch, trim_ops, trim_ref, checks, n, d,
                                  case, gen)
    r_max = trim_ops.REGS_MAX_N   # n around the regs/sort threshold too
    check_trim_grid(sorted({*TRIM_GRID_N, r_max - 1, r_max, r_max + 1}), TRIM_D)
    check_trim_grid(TRIM_EDGE_N, TRIM_D[:1])
    check_partials_grid(torch, saa_ops, saa_ref, checks, gen)
    for k in REPLACES:
        print(f"{k} == plain version in {checks.n[k]} checks "
              f"(max abs err {checks.err[k]:.3g}, relative {checks.rel[k]:.3g})")
    print("apply kernels == aggregate kernels + torch's params + lr * agg, "
          "bitwise, in every check")
    print(f"{WAGG} == the server step's aggregate on its weights, bitwise, in "
          f"{checks.bits[WAGG]} checks; {TRIM} variants == the row-order plain "
          f"version, bitwise, in " + ", ".join(
              f"{checks.bits[f'{TRIM}:{v}']} ({v})" for v in trim_ops.VARIANTS)
          + f" checks (the wrapper takes regs up to n = {trim_ops.REGS_MAX_N}, sort "
          f"up to {trim_ops.MAX_ROWS['sort']}, rank beyond)")
    print(f"cluster kernel == chain, bitwise (weights, aggregates, params of "
          f"kernels 1-4), in {sum(checks.same.values())} checks "
          f"({dict(checks.same)} by the variant the shape takes)")
    print(f"{PARTIALS}: cluster kernel == chain, bitwise (num, den as int32), in "
          f"{checks.bits[f'{PARTIALS} cluster == chain']} checks (chunks 1-"
          f"{saa_ops.CLUSTER_MAX_CHUNKS} at n in {PARTIAL_GRID_N}, and every SAA "
          f"check case); the wrapper takes the cluster up to "
          f"{saa_ops.CLUSTER_MAX_CHUNKS} chunks")
    lap("SAA and trimmed-mean kernel checks")
    report["swa_checks"] = check_lm_kernels(torch, checks, gen)
    lap("LM kernel checks")
    # --- the pod FL train step at full width, before any profiler session:
    # its ~1.5 million kernels run after one left later profiler reads empty,
    # and ran slower there
    train, profile_train = train_paths(torch)
    report["train"] = train
    lap("train")

    # --- 3. the paths, launch counters zeroed just before each ----------
    yogi = dict(CAMPAIGNS["RELAY"], server_opt="yogi")
    quick = {                      # campaign -> (config, the kernel it runs)
        "Random": (CAMPAIGNS["Random"], APPLY),
        "RELAY": (CAMPAIGNS["RELAY"], APPLY),
        "RELAY+YoGi": (yogi, AGG),
        "Random flat": (dict(CAMPAIGNS["Random"], fused_rounds=False), CELL_AGG),
        "RELAY flat": (dict(CAMPAIGNS["RELAY"], fused_rounds=False), CELL_AGG),
        "RELAY+YoGi flat": (dict(yogi, fused_rounds=False), CELL_AGG),
    }
    runs = {name: (dict(COMMON, **kw), kernel)
            for name, (kw, kernel) in quick.items()}
    for name, (kw, kernel) in DEFENSES.items():   # None: launches no kernel
        runs[name] = (dict(RACE, **kw), kernel)
        runs[f"{name} flat"] = (dict(RACE, **kw, fused_rounds=False), kernel)
    # the selector race (every registered selector, two flat twins) and
    # fig07's SAFA-vs-RELAY pair: kernel 1 fused, kernel 3 flat
    race = {}
    for sel_name in SELECTOR_TABLE:
        zoo_kw = dict(zoo_base(False), selector=sel_name, seed=0)
        race[f"zoo {sel_name}"] = (zoo_kw, APPLY)
        if sel_name in ZOO_FLAT:
            race[f"zoo {sel_name} flat"] = (dict(zoo_kw, fused_rounds=False),
                                            CELL_AGG)
    race.update({name: (kw, APPLY) for name, kw in FIG07_CELLS.items()})
    runs.update(race)
    gpu, sims, launches = {}, {}, Counter(train.pop("launches"))
    report["paths"] = {}
    for name, (kw, kernel) in runs.items():
        sims[name] = Simulator(SimConfig(**kw), device="cuda")
        LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gpu[name], stats = drive(sims[name])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got, n_agg = dict(LAUNCHES), aggregated(gpu[name])
        want = expected_launches(saa_ops, trim_ops, kernel, gpu[name])
        if n_agg == 0 or got != want:
            fail(f"{name}: launches {got}, expected {want} (one per round "
                 "that aggregated, each on the cluster kernel for kernels 1-4 "
                 "and on the variant its n takes for the trimmed mean, and no "
                 "other kernel)")
        if stats is not None:
            graph_gate(name, stats, kernel, len(gpu[name].records))
        launches.update(got)
        summ = gpu[name].summary()
        report["paths"][name] = {
            "launches": got, "aggregated_rounds": n_agg, "first_run_s": wall,
            "final_accuracy": summ["final_accuracy"],
            "robust_rejected": summ["robust_rejected"],
            "robust_trimmed": summ["robust_trimmed"], "pipeline": stats}
        print(f"{name}: {got} over {n_agg} aggregating rounds, {wall:.2f}s "
              "first run" + ("" if stats is None else (
                  f"; {stats['graph_replays']} rounds replayed from "
                  f"{stats['graph_captures']} graphs" if stats["graphed"]
                  else "; eager rounds")))
    # K-round chunks: the fused quickstart campaigns at K = CHUNK_K, through
    # the same graphs, bit for bit their K = 1 runs, the same launches
    report["chunks"] = {}
    for name in QUICK_FUSED:
        kw, kernel = runs[name]
        cfg = SimConfig(**kw, rounds_per_dispatch=CHUNK_K)
        sim = Simulator(cfg, device="cuda")
        LAUNCHES.clear()
        acct, stats = drive(sim)
        got = dict(LAUNCHES)
        graph_gate(f"{name} K={CHUNK_K}", stats, kernel, len(acct.records))
        want = chunk_count(cfg, CHUNK_K, [r.round_idx for r in acct.records])
        if got != report["paths"][name]["launches"]:
            fail(f"{name} K={CHUNK_K}: launches {got}, the K = 1 run's "
                 f"{report['paths'][name]['launches']}")
        if stats["dispatches"]["round"] != want:
            fail(f"{name} K={CHUNK_K}: {stats['dispatches']['round']} chunks, "
                 f"expected {want}")
        if not same_run(torch, gpu[name], sims[name], acct, sim):
            fail(f"{name} K={CHUNK_K}: differs from K = 1, bitwise")
        launches.update(got)
        report["chunks"][name] = {"launches": got, "pipeline": stats}
        print(f"{name} K={CHUNK_K}: {stats['dispatches']['round']} chunks of "
              f"{stats['rounds']} rounds, {stats['graph_replays']} replays of "
              f"{stats['graph_captures']} graphs, {got}; records and params == "
              "K = 1, bitwise")
    print(table(gpu))
    print(f"--- robustness race ({RACE['attack']}, attack_frac "
          f"{RACE['attack_frac']}, scale {RACE['attack_scale']}) ---")
    for name in DEFENSES:
        summ = gpu[name].summary()
        print(f"{name:20s} accuracy {summ['final_accuracy']:.3f}  rejected "
              f"{summ['robust_rejected']}  trimmed {summ['robust_trimmed']}")
    zoo = zoo_cells(list(SELECTOR_TABLE), False, (0,))
    print("--- selector race (examples/selector_zoo.py, full size, seed 0) ---")
    print(text_table(zoo, [gpu[f"zoo {s}"].summary() for _, s, _, _ in zoo]))
    # the rows a round kernel 1 (3 flat) saw, and where the cluster read U
    report["race"] = {}
    for name in race:
        rows = sorted(r.n_fresh + r.n_stale for r in gpu[name].records
                      if r.n_fresh + r.n_stale > 0)
        resident = sum(cluster_resident(n_, MAIN_D) for n_ in rows)
        report["race"][name] = {
            "rows_min": rows[0], "rows_median": rows[len(rows) // 2],
            "rows_max": rows[-1], "resident_rounds": resident,
            "l2_rounds": len(rows) - resident}
        print(f"{name}: rows a round min {rows[0]}, median "
              f"{rows[len(rows) // 2]}, max {rows[-1]}; the cluster kernel held U "
              f"in shared memory in {resident} rounds, read it from L2 in "
              f"{len(rows) - resident}")

    # the host entry points' A/B path over the flat RELAY campaign's rounds
    cfg = SimConfig(**runs["RELAY flat"][0])
    rec_sim = Simulator(cfg, device="cuda")
    rounds, step = [], rec_sim._aggregate

    def recording(r, lids, fresh, stale, taus):
        agg = step(r, lids, fresh, stale, taus)
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
    if not rounds or got != {k: len(rounds) for k in (
            CELL_APPLY, saa_ops.launch_key(CELL_APPLY, "cluster"), PARTIALS,
            saa_ops.launch_key(PARTIALS, "cluster"), WAGG)}:
        fail(f"A/B path: launches {got} over {len(rounds)} rounds (kernels 4 "
             f"and 5 each on its cluster kernel)")
    launches.update(got)
    report["paths"]["A/B host entries"] = {"launches": got,
                                           "aggregated_rounds": len(rounds),
                                           "max_abs_err_vs_flat": ab_err}
    print(f"A/B host entries over {len(rounds)} RELAY flat rounds: {got}; "
          f"aggregate max abs diff from the flat path {ab_err:.3g}; the "
          f"one-cell apply equals the flat step bitwise")

    # each kernel against its plain version at every n the paths ran it at
    # (the race's n too; the main shapes' n from the other paths)
    ns = {}                          # kernel -> the n it ran at, counted
    race_ns = set()
    for name, (_, kernel) in runs.items():
        if kernel is not None:
            n_agg = [r.n_fresh + r.n_stale for r in gpu[name].records
                     if r.n_fresh + r.n_stale > 0]
            if name in race:
                race_ns.update(n_agg)
            else:
                ns.setdefault(kernel, Counter()).update(n_agg)
    for kernel in (CELL_APPLY, PARTIALS, WAGG):
        ns[kernel] = Counter(u.shape[0] for u, *_ in rounds)
    path_ns = sorted(set().union(*(ns[k] for k in SAA_REPLACES), race_ns)
                     - {n for _, n, _ in grid})
    before = sum(checks.n.values())
    check_grid([(1, n, MAIN_D) for n in path_ns])
    trim_ns = sorted(ns[TRIM])                  # at the path's own D
    check_trim_grid(trim_ns, (TRIM_D[-1],))
    print(f"kernels == plain versions at the paths' other n (SAA {path_ns}, "
          f"trimmed mean {trim_ns} at D={TRIM_D[-1]}): "
          f"{sum(checks.n.values()) - before} more checks; max abs err "
          + ", ".join(f"{k} {checks.err[k]:.3g}" for k in REPLACES))
    # the graphed rounds pad a group's rows: kernels 1 and 2 at every n the
    # paths ran them at, and around the shared-memory edge, against padded n
    pad_ns = sorted(set(ns[APPLY]) | set(ns[AGG]) | race_ns | {27, 28, 29, 33})
    check_padding(torch, saa_ops, checks, pad_ns, gen)
    print(f"kernels 1-2 at n == at n padded with invalid zero rows (to the "
          f"pipeline's operand bucket and to n + 1), bitwise, in "
          f"{checks.bits['kernels 1-2 n == padded n']} checks (n in {pad_ns}, "
          f"S = 1 and 16)")

    lap("FL paths and checks at their n")
    # per-campaign rounds/s: a second, warm run of each, then a profile; the
    # fused quickstart campaigns also at K = CHUNK_K and with their rounds
    # dispatched eagerly (graphs off: this script's comparison only)
    timed = {name: (kw, False) for name, (kw, _) in runs.items()}
    for name in QUICK_FUSED:
        timed[f"{name} K={CHUNK_K}"] = (dict(runs[name][0],
                                             rounds_per_dispatch=CHUNK_K), False)
        timed[f"{name} eager"] = (runs[name][0], True)
    report["campaigns"] = {}
    for name, (kw, eager) in timed.items():
        sim = Simulator(SimConfig(**kw), device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acct, stats = drive(sim, eager)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        summ = acct.summary()
        if eager and not same_run(torch, gpu[name[:-len(" eager")]],
                                  sims[name[:-len(" eager")]], acct, sim):
            fail(f"{name}: the eager rounds differ from the graphed ones, bitwise")
        report["campaigns"][name] = {
            "rounds": len(acct.records), "seconds": secs,
            "rounds_per_s": len(acct.records) / secs,
            "final_accuracy": summ["final_accuracy"],
            "resource_used": summ["resource_used"],
            "waste_fraction": summ["waste_fraction"], "pipeline": stats}
        graphs = ""
        if stats is not None and stats["graphed"]:
            cap = stats["graph_capture_s"]
            report["campaigns"][name].update(
                capture_s=cap, replay_rounds_per_s=len(acct.records) / (secs - cap))
            graphs = (f" ({stats['graph_captures']} captures took {cap:.3f}s; "
                      f"the rest {len(acct.records) / (secs - cap):.1f} rounds/s)")
        print(f"{name}: {len(acct.records)} rounds in {secs:.3f}s = "
              f"{len(acct.records) / secs:.1f} rounds/s{graphs}")

    def profile_campaigns():
        """A profile of the first timed campaign of each family
        (``PROFILED``), run again; taken after the kernel times (many traces
        in a process broke a later profiler read).  The busy time is also
        set against the unprofiled run's wall: the profiler's host cost
        inflates a graphed run's wall most."""
        for i, name in enumerate(PROFILED):
            kw, eager = timed[name]
            prof = profile_campaign(torch, lambda: drive(
                Simulator(SimConfig(**kw), device="cuda"), eager)[0],
                compare_readers=i == 0)
            camp = report["campaigns"][name]
            prof["busy_share_of_unprofiled_wall"] = (
                prof["device_busy_ms"] / (camp["seconds"] * 1e3))
            camp["profile"] = prof
            idle = prof["device_idle_share"]
            print(f"{name} profile: {prof['gpu_kernels']} GPU kernels, device "
                  f"busy {prof['device_busy_ms']:.1f} of {prof['wall_ms']:.1f} ms "
                  f"(idle share {'not measured' if idle is None else f'{idle:.3f}'}"
                  f"; {prof['busy_share_of_unprofiled_wall']:.3f} of the "
                  f"unprofiled run's {camp['seconds'] * 1e3:.1f} ms)")
            print("  host spans (CPU ms): " + ", ".join(
                f"{k} {v:.1f}" for k, v in sorted(prof["host_spans_ms"].items())))
            for kname, ms in prof["top_kernels_ms"].items():
                print(f"  {ms:9.3f} ms  {kname[:90]}")

    print("--- fig07 SAFA vs RELAY (label_uniform, DL, 688 Mbit) ---")
    for name in FIG07_CELLS:
        c = report["campaigns"][name]
        print(f"{name}: resource_used {c['resource_used']:.1f} s, waste_fraction "
              f"{c['waste_fraction']:.4f}, final accuracy {c['final_accuracy']:.4f}")
    lap("FL campaigns timed")
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
    twins = [name for name in runs if f"{name} flat" in runs]
    for fused in twins:
        flat = f"{fused} flat"
        if [record_bits(r) for r in gpu[fused].records] != \
                [record_bits(r) for r in gpu[flat].records]:
            fail(f"{flat}: records differ from the fused pipeline's")
        if not torch.equal(sims[fused].flat_params, sims[flat].flat_params):
            fail(f"{flat}: params differ from the fused pipeline's")
        if robust_counts(gpu[fused]) != robust_counts(gpu[flat]):
            fail(f"{flat}: robust counters differ from the fused pipeline's")
    print(f"flat == fused on the GPU, bitwise: records, params and robust "
          f"counters of {', '.join(twins)}")
    if not (gpu["coord_median"].summary()["robust_trimmed"] > 0
            and gpu["coord_median"].summary()["final_accuracy"]
            > gpu["saa (attacked)"].summary()["final_accuracy"]):
        fail("coord_median did not beat attacked saa under the attack")
    print(f"coord_median beat attacked saa: final accuracy "
          f"{gpu['coord_median'].summary()['final_accuracy']:.3f} vs "
          f"{gpu['saa (attacked)'].summary()['final_accuracy']:.3f}")
    for name, (kw, _) in runs.items():
        cpu_sim = Simulator(SimConfig(**kw), device="cpu")
        cpu = cpu_sim.run()
        if [host(r) for r in gpu[name].records] != [host(r) for r in cpu.records]:
            fail(f"{name}: GPU host records differ from the CPU run")
        if robust_counts(gpu[name]) != robust_counts(cpu):
            fail(f"{name}: robust counters {robust_counts(gpu[name])} differ "
                 f"from the CPU run's {robust_counts(cpu)}")
        if attacker_sets(sims[name]) != attacker_sets(cpu_sim):
            fail(f"{name}: attacker sets differ from the CPU run's")
    small = dict(n_learners=30, rounds=8, eval_every=4, seed=2, n_target=4,
                 mapping="label_uniform", use_agg_kernel=True, selector="priority",
                 saa=True, apt=True, scaling_rule="relay")
    report["small_run_max_abs_diff"] = {}
    for label, kw in (("RELAY", {}), ("RELAY+YoGi", {"server_opt": "yogi"}),
                      ("RELAY flat", {"fused_rounds": False}),
                      ("coord_median (attacked)", dict(
                          aggregator="coord_median", attack="collude_signflip",
                          attack_frac=0.25, attack_scale=10.0))):
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

    lap("FL results against the CPU")
    # --- the chaos harness: faults, the guard, crash and resume ---------
    report["chaos"], chaos_ns = chaos_paths(torch, launches)
    # each kernel against its plain version at the n the chaos runs gave
    # it, with the screened case's holes among them
    saa_ns = sorted(set().union(*(chaos_ns.get(k, ()) for k in SAA_REPLACES)))
    trim_ns = sorted(chaos_ns.get(TRIM, ()))
    pad_ns = sorted(set(chaos_ns.get(APPLY, ())) | set(chaos_ns.get(AGG, ())))
    before = sum(checks.n.values())
    check_grid([(1, n, MAIN_D) for n in saa_ns])
    check_trim_grid(trim_ns, (TRIM_D[-1],))
    check_padding(torch, saa_ops, checks, pad_ns, gen)
    report["chaos"]["kernel_checks"] = {
        "saa_n": saa_ns, "trimmed_n": trim_ns, "padded_n": pad_ns,
        "checks": sum(checks.n.values()) - before,
        "screened": checks.cases["screened"]}
    print(f"chaos: kernels == plain versions at the chaos runs' n (SAA "
          f"{saa_ns}, every case with the screened one; trimmed mean "
          f"{trim_ns} at D={TRIM_D[-1]}; kernels 1-2 n == padded n at "
          f"{pad_ns}): {sum(checks.n.values()) - before} more checks, "
          f"{checks.cases['screened']} screened in all")
    lap("chaos harness")
    # --- telemetry: the round-stats lane in the round graph, the round log
    report["telemetry"] = telemetry_paths(torch, launches)
    lap("telemetry")
    # --- the federated LM learner: kernels 1-3 on their chain -----------
    report["lm"], time_lm_chain, profile_lm = lm_fl_paths(
        torch, launches, checks, check_grid, gen)
    lap("LM FL paths")
    # --- the sweep paths: lockstep batches of S cells --------------------
    report["sweeps"], profile_sweeps = sweep_paths(torch, gen, checks, launches)
    lap("sweep paths")
    # --- sharding: ranks of a torch.distributed group --------------------
    report["sharding"] = sharding_paths(torch, launches)
    lap("sharding")
    # --- the legacy engine and the placed train step ----------------------
    report["legacy_launch"] = legacy_launch_paths(torch, launches, gpu, sims, runs,
                                                  report["paths"], train)
    lap("legacy engine and launch layer")
    # --- the model zoo's serve path at full width -----------------------
    serve = serve_paths(torch)
    launches.update(serve.pop("launches"))
    report["serve"] = serve
    lap("serve path")
    # --- the other eight architectures at full width --------------------
    arch = arch_paths(torch)
    launches.update(arch.pop("launches"))
    report["architectures"] = arch
    lap("architectures")

    # --- 5. kernel times ------------------------------------------------
    times = {}
    for kernel in SAA_REPLACES:
        n_main = ns[kernel].most_common(1)[0][0]
        times[kernel] = {
            "main": time_kernel(torch, saa_ops, saa_ref, kernel, 1, n_main,
                                MAIN_D, 500, gen),
            "large": time_kernel(torch, saa_ops, saa_ref, kernel, *LARGE, 50, gen)}
    # kernel 1 at the median rows a round of fig07's SAFA cell
    n_safa = report["race"]["fig07 SAFA"]["rows_median"]
    times[APPLY][f"fig07 SAFA n={n_safa}"] = time_kernel(
        torch, saa_ops, saa_ref, APPLY, 1, n_safa, MAIN_D, 500, gen)
    times[TRIM] = {
        "main": time_trimmed(torch, trim_ops, trim_ref,
                             ns[TRIM].most_common(1)[0][0], TRIM_D[-1], 500,
                             gen),
        **{label: time_trimmed(torch, trim_ops, trim_ref, n_, d_, 20 if n_ < 256 else 10,
                               gen, plain=label in ("large", "n256"))
           for label, (n_, d_) in TRIM_TIMES.items()}}
    for kernel in REPLACES:
        for label, t in times[kernel].items():
            lib = ("" if t["library_ms"] is None else
                   f", library {t['library_ms']:.4f} ms (device "
                   f"{t['library_device_ms']:.4f}, its kernels "
                   f"{t['library_kernel_ms']:.5f} by the profiler)")
            var = (f" [{t['variant']}]" if "variant" in t else "") + (
                f", its kernels {t['kernel_ms']:.5f} by the profiler")
            plain = ("" if "plain_ms" not in t else
                     f", plain {t['plain_ms']:.4f} ms (device {t['plain_device_ms']:.4f})")
            old = ("" if "saa_apply_kernel_ms" not in t else
                   f"; its former route, the chain's saa_apply, "
                   f"{t['saa_apply_kernel_ms']:.5f} by the profiler")
            print(f"{kernel} {label} {t['shape']}: kernel {t['ms']:.4f} ms "
                  f"(device {t['device_ms']:.4f}){var}{plain}{lib}, bound "
                  f"{t['bound_ms']:.6f} ms ({t['bound_by']}){old}")
            for v, tv in t.get("by_variant", {}).items():
                print(f"  {kernel} {label} forced {v}: {tv['ms']:.4f} ms events "
                      f"(runs {', '.join(f'{x:.4f}' for x in tv['ms_runs'])}), device "
                      f"{tv['device_ms']:.4f}, its kernels {tv['kernel_ms']:.5f} by the "
                      f"profiler")
            for v, tv in t.get("variants", {}).items():
                print(f"  {kernel} {label} variant {v}: {tv['ms']:.4f} ms events (the "
                      f"default's in turn {min(tv['default_ms_runs']):.4f}), device "
                      f"{tv['device_ms']:.4f}, its kernel {tv['kernel_ms']:.5f} by the "
                      f"profiler")
    # where kernel 6's host time goes
    from repro_torch.kernels import _launch
    host_ns = host_path(torch, saa_ops, _launch, ns[WAGG].most_common(1)[0][0], MAIN_D, gen)
    print(f"wrapper host path ({WAGG}, n={ns[WAGG].most_common(1)[0][0]} D={MAIN_D}; ns a "
          f"call, host clock, 10,000 calls each): " + "; ".join(
              f"{k} {v:.0f}" for k, v in host_ns.items()))
    times["host_path"] = host_ns
    # the fused server step's two variants, beside the launch floor
    floor = launch_floor(torch, _build.library("staleness_agg"))
    print(f"launch floor, one empty block: {floor['ms']:.5f} ms events, "
          f"{floor['device_ms']:.5f} graph replay, {floor['kernel_ms']:.5f} by the "
          f"profiler; the main shape's bound {times[APPLY]['main']['bound_ms']:.6f} ms")
    variants = {label: time_variants(torch, saa_ops, *shape,
                                     1 if shape == LARGE else 200, gen)
                for label, shape in VARIANT_SHAPES.items()}
    faster = []                  # chunk counts at n = 10 where the cluster wins
    for label, by in variants.items():
        s_, n_, d_ = VARIANT_SHAPES[label]
        print(f"{APPLY} {label} (S={s_} n={n_} D={d_}, takes "
              f"{saa_ops.variant(s_, n_, d_)}): " + "; ".join(
                  f"{v} {t['ms']:.5f} ms events" + (
                      "" if t["device_ms"] is None else
                      f", device {t['device_ms']:.5f}, its kernels "
                      f"{t['kernel_ms']:.5f} (profiler)")
                  for v, t in by.items()))
        if n_ == 10 and s_ == 1 and by["cluster"]["device_ms"] <= by["chain"]["device_ms"]:
            faster.append(d_ // saa_ops.D_BLK)
    print(f"cluster/chain threshold: the cluster kernel is as fast or faster by "
          f"device time at n=10 with {sorted(faster)} chunks; the wrapper takes it "
          f"up to {saa_ops.CLUSTER_MAX_CHUNKS} chunks")
    phases = cluster_phases(torch, gen, [(10, MAIN_D), (16, MAIN_D), (30, MAIN_D),
                                         (10, 16 * saa_ops.D_BLK)])
    for label, ph in phases.items():
        print(f"saa_cluster phases at {label} (ms, device clock): " + ", ".join(
            f"{k} {v:.5f}" for k, v in ph.items()))
    times["launch_floor"], times["variants"] = floor, variants
    times["cluster_phases"] = phases
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
    times.update(time_lm_kernels(torch, gen))
    times["lm_chain"] = time_lm_chain()
    lap("kernel times")
    profile_campaigns()       # last: the campaigns' and sweeps' profiles
    profile_lm()
    lap("FL campaign profiles")
    profile_sweeps()
    lap("sweep profiles")
    profile_train()           # the train step's profile, with the others
    lap("train profile")
    # --- the pod dry run: host-only, after every timed phase ------------
    report["dryrun"] = dryrun_paths()
    lap("dry run")
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in report["phase_s"].items()))
    report.update(times=times, launches=dict(launches),
                  kernel_checks=dict(checks.n), check_cases=dict(checks.cases),
                  cluster_equals_chain=dict(checks.same),
                  bitwise_checks=dict(checks.bits),
                  max_abs_err=dict(checks.err),
                  max_rel_err=dict(checks.rel),
                  main_path_n={k: dict(v) for k, v in ns.items()})
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(report, indent=1))

    kernels = [{
        "name": kernel, "route": "cuda",
        "source": TRIM_SOURCE if kernel == TRIM else SOURCE,
        "replaces": REPLACES[kernel], "launches": launches[kernel],
        "max_abs_err": checks.err[kernel],
        "ms": times[kernel]["main"]["ms"],
        "plain_ms": times[kernel]["main"]["plain_ms"],
        "bound_ms": times[kernel]["main"]["bound_ms"],
        "bound_by": times[kernel]["main"]["bound_by"],
        "library_ms": times[kernel]["main"]["library_ms"],
    } for kernel in REPLACES] + [{
        "name": kernel, "route": "cuda", "source": LM_SOURCES[kernel],
        "replaces": LM_REPLACES[kernel], "launches": launches[kernel],
        "max_abs_err": checks.err[kernel],
        **{key: times[kernel][key] for key in ("ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")},
    } for kernel in LM_REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
