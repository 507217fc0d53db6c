"""Time the serve path's greedy requests on the card, repeated, so that two
trees of the port can be compared in one call.

    PYTHONPATH=src python tools/time_requests.py [--arch qwen2.5-3b,rwkv6-1.6b]
        [--repeats 5] [--tag NAME] [--reduced --device cpu]

Each arch runs at full width in bf16 with ``use_kernels=True`` under
``adapt_for_shape(..., long_500k)``, as chip_smoke.py's serve phases build
it, on weights from a seeded generator: ``serve_model.serve`` of B = 4
prompts of 12 tokens and 24 generated tokens (chip_smoke.py's
``REQUESTS``), once cold, then ``--repeats`` times warm, each timed on the
host clock between synchronizations.  The last line is one JSON object:
the tag, the torch version, the ``repro_torch`` it imported, and per arch
the warm tokens/s of every repeat and their median.  Run with
``PYTHONPATH`` pointing at another tree's ``src`` to time that tree.
``--reduced --device cpu`` runs the archs' REDUCED configs in fp32 on one
CPU thread instead: a decode step of a few narrow layers, whose time is
mostly the host's Python and dispatch, the part of a card's decode step
that two trees' host code can change.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import torch

import repro_torch
from repro_torch.configs import adapt_for_shape, get_config, get_reduced, shape_for
from repro_torch.models import init_params
from repro_torch.serve_model import serve

B, PROMPT, GEN = 4, 12, 24


def time_arch(arch: str, repeats: int, device: str = "cuda",
              reduced: bool = False) -> dict:
    if reduced:
        cfg = dataclasses.replace(get_reduced(arch), param_dtype=torch.float32)
    else:
        cfg = dataclasses.replace(
            adapt_for_shape(get_config(arch), shape_for("long_500k")), use_kernels=True)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen)
    prompt = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen, device=device,
                           dtype=torch.int32)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    rates = []
    with torch.inference_mode():
        serve(cfg, params, prompt, GEN)             # cold: builds and caches
        for _ in range(repeats):
            sync()
            t0 = time.perf_counter()
            toks, _, _ = serve(cfg, params, prompt, GEN)
            sync()
            rates.append(B * (PROMPT + GEN) / (time.perf_counter() - t0))
    if not torch.isfinite(toks.float()).all():
        raise SystemExit(f"{arch}: tokens not finite")
    del params
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"tokens_per_s": rates, "median": statistics.median(rates)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-3b,minicpm-2b,rwkv6-1.6b")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true",
                    help="the REDUCED configs in fp32 (with --device cpu: one thread)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    if args.device == "cpu":
        torch.set_num_threads(1)
    out = {"tag": args.tag, "torch": torch.__version__, "device": args.device,
           "reduced": args.reduced, "repro_torch": repro_torch.__file__, "archs": {}}
    for arch in args.arch.split(","):
        out["archs"][arch] = r = time_arch(arch, args.repeats, args.device, args.reduced)
        print(f"{args.tag} {arch}: requests {r['median']:.1f} tokens/s (median of "
              f"{args.repeats}; " + ", ".join(f"{x:.1f}" for x in r["tokens_per_s"]) + ")",
              flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
