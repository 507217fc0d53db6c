"""Serve an architecture with batched greedy decoding (the port's
``examples/serve_model.py``): feed a batch of random prompts token by token
through the decode path (cache warm-up), then step the ring-buffered KV /
recurrent state with greedy decoding, at the reduced config of any of the
zoo's ten architectures (default deepseek-v2-lite-16b, as the example's).
Runs on the GPU unless given ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.serve_model --arch deepseek-v2-lite-16b
  PYTHONPATH=src python -m repro_torch.serve_model --arch jamba-v0.1-52b --device cpu
"""
import argparse
import time

import torch

from repro_torch.configs import get_reduced
from repro_torch.launch.serve import greedy_generate, make_decode_step
from repro_torch.models import init_decode_state, init_params
from repro_torch.sim.engine import resolve_device


def serve(cfg, params, prompt: torch.Tensor, gen_len: int):
    """Decode ``prompt`` (B, P) int32 token by token, then ``gen_len``
    greedy tokens.  Returns (tokens (B, gen_len + 1), the logits after the
    prompt (B, vocab), final state)."""
    B, P = prompt.shape
    device = prompt.device
    state = init_decode_state(cfg, B, P + gen_len + 1, device)
    step = make_decode_step(cfg)
    for t in range(P):
        logits, state = step(params, state, prompt[:, t],
                             torch.full((B,), t, dtype=torch.int32, device=device))
    next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    toks, state = greedy_generate(cfg, params, state, next_tok,
                                  torch.full((B,), P, dtype=torch.int32, device=device),
                                  gen_len)
    return toks, logits, state


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="deepseek-v2-lite-16b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU, required)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device, dtype=torch.int32)
    t0 = time.perf_counter()
    toks, _, _ = serve(cfg, params, prompt, args.gen_len)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    total = args.batch * (args.prompt_len + args.gen_len)
    print(f"arch={cfg.arch_id} ({cfg.family})  batch={args.batch}")
    print(f"generated {toks.shape[1]} tokens/seq in {dt:.1f}s "
          f"({total / dt:.0f} tok/s on {where})")
    print("sample:", toks[0, :16].tolist())


if __name__ == "__main__":
    main()
