"""Serve-path steps: prefill (full prompt), full-sequence logits and
single-token decode (``repro.launch.serve``).

In the FL system these serve the *global* model (server-side eval or
deployment of the trained model).  PyTorch runs eagerly: the steps are the
model functions themselves, under ``torch.inference_mode``, and
``greedy_generate`` is a host loop of eager steps.
"""
from __future__ import annotations

import torch

from repro_torch.models import ModelConfig, decode_step, prefill
from repro_torch.models.transformer import _logits, forward


def make_prefill_step(cfg: ModelConfig):
    @torch.inference_mode()
    def step(params, batch):
        return prefill(cfg, params, batch)
    return step


def make_decode_step(cfg: ModelConfig):
    @torch.inference_mode()
    def step(params, state, tokens, position):
        return decode_step(cfg, params, state, tokens, position)
    return step


def make_logits_fn(cfg: ModelConfig):
    """Full-sequence logits (eval/perplexity path)."""
    @torch.inference_mode()
    def fn(params, batch):
        x, _, _ = forward(cfg, params, batch)
        return _logits(cfg, params, x)
    return fn


def greedy_generate(cfg: ModelConfig, params, state, first_token, start_pos,
                    n_tokens: int):
    """Host-loop greedy decoding used by the serving example.  first_token,
    start_pos: (B,) int32.  Returns (tokens (B, n_tokens + 1), state)."""
    toks = [first_token]
    pos = start_pos
    step = make_decode_step(cfg)
    cur = first_token
    for _ in range(n_tokens):
        logits, state = step(params, state, cur, pos)
        cur = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(cur)
        pos = pos + 1
    return torch.stack(toks, dim=1), state
