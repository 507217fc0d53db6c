"""Primitive layers shared by every architecture: norms, RoPE, MLPs,
embeddings (``repro.models.layers``).

Initial weights come from a ``torch.Generator`` and are made on its device.
The distributions are the reference's; torch cannot reproduce the
reference's ``jax.random`` stream, so parity runs carry the reference's
weights across with ``repro_torch.weights.from_jax_tree``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, dtype, scale: float | None = None):
    """Truncated-normal fan-in init (LeCun-style): N(0, 1) cut at +-2, times
    ``fan_in ** -0.5`` (the second-to-last axis), drawn in fp32."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    if gen.device.type == "meta":                 # shape only: nothing drawn
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return x.mul_(std).to(dtype)      # in place: one fp32 copy of a large leaf


def embed_init(gen: torch.Generator, shape, dtype):
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (x * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, device, dtype=torch.float32):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-5):
    # Norm statistics in fp32 for stability regardless of activation dtype.
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(d_head: int, theta: float, device):
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, Dh); positions broadcastable to (..., S).  The
    split-halves form: the first and second halves of Dh are the pairs."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)                # (Dh/2,)
    angles = positions[..., :, None].float() * freqs                 # (..., S, Dh/2)
    sin = torch.sin(angles)[..., :, None, :]                         # (..., S, 1, Dh/2)
    cos = torch.cos(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def mlp_init(gen, d_model: int, d_ff: int, dtype):
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype),
        "w_up": dense_init(gen, (d_model, d_ff), dtype),
        "w_down": dense_init(gen, (d_ff, d_model), dtype),
    }


def mlp(params, x):
    gate = F.silu(x @ params["w_gate"])
    up = x @ params["w_up"]
    return (gate * up) @ params["w_down"]


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def embed_init_params(gen, vocab: int, d_model: int, dtype):
    return {"embedding": embed_init(gen, (vocab, d_model), dtype)}


def embed_lookup(params, tokens):
    """``table[tokens]``.  With autograd on it is a one-hot (..., V) product
    with the table: the same values (one nonzero term a sum), and a
    backward that is a GEMM instead of an indexed accumulation of the
    table's gradient (float atomics on CUDA), so training gives the same
    bits every run."""
    table = params["embedding"]
    if not torch.is_grad_enabled():
        return table[tokens]
    cols = torch.arange(table.shape[0], device=tokens.device)
    return (tokens[..., None] == cols).to(table.dtype) @ table


def lm_head(params, x, tie_embedding: bool):
    w = params["embedding"].T if tie_embedding else params["w_out"]
    return x @ w.to(x.dtype)
