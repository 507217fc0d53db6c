"""RWKV6 "Finch" block: attention-free time mixing with data-dependent decay
(``repro.models.rwkv6``).

Recurrence (per head, head dim N, state S in R^{N x N}):
    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
with w_t = exp(-exp(w0 + lora_w(ddlerp(x)))) data-dependent per channel.

``wkv6_scan`` is the plain time loop, the plain version of the CUDA kernel in
``repro_torch.kernels.wkv6``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init

DDLERP_COMPONENTS = ("r", "k", "v", "w", "g")


def rwkv6_init(gen, d_model: int, n_heads: int, *, lora_rank: int = 32,
               w_lora_rank: int = 64, dtype=torch.bfloat16):
    N = d_model // n_heads
    dev = gen.device
    p = {
        "mu_x": torch.zeros((d_model,), dtype=dtype, device=dev),
        "w0": torch.full((d_model,), -6.0, dtype=torch.float32, device=dev),
        "u": torch.zeros((n_heads, N), dtype=torch.float32, device=dev),
        "ln_x_scale": torch.ones((d_model,), dtype=torch.float32, device=dev),
    }
    for c in DDLERP_COMPONENTS:
        p[f"mu_{c}"] = torch.zeros((d_model,), dtype=dtype, device=dev)
        rank = w_lora_rank if c == "w" else lora_rank
        p[f"lora_{c}_a"] = dense_init(gen, (d_model, rank), dtype)
        p[f"lora_{c}_b"] = dense_init(gen, (rank, d_model), dtype)
    for c in ("r", "k", "v", "g", "o"):
        p[f"w_{c}"] = dense_init(gen, (d_model, d_model), dtype)
    return p


def _ddlerp(params, x, x_prev):
    """Data-dependent lerp producing the 5 mixed inputs (r, k, v, w, g)."""
    xx = x_prev - x
    base = x + xx * params["mu_x"]
    outs = {}
    for c in DDLERP_COMPONENTS:
        lo = torch.tanh(base @ params[f"lora_{c}_a"]) @ params[f"lora_{c}_b"]
        outs[c] = x + xx * (params[f"mu_{c}"] + lo)
    return outs


def _project(params, mixed, n_heads):
    d = mixed["r"].shape[-1]
    shp = mixed["r"].shape[:-1] + (n_heads, d // n_heads)
    r = (mixed["r"] @ params["w_r"]).reshape(shp)
    k = (mixed["k"] @ params["w_k"]).reshape(shp)
    v = (mixed["v"] @ params["w_v"]).reshape(shp)
    g = F.silu(mixed["g"] @ params["w_g"])
    w_log = params["w0"] + (torch.tanh(mixed["w"] @ params["lora_w_a"])
                            @ params["lora_w_b"]).float()
    w = torch.exp(-torch.exp(w_log)).reshape(shp)  # decay in (0, 1), fp32
    return r, k, v, w, g


def _group_norm(x, scale, n_heads, eps=1e-5):
    # per-head LayerNorm on the flattened (H*N) output, as in RWKV6; the
    # population variance (ddof 0), as the reference's jnp.var
    shp = x.shape
    xh = x.reshape(shp[:-1] + (n_heads, shp[-1] // n_heads)).float()
    mean = xh.mean(dim=-1, keepdim=True)
    var = xh.var(dim=-1, keepdim=True, correction=0)
    xh = (xh - mean) * torch.rsqrt(var + eps)
    return (xh.reshape(shp) * scale).to(x.dtype)


def wkv6_scan(r, k, v, w, u, state0=None):
    """Sequential WKV6 recurrence. r,k,v,w: (B, S, H, N); u: (H, N) (or
    anything that broadcasts to (B, H, N)).

    Returns (y: (B, S, H, N) in v's dtype, final_state: (B, H, N, N) fp32).
    """
    B, S, H, N = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    s = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())
    uf = u.float()[..., :, None]
    ys = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]        # (B, H, N, N)
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], s + uf * kv))
        s = wf[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1).to(v.dtype), s


def rwkv6_forward(params, x, *, n_heads, state=None, use_kernel=False):
    """Full-sequence RWKV6 time mixing. x: (B, S, d).

    state (decode continuation): {"x_prev": (B, d), "wkv": (B, H, N, N)} or None.
    Returns (out, new_state).
    """
    B, S, d = x.shape
    first = state["x_prev"][:, None] if state is not None else torch.zeros_like(x[:, :1])
    x_prev = torch.cat([first, x[:, :-1]], dim=1)
    mixed = _ddlerp(params, x, x_prev)
    r, k, v, w, g = _project(params, mixed, n_heads)
    u = params["u"]
    s0 = state["wkv"] if state is not None else None
    if use_kernel:
        from repro_torch.kernels.wkv6 import ops as wkv_ops
        y, s_fin = wkv_ops.wkv6(r, k, v, w, u, state0=s0)
    else:
        y, s_fin = wkv6_scan(r, k, v, w, u, state0=s0)
    y = _group_norm(y.reshape(B, S, d), params["ln_x_scale"], n_heads)
    out = (y * g) @ params["w_o"]
    return out, {"x_prev": x[:, -1], "wkv": s_fin}


def rwkv6_decode(params, x, state, *, n_heads):
    """Single-token step; x: (B, 1, d), state as above.  The step goes
    through the WKV6 kernel's wrapper (the kernel at S = 1 on the card; the
    same scan as the reference's on the CPU)."""
    return rwkv6_forward(params, x, n_heads=n_heads, state=state, use_kernel=True)
