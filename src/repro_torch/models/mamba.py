"""Mamba (S6) selective-state-space block, used by the Jamba hybrid layers
(``repro.models.mamba``).

h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t ;  y_t = C_t . h_t + D * x_t
with (dt, B, C) data-dependent.  Sequential scan in fp32; O(1) decode state.

The reference scans time with ``lax.scan`` in rematerialized chunks of
``SCAN_CHUNK`` steps, which bounds its backward's residuals and changes no
value.  The port serves only, so it walks time in a plain loop: each chunk
of ``SCAN_CHUNK`` steps computes its decays and inputs at once, then one
``addcmul`` a step carries the state, and the chunk's outputs are read from
its states at once.  The reference has no kernel here; neither has the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import shard_hints
from repro_torch.models.layers import contiguous_grad, dense_init

SCAN_CHUNK = 256  # steps whose decays, inputs and states are held at once


def mamba_init(gen, d_model: int, *, d_state: int = 16, expand: int = 2,
               dt_rank: int | None = None, conv_width: int = 4,
               dtype=torch.bfloat16):
    """``A_log``, ``dt_bias`` and ``D`` are fp32 whatever ``dtype`` is."""
    d_inner = expand * d_model
    dt_rank = dt_rank or max(1, d_model // 16)
    dev = gen.device
    A = torch.arange(1, d_state + 1, dtype=torch.float32, device=dev)
    return {
        "w_in": dense_init(gen, (d_model, 2 * d_inner), dtype),
        "conv_w": dense_init(gen, (conv_width, d_inner), dtype, scale=0.5),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "w_x": dense_init(gen, (d_inner, dt_rank + 2 * d_state), dtype),
        "w_dt": dense_init(gen, (dt_rank, d_inner), dtype),
        "dt_bias": torch.zeros((d_inner,), dtype=torch.float32, device=dev),
        "A_log": torch.log(A.expand(d_inner, d_state)),
        "D": torch.ones((d_inner,), dtype=torch.float32, device=dev),
        "w_out": dense_init(gen, (d_inner, d_model), dtype),
    }


def _ssm_inputs(params, xs, dt_rank, d_state):
    """xs: (B, S, d_inner) post-conv activations -> (dt, Bmat, Cmat), fp32."""
    # placed, w_x splits its rows over the model axis: the product's partial
    # sums are added before the split into dt, B and C
    xdb = shard_hints.reduced(xs @ params["w_x"])
    dt_low, Bm, Cm = torch.split(xdb, [dt_rank, d_state, d_state], dim=-1)
    dt = F.softplus((dt_low @ params["w_dt"]).float() + params["dt_bias"])
    return dt, Bm.float(), Cm.float()


def _scan(x, dt, Bm, Cm, A, h):
    """The selective scan over S steps from state ``h`` (B, d_inner, N).
    x, dt: (B, S, d_inner); Bm, Cm: (B, S, N); all fp32.  Returns
    (ys (B, S, d_inner), final state)."""
    S = x.shape[1]
    ys = []
    for t0 in range(0, S, SCAN_CHUNK):
        sl = slice(t0, min(t0 + SCAN_CHUNK, S))
        # time first, so that a step's slices are contiguous
        dt_c = dt[:, sl].transpose(0, 1)[..., None]                  # (L, B, d_inner, 1)
        dA = torch.exp(dt_c * A)                                     # (L, B, d_inner, N)
        dBx = dt_c * Bm[:, sl].transpose(0, 1)[:, :, None, :] \
            * x[:, sl].transpose(0, 1)[..., None]
        steps = []              # stacked after the loop: autograd records no out=
        for t in range(dA.shape[0]):
            h = torch.addcmul(dBx[t], dA[t], h)                      # dA h + dBx
            steps.append(h)
        hs = torch.stack(steps)
        ys.append((hs * Cm[:, sl].transpose(0, 1)[:, :, None, :]).sum(-1))
    return torch.cat(ys, dim=0).transpose(0, 1), h


def mamba_forward(params, x, *, d_state: int = 16, expand: int = 2,
                  dt_rank: int | None = None, conv_width: int = 4, state=None):
    """x: (B, S, d). state: {"conv": (B, W-1, d_inner), "ssm": (B, d_inner, N)} | None.

    Returns (out, new_state)."""
    B, S, d = x.shape
    d_inner = expand * d
    dt_rank = dt_rank or max(1, d // 16)
    xs, z = (x @ params["w_in"]).chunk(2, dim=-1)     # (B, S, d_inner) each

    # causal conv1d over time; a fresh state's zeros take the activation's
    # shard shapes and placement (a DTensor's zeros_like is one)
    conv_prev = (state["conv"] if state is not None
                 else torch.zeros_like(xs[:, :1]).expand(B, conv_width - 1, d_inner))
    xpad = torch.cat([conv_prev, xs], dim=1)          # (B, S+W-1, d_inner)
    cw = params["conv_w"]
    xc = sum(xpad[:, i:i + S] * cw[i] for i in range(conv_width)) + params["conv_b"]
    xc = F.silu(xc)
    new_conv = xpad[:, xpad.shape[1] - (conv_width - 1):]

    dt, Bm, Cm = _ssm_inputs(params, xc, dt_rank, d_state)
    A = -torch.exp(params["A_log"])                   # (d_inner, N)
    h0 = (state["ssm"] if state is not None
          else torch.zeros_like(xc[:, 0], dtype=torch.float32)[..., None].expand(
              B, d_inner, d_state))
    xcf = xc.float()
    xcf, dt, Bm, Cm = (contiguous_grad(t) for t in (xcf, dt, Bm, Cm))
    ys, h_fin = _scan(xcf, dt, Bm, Cm, A, h0)
    y = ys + params["D"] * xcf
    out = (y.to(x.dtype) * F.silu(z)) @ params["w_out"]
    return out, {"conv": new_conv, "ssm": h_fin}


def mamba_decode(params, x, state, **kw):
    return mamba_forward(params, x, state=state, **kw)
