"""Mixture-of-Experts layer: shared + routed experts, top-k routing,
capacity dispatch (port of ``repro.models.moe``).

The reference dispatches with scatter-adds into (G, E, C, d) capacity
buffers and combines with a scatter-add over each token's k slots.  The
port computes the same function with no float accumulation whose order
can change from run to run, forward or backward, so a training step gives
the same bits every run on the card:

- dispatch and combine are gathers (``torch.gather``) through index maps
  in which each real position appears at most once: an empty buffer place
  reads a zero pad row of the routed tokens, a dropped slot the zero pad
  row of the buffer.  Their backward scatter-adds at most one term into
  any element the model reads (only the discarded pad rows take several);
- a token's k routed copies are an ``expand`` (its backward a reduction),
  and the combine sums the k slots in a fixed order, slot 0 first;
- top-k ranks the experts by comparisons: equal gates keep the lower
  expert index first, as ``jax.lax.top_k`` does.

``shard_hints`` is a no-op on one device and is not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, mlp, mlp_init


def moe_init(gen, d_model: int, moe_d_ff: int, n_experts: int,
             n_shared_experts: int, shared_d_ff: int, dtype):
    p = {
        "router": dense_init(gen, (d_model, n_experts), torch.float32),
        "w_gate": dense_init(gen, (n_experts, d_model, moe_d_ff), dtype),
        "w_up": dense_init(gen, (n_experts, d_model, moe_d_ff), dtype),
        "w_down": dense_init(gen, (n_experts, moe_d_ff, d_model), dtype),
    }
    if n_shared_experts > 0:
        p["shared"] = mlp_init(gen, d_model, shared_d_ff, dtype)
    return p


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``idx`` (...) -> (..., n) one-hot by comparison (no scatter, no host
    check, so it runs inside a CUDA graph capture and under ``vmap``)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def router_topk(logits, top_k: int):
    """Top-k routing with softmax-renormalized gates. logits: (..., E) fp32.

    Each expert's rank is the count of experts ahead of it (a larger gate,
    or an equal gate at a lower index: ``jax.lax.top_k``'s order), and the
    k best are read out by one-hot products over the ranks: elementwise
    work only, with no sort to launch or capture."""
    gates = torch.softmax(logits, dim=-1)
    n = gates.shape[-1]
    ar = torch.arange(n, device=gates.device)
    gi, gj = gates[..., :, None], gates[..., None, :]
    ahead = (gj > gi) | ((gj == gi) & (ar[None, :] < ar[:, None]))
    rank = ahead.sum(dim=-1)                                  # (..., E)
    pick = rank[..., None, :] == torch.arange(top_k, device=gates.device)[:, None]
    top_idx = (pick * ar).sum(dim=-1)                         # (..., k)
    top_vals = (pick.to(gates.dtype) * gates[..., None, :]).sum(dim=-1)
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True), min=1e-9)
    return top_vals, top_idx


def load_balance_loss(logits, top_idx, n_experts: int):
    """Switch-style auxiliary loss: E * sum_e f_e * p_e."""
    gates = torch.softmax(logits, dim=-1)
    p_e = gates.mean(dim=0)
    assign = _one_hot(top_idx, n_experts, torch.float32).sum(dim=1)
    f_e = assign.mean(dim=0) / max(top_idx.shape[-1], 1)
    return n_experts * torch.sum(f_e * p_e)


def moe_forward(params, x, *, n_experts: int, top_k: int,
                capacity_factor: float = 1.25, group_size: int = 4096):
    """x: (B, S, d). Returns (out, aux_loss).

    Tokens run in G groups of g, each expert taking at most C of a group's
    g * k routed slots (first come, first served; an overflowing slot is
    dropped, its output zero)."""
    B, S, d = x.shape
    N = B * S
    xf = x.reshape(N, d)
    g = min(group_size, N)
    pad = (-N) % g
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
    G = xf.shape[0] // g
    xg = xf.reshape(G, g, d)
    k = top_k
    cap = int(max(top_k, g * top_k * capacity_factor / n_experts))

    logits = xg.float() @ params["router"]                    # (G, g, E)
    gates, idx = router_topk(logits, top_k)                   # (G, g, k)

    flat_idx = idx.reshape(G, g * k)                          # (G, g*k)
    onehot = _one_hot(flat_idx, n_experts, torch.int32)       # (G, g*k, E)
    pos = torch.cumsum(onehot, dim=1) - 1                     # (G, g*k, E)
    pos_in_expert = (pos * onehot).sum(dim=-1)                # (G, g*k)
    keep = pos_in_expert < cap
    # each routed slot's place in the (E * C) buffer; a dropped slot's is
    # the pad place E * C, whose row is zero and whose result nobody reads
    place = torch.where(keep, flat_idx * cap + pos_in_expert, n_experts * cap)
    # buffer place -> the routed slot it holds (g * k, the zero pad row of
    # x_rep, for an empty place); only the pad place is written twice
    src = torch.scatter(
        torch.full((G, n_experts * cap + 1), g * k, dtype=torch.int64,
                   device=x.device), 1, place,
        torch.arange(g * k, device=x.device).expand(G, g * k))[:, :-1]

    x_rep = F.pad(xg[:, :, None, :].expand(G, g, k, d).reshape(G, g * k, d),
                  (0, 0, 0, 1))                               # (G, g*k+1, d)
    expert_in = torch.gather(x_rep, 1, src[..., None].expand(
        G, n_experts * cap, d)).reshape(G, n_experts, cap, d)  # (G,E,C,d)
    gate = F.silu(torch.einsum("gecd,edf->gecf", expert_in, params["w_gate"]))
    up = torch.einsum("gecd,edf->gecf", expert_in, params["w_up"])
    expert_out = torch.einsum("gecf,efd->gecd", gate * up, params["w_down"])

    out_pad = F.pad(expert_out.reshape(G, n_experts * cap, d), (0, 0, 0, 1))
    out_tok = torch.gather(out_pad, 1, place[..., None].expand(G, g * k, d))
    out_tok = out_tok * (keep[..., None] * gates.reshape(G, g * k, 1)
                         ).to(expert_out.dtype)
    slots = out_tok.reshape(G, g, k, d)
    out = slots[:, :, 0]
    for j in range(1, k):
        out = out + slots[:, :, j]
    out = out.reshape(-1, d)[:N].reshape(B, S, d)

    aux = load_balance_loss(logits.reshape(-1, n_experts),
                            idx.reshape(-1, k), n_experts)
    if "shared" in params:
        out = out + mlp(params["shared"], x)
    return out, aux
