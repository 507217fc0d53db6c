"""Attention variants (``repro.models.attention``): GQA (covers MHA) with
an optional sliding window, and MLA (DeepSeek-V2) with its compressed
KV cache.

Full-sequence attention (prefill) is the memory-bounded double-blocked
online softmax of the reference (``blocked_attention``), which is also the
plain version of the sliding-window kernel in
``repro_torch.kernels.swa_attention``.  ``gqa_forward`` routes to that
kernel exactly where the reference routes to its Pallas kernel; MLA never
does, in either package: its q/k head dim (nope + rope) differs from v's,
and it runs ``blocked_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.models import shard_hints
from repro_torch.models.layers import apply_rope, contiguous_grad, dense_init

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Blocked online-softmax attention core
# ---------------------------------------------------------------------------


def _on_local_shards(fn, q, k, v, q_positions, kv_positions, **kw):
    """``fn`` (``blocked_attention`` or ``decode_attention``) of DTensors q,
    k, v split only on the batch (dim 0) and the kv heads (dim 2), k and v
    placed as q first, on each chip's local shards (positions cut to its
    batch rows), the result placed as q: attention is independent across
    batch rows and heads, and the same local ops run in the same order.
    Stated rather than left to DTensor's propagation, which refuses some
    torch versions' flattening of two split dims inside the einsums.  None
    for anything else (a cache split over its slots among them); at once
    for a plain q."""
    if type(q) is torch.Tensor:
        return None
    from torch.distributed.tensor import DTensor, Replicate, Shard
    split_ok = lambda t: isinstance(t, DTensor) and all(
        p.is_replicate() or p in (Shard(0), Shard(2)) for p in t.placements)
    if not all(split_ok(t) for t in (q, k, v)):
        return None
    pl, mesh = tuple(q.placements), q.device_mesh
    # k, v placed as q (a cache whole over its heads is cut to q's heads)
    k, v = (t if tuple(t.placements) == pl else t.redistribute(mesh, pl)
            for t in (k, v))
    rows = [Shard(0) if p == Shard(0) else Replicate() for p in pl]

    def batch_rows(pos):
        if not isinstance(pos, DTensor):
            pos = DTensor.from_local(pos, mesh, [Replicate()] * mesh.ndim,
                                     run_check=False)
        return pos.redistribute(mesh, rows).to_local()
    # the local backward's gradients may come back permuted: contiguous
    # before they re-enter a split DTensor (``layers.contiguous_grad``)
    ql, kl, vl = (t.to_local() for t in (q, k, v))
    if any(p.is_shard() for p in pl):
        ql, kl, vl = map(contiguous_grad, (ql, kl, vl))
    out = fn(ql, kl, vl, batch_rows(q_positions), batch_rows(kv_positions), **kw)
    return DTensor.from_local(out, mesh, pl, run_check=False)


def blocked_attention(q, k, v, q_positions, kv_positions, *, window=None,
                      q_chunk: int = 1024, kv_chunk: int = 1024, softmax_scale=None):
    """Causal (optionally sliding-window) attention.

    q: (B, Sq, Hkv, G, Dk)   grouped query heads
    k: (B, Sk, Hkv, Dk); v: (B, Sk, Hkv, Dv)
    q_positions: (B, Sq) absolute positions of queries
    kv_positions: (B, Sk) absolute positions of keys; negative = invalid slot
    Returns (B, Sq, Hkv, G, Dv) in v's dtype.

    Placed (DTensors split over batch and kv heads alike, nothing else),
    each chip runs it on its own shards (``_on_local_shards``).
    """
    local = _on_local_shards(blocked_attention, q, k, v, q_positions, kv_positions,
                             window=window, q_chunk=q_chunk, kv_chunk=kv_chunk,
                             softmax_scale=softmax_scale)
    if local is not None:
        return local
    B, Sq, Hkv, G, Dh = q.shape
    Dv = v.shape[-1]
    Sk = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5

    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    # Pad to multiples of the chunk sizes; padded kv slots get position -1.
    pad_q = (-Sq) % q_chunk
    pad_k = (-Sk) % kv_chunk
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, pad_q))
        q_positions = torch.nn.functional.pad(q_positions, (0, pad_q))
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pad_k), value=-1)
    nq, nk = q.shape[1] // q_chunk, k.shape[1] // kv_chunk

    outs = []
    for qi in range(nq):
        qs = slice(qi * q_chunk, (qi + 1) * q_chunk)
        qb = q[:, qs].float()                         # (B, Cq, Hkv, G, Dh)
        qp = q_positions[:, qs]                       # (B, Cq)
        m = torch.full((B, Hkv, G, q_chunk), NEG_INF, device=q.device)
        l = torch.zeros((B, Hkv, G, q_chunk), device=q.device)
        o = torch.zeros((B, Hkv, G, q_chunk, Dv), device=q.device)
        for ki in range(nk):
            ks = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            kb, vb, kp = k[:, ks], v[:, ks], kv_positions[:, ks]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb.float()) * scale
            mask = qp[:, None, None, :, None] >= kp[:, None, None, None, :]
            mask &= kp[:, None, None, None, :] >= 0
            if window is not None:
                mask &= (qp[:, None, None, :, None] - kp[:, None, None, None, :]) < window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vb.float())
            m = m_new
        out = o / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))       # (B, Cq, Hkv, G, Dv)
    out = torch.cat(outs, dim=1)
    return out[:, :Sq].to(v.dtype)


def decode_attention(q, k_cache, v_cache, q_position, kv_positions, *, window=None,
                     softmax_scale=None):
    """One-token attention against a (possibly ring-buffered) cache.

    q: (B, 1, Hkv, G, Dh); caches (B, Sc, Hkv, Dh); kv_positions (B, Sc) with -1
    marking unwritten slots; q_position (B,).  Placed as ``blocked_attention``
    is (``_on_local_shards``) when the caches are not split over their slots.
    """
    local = _on_local_shards(decode_attention, q, k_cache, v_cache, q_position,
                             kv_positions, window=window, softmax_scale=softmax_scale)
    if local is not None:
        return local
    Dh = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k_cache.float()) * scale
    kvp = kv_positions[:, None, None, None, :]
    qp = q_position[:, None, None, None, None]
    mask = (kvp >= 0) & (kvp <= qp)
    if window is not None:
        mask &= (qp - kvp) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v_cache.float())
    return out.to(v_cache.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer (covers MHA when n_kv_heads == n_heads)
# ---------------------------------------------------------------------------


def _reshape_heads(t, shape, groups, dim=2, dim_out=None):
    """``t.reshape(shape)``, where ``t`` holds ``groups`` groups of heads at
    dim ``dim`` and the result at ``dim_out`` (``dim`` unless given).
    Placed, both sides are pinned (``shard_hints.pin_heads``): the input
    before the view, and the result after it, so that the view's backward
    meets a pinned gradient too.  A plain tensor is only reshaped."""
    if type(t) is torch.Tensor:
        return t.reshape(shape)
    t = shard_hints.pin_heads(t, groups, dim)
    return shard_hints.pin_heads(t.reshape(shape), groups,
                                 dim if dim_out is None else dim_out)


def _project_out(out, w):
    """``out`` (B, S, H * Dv) @ ``w`` as one (B * S, H * Dv) product: the
    fold a plain tensor's matmul makes of it.  A placed (DTensor) matmul
    judges the fold on its global strides and may batch the product
    instead, which sums in another order."""
    if type(out) is torch.Tensor:
        return out @ w
    B, S, width = out.shape
    return (out.reshape(B * S, width) @ w).reshape(B, S, w.shape[-1])


def _write_slots(cache, slot, new: dict) -> dict:
    """The entries of ``cache`` named in ``new``, each (B, Sc, ...) with
    ``new[n]`` (B, ...) in slot ``slot[b]`` of each row, out of place (the
    given caches are left as they were): indexed writes into copies, one
    row index for all.  Placed (DTensor) caches take a select over the
    whole cache instead, the same values: elementwise, so each keeps its
    layout, split over its batch and its slots, where an indexed write
    would gather the split dims (``shard_hints.placed_as`` pins what
    DTensor's propagation returns).  Plain tensors keep the indexed write:
    the select's extra launches slow a host-bound decode step."""
    first = cache[next(iter(new))]
    indexed = type(first) is torch.Tensor
    if not indexed:
        from torch.distributed.tensor import DTensor
        indexed = not isinstance(first, DTensor)
    if indexed:
        rows = torch.arange(first.shape[0], device=first.device)
        return {n: cache[n].index_put((rows, slot), v.to(cache[n].dtype))
                for n, v in new.items()}
    hit = slot[:, None] == torch.arange(first.shape[1], device=slot.device)
    out = {}
    for n, v in new.items():
        c = cache[n]
        at = hit.reshape(hit.shape + (1,) * (c.dim() - 2))
        out[n] = shard_hints.placed_as(torch.where(at, v[:, None].to(c.dtype), c), c)
    return out


def gqa_init(gen, d_model, n_heads, n_kv_heads, d_head, qkv_bias, dtype):
    p = {
        "w_q": dense_init(gen, (d_model, n_heads * d_head), dtype),
        "w_k": dense_init(gen, (d_model, n_kv_heads * d_head), dtype),
        "w_v": dense_init(gen, (d_model, n_kv_heads * d_head), dtype),
        "w_o": dense_init(gen, (n_heads * d_head, d_model), dtype),
    }
    if qkv_bias:
        for name, width in (("b_q", n_heads), ("b_k", n_kv_heads), ("b_v", n_kv_heads)):
            p[name] = torch.zeros((width * d_head,), dtype=dtype, device=gen.device)
    return p


def gqa_project_qkv(params, x, n_heads, n_kv_heads, d_head, positions, rope_theta):
    """Placed (a pod layout configured), each head reshape here and in the
    attention functions below is pinned (``_reshape_heads``): a chip holds
    whole kv groups, its share of the heads where the groups divide over
    the model axis, all of them otherwise (an all-gather of the product,
    and the attention of every head on each of the axis' chips)."""
    B, S, _ = x.shape
    q = x @ params["w_q"]
    k = x @ params["w_k"]
    v = x @ params["w_v"]
    if "b_q" in params:
        q = q + params["b_q"]
        k = k + params["b_k"]
        v = v + params["b_v"]
    q = _reshape_heads(q, (B, S, n_heads, d_head), n_kv_heads)
    k = _reshape_heads(k, (B, S, n_kv_heads, d_head), n_kv_heads)
    v = _reshape_heads(v, (B, S, n_kv_heads, d_head), n_kv_heads)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    return q, k, v


def gqa_forward(params, x, positions, *, n_heads, n_kv_heads, d_head,
                rope_theta, window=None, use_kernel=False):
    """Full-sequence GQA (prefill). Returns (out, (k, v)).

    ``use_kernel`` routes sliding-window attention through the CUDA
    sliding-window kernel where the window is a multiple of its 128 tile
    (positions are the contiguous prefill layout), as the reference routes
    to its Pallas kernel; otherwise ``blocked_attention`` runs.
    """
    B, S, _ = x.shape
    G = n_heads // n_kv_heads
    q, k, v = gqa_project_qkv(params, x, n_heads, n_kv_heads, d_head, positions, rope_theta)
    if use_kernel and window is not None and window % 128 == 0:
        from repro_torch.kernels.swa_attention import ops as swa_ops
        out = swa_ops.swa_attention(q, k, v, window=window)
    else:
        qg = _reshape_heads(q, (B, S, n_kv_heads, G, d_head), n_kv_heads)
        out = blocked_attention(qg, k, v, positions, positions, window=window)
    out = _reshape_heads(out, (B, S, n_heads * d_head), n_kv_heads)
    return _project_out(out, params["w_o"]), (k, v)


def gqa_decode(params, x, position, cache, *, n_heads, n_kv_heads, d_head,
               rope_theta, window=None):
    """Single-token GQA against a cache dict {"k","v","pos"} (ring buffer).

    cache["k"/"v"]: (B, Sc, Hkv, Dh); cache["pos"]: (B, Sc) absolute positions,
    -1 for never-written slots.  ``position``: (B,) current absolute position.
    Returns (out, new cache); the given cache is left as it was.
    """
    B = x.shape[0]
    G = n_heads // n_kv_heads
    q, k, v = gqa_project_qkv(params, x, n_heads, n_kv_heads, d_head,
                              position[:, None], rope_theta)
    Sc = cache["k"].shape[1]
    slot = (position % Sc).long()       # ring buffer (full cache: slot == pos)
    written = _write_slots(cache, slot, {"k": k[:, 0], "v": v[:, 0], "pos": position})
    k_cache, v_cache, kv_pos = written["k"], written["v"], written["pos"]
    qg = _reshape_heads(q, (B, 1, n_kv_heads, G, d_head), n_kv_heads)
    out = decode_attention(qg, k_cache, v_cache, position, kv_pos, window=window)
    out = _reshape_heads(out, (B, 1, n_heads * d_head), n_kv_heads)
    return _project_out(out, params["w_o"]), written


# ---------------------------------------------------------------------------
# MLA — Multi-head Latent Attention (DeepSeek-V2), compressed KV cache
# ---------------------------------------------------------------------------


def mla_init(gen, d_model, n_heads, *, kv_lora_rank, qk_nope_dim, qk_rope_dim,
             v_head_dim, dtype):
    return {
        "w_q": dense_init(gen, (d_model, n_heads * (qk_nope_dim + qk_rope_dim)), dtype),
        "w_dkv": dense_init(gen, (d_model, kv_lora_rank), dtype),
        "w_kr": dense_init(gen, (d_model, qk_rope_dim), dtype),
        "w_uk": dense_init(gen, (kv_lora_rank, n_heads * qk_nope_dim), dtype),
        "w_uv": dense_init(gen, (kv_lora_rank, n_heads * v_head_dim), dtype),
        "w_o": dense_init(gen, (n_heads * v_head_dim, d_model), dtype),
    }


def _mla_qkr(params, x, positions, n_heads, qk_nope_dim, qk_rope_dim, rope_theta):
    """-> q_nope (B, S, H, dn), q_rope (B, S, H, dr), the latent c_kv
    (B, S, r) and the one rotary key head k_rope (B, S, dr)."""
    B, S, _ = x.shape
    q = _reshape_heads(x @ params["w_q"], (B, S, n_heads, qk_nope_dim + qk_rope_dim),
                       n_heads)
    q_nope, q_rope = q[..., :qk_nope_dim], q[..., qk_nope_dim:]
    q_rope = apply_rope(q_rope, positions, rope_theta)
    c_kv = x @ params["w_dkv"]
    k_rope = apply_rope((x @ params["w_kr"])[:, :, None, :], positions, rope_theta)
    return q_nope, q_rope, c_kv, k_rope[:, :, 0, :]


def _mla_expand_kv(params, c_kv, n_heads, qk_nope_dim, v_head_dim):
    B, S, _ = c_kv.shape
    k_nope = _reshape_heads(c_kv @ params["w_uk"], (B, S, n_heads, qk_nope_dim), n_heads)
    v = _reshape_heads(c_kv @ params["w_uv"], (B, S, n_heads, v_head_dim), n_heads)
    return k_nope, v


def _mla_keys(k_nope, k_rope):
    """Full-width keys: the one rotary head broadcast across the heads."""
    B, S, H, _ = k_nope.shape
    return torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, k_rope.shape[-1])],
                     dim=-1)


def mla_forward(params, x, positions, *, n_heads, kv_lora_rank, qk_nope_dim,
                qk_rope_dim, v_head_dim, rope_theta, window=None):
    """Full-sequence MLA (prefill): MHA over the expanded latent kv, q/k of
    dn + dr dims against v of ``v_head_dim``, through ``blocked_attention``.
    Returns (out, (c_kv, k_rope)), the compressed cache."""
    B, S, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = _mla_qkr(
        params, x, positions, n_heads, qk_nope_dim, qk_rope_dim, rope_theta)
    k_nope, v = _mla_expand_kv(params, c_kv, n_heads, qk_nope_dim, v_head_dim)
    q_full = torch.cat([q_nope, q_rope], dim=-1)[:, :, :, None, :]   # G = 1 a head
    scale = (qk_nope_dim + qk_rope_dim) ** -0.5
    out = blocked_attention(q_full, _mla_keys(k_nope, k_rope), v, positions, positions,
                            window=window, softmax_scale=scale)
    out = _reshape_heads(out, (B, S, n_heads * v_head_dim), n_heads)
    return _project_out(out, params["w_o"]), (c_kv, k_rope)


def mla_decode(params, x, position, cache, *, n_heads, kv_lora_rank, qk_nope_dim,
               qk_rope_dim, v_head_dim, rope_theta, window=None, absorbed=False):
    """Decode with the compressed cache {"c_kv": (B,Sc,r), "k_rope": (B,Sc,dr), "pos"},
    a ring buffer written at slot ``position % Sc``.

    ``absorbed=False`` (paper-exact naive path) re-expands k/v for the whole
    cache.  ``absorbed=True`` folds w_uk into the query and w_uv into the
    output, so the attention runs in the latent space, in fp32, cast to
    ``x``'s dtype after w_uv.  Returns (out, new cache); the given cache is
    left as it was."""
    B = x.shape[0]
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkr(
        params, x, position[:, None], n_heads, qk_nope_dim, qk_rope_dim, rope_theta)
    Sc = cache["c_kv"].shape[1]
    slot = (position % Sc).long()
    written = _write_slots(cache, slot, {"c_kv": c_kv_new[:, 0],
                                         "k_rope": k_rope_new[:, 0], "pos": position})
    c_kv, k_rope, kv_pos = written["c_kv"], written["k_rope"], written["pos"]
    scale = (qk_nope_dim + qk_rope_dim) ** -0.5

    if absorbed:
        # q_lat[b,h,r] = sum_d q_nope[b,h,d] * w_uk[r, h*dn+d]
        w_uk = _reshape_heads(params["w_uk"], (kv_lora_rank, n_heads, qk_nope_dim),
                              n_heads, 1).float()
        q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), w_uk)
        s = torch.einsum("bhr,bkr->bhk", q_lat, c_kv.float())
        s = s + torch.einsum("bhd,bkd->bhk", q_rope[:, 0].float(), k_rope.float())
        s = s * scale
        pos, qp = kv_pos, position[:, None]
        mask = (pos >= 0) & (pos <= qp)
        if window is not None:
            mask &= (qp - pos) < window
        p = torch.softmax(torch.where(mask[:, None, :], s, NEG_INF), dim=-1)
        o_lat = torch.einsum("bhk,bkr->bhr", p, c_kv.float())
        w_uv = _reshape_heads(params["w_uv"], (kv_lora_rank, n_heads, v_head_dim),
                              n_heads, 1).float()
        out = torch.einsum("bhr,rhd->bhd", o_lat, w_uv)
        out = _reshape_heads(out, (B, 1, n_heads * v_head_dim), n_heads, 1,
                             2).to(x.dtype)
    else:
        k_nope, v = _mla_expand_kv(params, c_kv, n_heads, qk_nope_dim, v_head_dim)
        q_full = torch.cat([q_nope, q_rope], dim=-1)[:, :, :, None, :]
        out = decode_attention(q_full, _mla_keys(k_nope, k_rope), v, position, kv_pos,
                               window=window, softmax_scale=scale)
        out = _reshape_heads(out, (B, 1, n_heads * v_head_dim), n_heads)
    return _project_out(out, params["w_o"]), written
