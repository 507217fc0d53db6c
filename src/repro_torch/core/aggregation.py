"""Flat-row SAA aggregation (paper Alg. 2) and the server optimizers, the
slice of ``repro.core.aggregation`` the round pipeline and the per-stage
flat path run.

A model's parameters travel as one flat fp32 row in ``FlatSpec`` leaf order
(dict keys sorted, lists by index: the order ``jax.tree.flatten`` gives the
reference), so the stale cache, aggregation and server step never see the
model's structure.  ``aggregate_updates`` / ``weights_and_aggregate_by_id`` are the
``use_agg_kernel=False`` server path; with the flag on, the pipeline and
``stale_synchronous_aggregate_flat`` call the CUDA kernels in
``repro_torch.kernels.staleness_agg`` instead.  The YoGi server also comes
on parameter trees (``yogi_init`` / ``yogi_apply``, the pod train step's),
with the flat version's elementwise formulas leaf by leaf.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.staleness import EPS, RULE_ID, staleness_weights_by_id
from repro_torch.models.transformer import tree_map


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Leaf names, shapes and start offsets (plus a total-D sentinel) of a
    flattened parameter tree: ``flat[..., offsets[i]:offsets[i+1]]`` is leaf
    ``names[i]``.  Names are key paths joined by ``.`` (a flat dict's are
    its keys) and ``tree`` is the nesting (``_skeleton``) from which
    ``unflatten_update`` rebuilds the tree.  Hashable, computed once per
    model."""
    names: tuple
    shapes: tuple
    offsets: tuple
    tree: tuple


def _leaves(tree, path=()):
    """(key path, leaf) of a tree of dicts and lists in ``jax.tree.flatten``'s
    order: dict keys sorted, lists by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists in ``jax.tree.leaves``'
    order (dict keys sorted, lists by index)."""
    return [leaf for _, leaf in _leaves(tree)]


def _skeleton(tree, count):
    """The hashable nesting of ``tree``: ("d", ((key, sub), ...)) for a
    dict (keys sorted), ("l", (sub, ...)) for a list, a leaf's index in
    ``_leaves`` order for a leaf (``count`` is a one-element counter)."""
    if isinstance(tree, dict):
        return ("d", tuple((k, _skeleton(tree[k], count)) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return ("l", tuple(_skeleton(v, count) for v in tree))
    count[0] += 1
    return count[0] - 1


def _rebuild(skel, leaves):
    if isinstance(skel, int):
        return leaves[skel]
    kind, subs = skel
    if kind == "d":
        return {k: _rebuild(sub, leaves) for k, sub in subs}
    return [_rebuild(sub, leaves) for sub in subs]


def make_flat_spec(params) -> FlatSpec:
    leaves = list(_leaves(params))
    names = tuple(".".join(map(str, path)) for path, _ in leaves)
    shapes = tuple(tuple(leaf.shape) for _, leaf in leaves)
    offs, off = [], 0
    for s in shapes:
        offs.append(off)
        off += int(np.prod(s)) if s else 1
    return FlatSpec(names, shapes, tuple(offs) + (off,),
                    _skeleton(params, [0]))


def flat_dim(spec: FlatSpec) -> int:
    """Total flat vector length D."""
    return int(spec.offsets[-1])


def flatten_update(params) -> tuple:
    """Parameter tree -> (flat fp32 vector, its ``FlatSpec``): the leaves in
    ``jax.tree.flatten``'s order, so the vector equals the reference's
    element for element."""
    spec = make_flat_spec(params)
    flat = torch.cat([torch.as_tensor(leaf).reshape(-1).to(torch.float32)
                      for _, leaf in _leaves(params)])
    return flat, spec


def unflatten_update(flat: torch.Tensor, spec: FlatSpec):
    """Flat (..., D') rows -> the parameter tree of (..., *shape) views.
    Leading axes ride along (a batch of per-learner rows unflattens to
    batched leaves); a row wider than D is block-padded and its tail is
    ignored."""
    lead = tuple(flat.shape[:-1])
    leaves = [flat[..., lo:hi].reshape(lead + shp)
              for shp, lo, hi in zip(spec.shapes, spec.offsets[:-1],
                                     spec.offsets[1:])]
    return _rebuild(spec.tree, leaves)


def aggregate_updates(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """stacked: (n, D), weights: (n,) normalized -> (D,)."""
    return weights @ stacked


def no_stale_aggregate(stacked, fresh, valid) -> torch.Tensor:
    """Eq. 2 of a round with no stale rows: the mean of the fresh valid
    rows (each weighs 1, the same weight bits as the general path)."""
    w = (fresh & valid).to(torch.float32)
    return aggregate_updates(stacked, w / torch.clamp(w.sum(), min=EPS))


def weights_and_aggregate_by_id(stacked, fresh, tau, valid, beta, rule_id):
    """Eq. 2 weights and the weighted aggregate of one round's rows."""
    w = staleness_weights_by_id(stacked, fresh, tau, rule_id, beta=beta,
                                valid=valid)
    return aggregate_updates(stacked, w), w


def bucket_pow2(n: int) -> int:
    """Next power of two (the reference's participant padding bucket)."""
    return 1 << (n - 1).bit_length()


def bucket_block(n: int, block: int) -> int:
    """Power-of-two up to ``block``, then multiples of ``block`` (the
    reference's two-tier padding bucket): the port's training rows, and
    the fused pipeline's groups and operand rows under the SAA kernels.
    Padding never changes a result."""
    if n <= block:
        return bucket_pow2(n)
    return block * ((n + block - 1) // block)


def pad_cols(t, block: int) -> torch.Tensor:
    """``t`` as a new fp32 tensor with zero columns up to the next multiple
    of ``block`` on its last axis (no padding when ``block`` is 0)."""
    t = torch.as_tensor(t)
    d = t.shape[-1]
    out = t.new_zeros(t.shape[:-1] + (d + (-d) % block if block else d,),
                      dtype=torch.float32)
    out[..., :d] = t
    return out


def bucket_pad(updates, fresh, tau, *, lane_block: int = 0):
    """Pad a round's updates for the kernels, on the updates' device.

    Pads the feature axis up to the next multiple of ``lane_block`` (when
    > 0).  The participant axis keeps its exact count: the port runs
    eagerly on exact shapes, so it has no compiled programs to bound by
    bucketing rows.  Returns (updates (n, Dp) fp32, fresh (n,) bool, tau
    (n,) int32, valid (n,) bool, all true).
    """
    u = pad_cols(updates, lane_block)
    dev = u.device
    fr = torch.as_tensor(fresh, dtype=torch.bool, device=dev)
    ta = torch.as_tensor(tau, dtype=torch.int32, device=dev)
    return u, fr, ta, torch.ones_like(fr)


def stale_synchronous_aggregate_flat(stacked, fresh, tau, *,
                                     rule: str = "relay", beta: float = 0.35,
                                     use_kernel: bool = False):
    """Aggregate already-stacked flat updates: the per-stage engine's server
    path.  stacked: (n, D) fp32 rows (fresh first, then landing stale);
    fresh: (n,) bool; tau: (n,) int32.  Returns (aggregate (D,), weights
    (n,)).  With ``use_kernel`` it goes through ``fused_staleness_aggregate``
    (D padded to the block, exact n), else through the torch path the fused
    pipeline runs without the kernel."""
    if use_kernel:
        from repro_torch.kernels.staleness_agg import ops as agg_ops
        return agg_ops.staleness_aggregate(stacked, fresh, tau, rule=rule,
                                           beta=beta)
    return weights_and_aggregate_by_id(stacked, fresh, tau,
                                       torch.ones_like(fresh), beta,
                                       RULE_ID[rule])


def stale_synchronous_aggregate(update_trees, fresh, tau, *,
                                rule: str = "relay", beta: float = 0.35,
                                use_kernel: bool = False):
    """Aggregate a round's fresh + stale update trees (the legacy engine's
    pytrees) into one delta tree: each tree flattened in ``FlatSpec`` leaf
    order, the rows stacked on their device and handed to
    ``stale_synchronous_aggregate_flat`` on their exact count (kernel 3
    under ``use_kernel``).  Returns (aggregate tree of views into the
    (D,) aggregate, weights (n,))."""
    if not update_trees:
        raise ValueError("no updates to aggregate")
    spec = make_flat_spec(update_trees[0])
    stacked = torch.stack([flatten_update(t)[0] for t in update_trees])
    dev = stacked.device
    agg, w = stale_synchronous_aggregate_flat(
        stacked, torch.as_tensor(np.asarray(fresh, bool), device=dev),
        torch.as_tensor(np.asarray(tau, np.int32), device=dev), rule=rule,
        beta=beta, use_kernel=use_kernel)
    return unflatten_update(agg, spec), w


def sweep_bucket_pad(cell_updates, d: int, *, device=None):
    """Pad a sweep round's per-cell update stacks to one (S, n, D) operand.

    cell_updates: length-S list; entry ``s`` is None (no updates this
    round: all-invalid rows, a zero aggregate) or ``(rows, fresh, tau)``
    with ``rows`` a list of (D,) fp32 device rows.  Each cell's rows come
    first, in order; the participant axis is padded with zero rows up to
    the round's largest cell (at least 1), not to the reference's
    ``bucket_block(n, 32)``: eager torch compiles no program per shape.
    Returns tensors on the rows' device (``device`` when no cell has rows):
    (U (S, n, d) fp32, fresh (S, n) bool, tau (S, n) int32, valid (S, n)
    bool, has (S,) bool).
    """
    s_total = len(cell_updates)
    sizes = [0 if c is None else len(c[0]) for c in cell_updates]
    n = max(sizes + [1])
    rows = [r for c in cell_updates if c is not None for r in c[0]]
    dev = rows[0].device if rows else torch.device(device or "cpu")
    meta = np.zeros((3, s_total, n), np.int32)     # fresh, tau, valid
    dst = []
    for i, c in enumerate(cell_updates):
        if c is None:
            continue
        k = sizes[i]
        meta[0, i, :k], meta[1, i, :k], meta[2, i, :k] = c[1], c[2], 1
        dst.extend(range(i * n, i * n + k))
    meta_t = torch.as_tensor(meta, device=dev)
    u = torch.zeros((s_total * n, d), dtype=torch.float32, device=dev)
    if rows:
        u[torch.as_tensor(dst, device=dev)] = torch.stack(rows)
    valid = meta_t[2].bool()
    return (u.view(s_total, n, d), meta_t[0].bool(), meta_t[1], valid,
            torch.as_tensor(np.asarray(sizes) > 0, device=dev))


def sweep_aggregate_flat(stacked, fresh, tau, valid, beta, *, rule="relay",
                         use_kernel: bool = False, sizes=None):
    """SAA-aggregate S cells' rounds.

    stacked: (S, n, D) fp32 with each cell's valid rows first (as
    ``sweep_bucket_pad`` lays them out); fresh / tau / valid: (S, n);
    ``beta``: the cells' Eq. 2 weights, a sequence of Python floats (or an
    (S,) tensor); ``rule``: one rule name or one a cell.  Returns
    (aggregate (S, D), weights (S, n)); a cell with no valid row gets a
    zero row and zero weights.  ``sizes`` (each cell's row count) lets
    ``valid`` hold holes inside a cell's rows, as the guard's survivor
    mask does; without it a cell's valid rows are its rows.

    ``use_kernel`` runs every cell in one launch of
    ``sweep_fused_staleness_aggregate`` (kernel 2), which takes one rule,
    so mixed rules raise, as in the reference.  The plain route runs each
    cell's valid rows through ``weights_and_aggregate_by_id``, the function
    a serial run calls on the same rows with the same Python ``beta``: the
    batch's padding and its other cells cannot move a cell's bits (torch's
    reductions pick their blocking by shape).
    """
    s = stacked.shape[0]
    rules = [rule] * s if isinstance(rule, str) else list(rule)
    if use_kernel:
        if len(set(rules)) != 1:
            raise ValueError("the sweep kernel takes one scaling rule; got "
                             f"mixed rules {sorted(set(rules))}")
        from repro_torch.kernels.staleness_agg import ops as agg_ops
        beta_t = torch.as_tensor(np.asarray(
            beta.cpu() if torch.is_tensor(beta) else beta, np.float32))
        return agg_ops.sweep_staleness_aggregate(stacked, fresh, tau,
                                                 valid=valid, rule=rules[0],
                                                 beta=beta_t)
    agg = stacked.new_zeros((s, stacked.shape[2]))
    w = stacked.new_zeros(stacked.shape[:2])
    if sizes is None:
        sizes = valid.sum(dim=1).tolist()
    for i, k in enumerate(sizes):
        if k:
            agg[i], w[i, :k] = weights_and_aggregate_by_id(
                stacked[i, :k], fresh[i, :k], tau[i, :k], valid[i, :k],
                float(beta[i]), RULE_ID[rules[i]])
    return agg, w


def screen_rows(u, valid, *, clip=None, reject_mult=None, norm_d=None):
    """Screening of an update operand ``u`` (..., n, D); the reference's
    formula, which the guard and ``norm_median_clip`` run.  Three screens,
    in order:

      1. non-finite reject: any NaN/Inf element invalidates the row;
      2. norm-outlier reject (``reject_mult``): rows whose squared L2 norm
         exceeds ``reject_mult**2`` times the median surviving squared
         norm (median index ``(count - 1) // 2``);
      3. norm clip (``clip``): surviving rows are rescaled to L2 norm
         ``clip`` when they exceed it.

    Rejected rows are zeroed, not only masked, so no NaN reaches a later
    weighted sum.  With every row finite and no norm rule hit, the output
    is an exact select of ``u``: a guard that rejects nothing moves no
    bit.  ``norm_d`` (the kernels' block-padded rows): the finite test and
    the squared norms read the leading ``norm_d`` columns only, the true
    row; the clip and the zeroing apply to the whole row.  valid: (..., n)
    bool.  Returns ``(u_screened, valid_out, n_nonfinite,
    n_norm_rejected, n_clipped)``, the counts int32 summed over the row
    axis.
    """
    u = torch.as_tensor(u, dtype=torch.float32)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=u.device)
    u_t = u if norm_d is None else u[..., :norm_d]
    finite = torch.isfinite(u_t).all(dim=-1)
    v1 = valid & finite
    n_nf = (valid & ~finite).sum(dim=-1, dtype=torch.int32)
    # rejected rows get +inf norms: they sort last and never reach the
    # median index, which counts only surviving rows
    n2 = torch.where(v1, (u_t * u_t).sum(dim=-1), torch.inf)
    if reject_mult is not None:
        srt = torch.sort(n2, dim=-1).values
        idx = torch.clamp(v1.sum(dim=-1) - 1, min=0) // 2
        med = torch.gather(srt, -1, idx[..., None])[..., 0]
        mult2 = float(np.float32(reject_mult) ** 2)      # rounded as fp32
        out = v1 & (n2 > mult2 * med[..., None])
        v2 = v1 & ~out
        n_out = out.sum(dim=-1, dtype=torch.int32)
    else:
        v2 = v1
        n_out = torch.zeros_like(n_nf)
    if clip is not None:
        clip32 = float(np.float32(clip))
        hit = v2 & (n2 > float(np.float32(clip) * np.float32(clip)))
        scale = torch.where(hit, clip32 / torch.sqrt(n2), 1.0)
        u = u * scale[..., None]
        n_clip = hit.sum(dim=-1, dtype=torch.int32)
    else:
        n_clip = torch.zeros_like(n_nf)
    u = torch.where(v2[..., None], u, 0.0)
    return u, v2, n_nf, n_out, n_clip


def guarded_aggregate_flat(stacked, fresh, tau, *, rule: str = "relay",
                           beta: float = 0.35, use_kernel: bool = False,
                           clip=None, reject_mult=None, quorum: int = 1):
    """Screened, quorum-checked ``stale_synchronous_aggregate_flat``: the
    per-stage engine's guarded server path.

    Returns ``(aggregate (D,), weights (n,), info)``; ``info`` holds the
    rejected-row counts (``nonfinite``, ``norm``), ``clipped``,
    ``survivors`` and ``applied``, False when the survivors fall below
    ``quorum`` (the caller then keeps its params).  The screened rows and
    the survivor mask go to ``fused_staleness_aggregate`` (kernel 3) under
    ``use_kernel``, else to the plain masked weights.  The kernel takes
    ``fresh`` as given, so it gets ``fresh & survivors``: a rejected fresh
    row then leaves ``n_f`` as the plain masked weights (the reference's
    screened route) leave it.  A round the screen leaves clean hands either
    the unguarded call's exact operands (the screen is an exact select, the
    mask all true), so a guard that screens nothing moves no bit on any
    route.
    """
    u, fr, ta, valid = bucket_pad(stacked, fresh, tau)
    u2, v2, n_nf, n_out, n_clip = screen_rows(u, valid, clip=clip,
                                              reject_mult=reject_mult)
    n_nf, n_out, n_clip, survivors = torch.stack(
        [n_nf, n_out, n_clip, v2.sum(dtype=torch.int32)]).tolist()
    info = {"nonfinite": n_nf, "norm": n_out, "clipped": n_clip,
            "survivors": survivors,
            "applied": survivors >= max(int(quorum), 1)}
    if use_kernel:
        from repro_torch.kernels.staleness_agg import ops as agg_ops
        agg, w = agg_ops.fused_staleness_aggregate(
            pad_cols(u2, agg_ops.D_BLK), fr & v2, ta, beta, rule=rule,
            valid=v2)
        return agg[:u.shape[1]], w, info
    agg, w = weights_and_aggregate_by_id(u2, fr, ta, v2, beta, RULE_ID[rule])
    return agg, w, info


# ---------------------------------------------------------------------------
# Server optimizers on the flat row (they apply the aggregated delta)
# ---------------------------------------------------------------------------


def fedavg_apply(flat, delta, server_lr: float = 1.0):
    """x_{t+1} = x_t + lr * Delta  (McMahan et al., 2017)."""
    return flat + server_lr * delta


def yogi_init(params) -> dict:
    """YoGi state over a parameter tree: m = 0 and v = 1e-6 in fp32 leaf by
    leaf, t = 0 (a 0-d int32 tensor), on the params' device."""
    leaf = tree_leaves(params)[0]
    return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "v": tree_map(lambda p: torch.full(p.shape, 1e-6, dtype=torch.float32,
                                               device=p.device), params),
            "t": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def yogi_apply(params, delta, state: dict, *, lr=1e-2, b1=0.9, b2=0.99, eps=1e-3):
    """Federated YoGi (Reddi et al. / Ramaswamy et al., 2020) on trees, the
    reference's elementwise formulas leaf by leaf (those of
    ``yogi_apply_flat``, so the bits equal it on the flattened tree):

        v <- v - (1-b2) * d^2 * sign(v - d^2)   (YoGi's additive variant of Adam)

    The update is computed in fp32 and cast back to each parameter's dtype.
    Returns (new params, new state); nothing is updated in place."""
    m = tree_map(lambda m_, d: b1 * m_ + (1 - b1) * d.float(), state["m"], delta)
    v = tree_map(lambda v_, d: v_ - (1 - b2) * torch.square(d.float())
                 * torch.sign(v_ - torch.square(d.float())), state["v"], delta)
    new = tree_map(lambda p, m_, v_: (p.float() + lr * m_ / (torch.sqrt(v_) + eps)
                                      ).to(p.dtype), params, m, v)
    return new, {"m": m, "v": v, "t": state["t"] + 1}


def yogi_init_flat(d: int, *, device=None, width: int | None = None) -> dict:
    """YoGi state over a flat (D,) row: m = 0, v = 1e-6, t = 0.  A ``width``
    past D (the kernel's block-padded layout) adds columns that are zero in
    m and v, which a YoGi step keeps exactly zero."""
    width = d if width is None else int(width)
    v = torch.zeros(width, dtype=torch.float32, device=device)
    v[:d] = 1e-6
    return {"m": torch.zeros(width, dtype=torch.float32, device=device),
            "v": v, "t": torch.zeros((), dtype=torch.int32, device=device)}


def yogi_apply_flat(flat, delta, state: dict, *, lr=1e-2, b1=0.9, b2=0.99,
                    eps=1e-3):
    """Federated YoGi (Reddi et al., 2020) on flat fp32 rows, the
    reference's elementwise formulas in its order:

        v <- v - (1-b2) * d^2 * sign(v - d^2)

    Returns (new row, new state); nothing is updated in place."""
    m = b1 * state["m"] + (1 - b1) * delta
    d2 = torch.square(delta)
    v = state["v"] - (1 - b2) * d2 * torch.sign(state["v"] - d2)
    new = flat + lr * m / (torch.sqrt(v) + eps)
    return new, {"m": m, "v": v, "t": state["t"] + 1}
