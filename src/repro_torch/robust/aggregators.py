"""Robust aggregation strategies over the flat ``(n, D)`` update operand;
port of ``repro.robust.aggregators``.

Two strategy styles, both composed with SAA staleness weighting:

* **mask-style** (``krum``, ``multi_krum``, ``norm_median_clip``): the
  strategy computes a survivor mask over rows, and the SAA weights and
  aggregate run on the survivors.
* **coordinate-wise** (``trimmed_mean``, ``coord_median``): SAA weights
  ``w`` are computed over the valid rows, each row is rescaled to
  ``y_i = c * w_i * u_i`` (``c`` = valid count, so the untrimmed mean of
  ``y`` is the SAA weighted aggregate), and a per-coordinate k-trimmed mean
  of ``y`` is taken (robust-of-weighted).  ``coord_median`` is the maximal
  trim ``k = (c-1)//2``.  With ``use_agg_kernel`` the trim runs through the
  CUDA kernel ``repro_torch.kernels.trimmed_agg``.

``robust_cell`` is the one composition (attack -> guard screen -> robust
mask -> weights, or -> weighted rows -> trim) both substrates run: the
fused pipeline on its gathered operand, the per-stage flat path through
``robust_host_aggregate`` on its stacked rows, so the two agree bit for
bit.  The guard stage (``SimConfig.guard``) is ``core.aggregation.
screen_rows``; its counts ride behind the robust ones.

Invalid rows are excluded via ``valid``; for the coordinate-wise trim they
become ``+inf`` so they rank past the band ``[k, c-k)``, and NaN entries are
scrubbed to ``+inf`` so the sort and the kernel's rank see one ordering.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.aggregation import (no_stale_aggregate, screen_rows,
                                          weights_and_aggregate_by_id)
from repro_torch.core.staleness import RULE_ID, staleness_weights_by_id
from repro_torch.faults.attacks import apply_attack
from repro_torch.kernels.trimmed_agg import ops as trimmed_ops
from repro_torch.kernels.trimmed_agg.ref import trimmed_from_sorted

ROBUST_AGGREGATORS = ("saa", "coord_median", "trimmed_mean", "krum",
                      "multi_krum", "norm_median_clip")
MASK_KINDS = ("krum", "multi_krum", "norm_median_clip")
COORD_KINDS = ("trimmed_mean", "coord_median")

__all__ = ["ROBUST_AGGREGATORS", "MASK_KINDS", "COORD_KINDS", "robust_key",
           "describe_aggregators", "krum_select", "weighted_rows",
           "trimmed_from_sorted", "trimmed_weighted_aggregate", "robust_cell",
           "robust_sweep", "robust_host_aggregate"]

# one-line docs and knob names for ``--list-aggregators`` (the knobs are
# the SimConfig fields the kind reads; ``robust_key`` decides when a knob
# setting changes the path)
_AGG_DOCS = {
    "saa": ("plain SAA staleness-weighted aggregation (baseline)", ()),
    "coord_median": ("per-coordinate median of SAA-weighted rows", ()),
    "trimmed_mean": ("per-coordinate k-trimmed mean of SAA-weighted rows",
                     ("trim_k",)),
    "krum": ("Krum: keep the single closest-neighborhood row", ("krum_f",)),
    "multi_krum": ("Multi-Krum: keep the m best-scored rows",
                   ("krum_f", "multi_krum_m")),
    "norm_median_clip": ("median-norm clip + reject screen",
                         ("guard_clip", "guard_reject_mult")),
}


def describe_aggregators() -> str:
    """Formatted strategy table (``--list-aggregators``)."""
    from repro_torch.core.registry import describe_table
    rows = []
    for kind in ROBUST_AGGREGATORS:
        style = ("mask" if kind in MASK_KINDS
                 else "coord" if kind in COORD_KINDS else "baseline")
        doc, knobs = _AGG_DOCS[kind]
        rows.append((kind, style, ", ".join(knobs) or "-", doc))
    return describe_table(("aggregator", "style", "knobs", "doc"), rows)


def robust_key(cfg) -> Optional[Tuple]:
    """Static robust descriptor for a ``SimConfig``.

    None when the aggregator reduces to plain SAA (``saa`` itself,
    ``trimmed_mean`` with ``trim_k <= 0``, ``multi_krum`` with no ``krum_f``
    and no ``multi_krum_m``, ``norm_median_clip`` with both screen knobs
    unset): those configs run the plain path.  Otherwise a tuple of every
    parameter the robust step needs.
    """
    kind = cfg.aggregator
    if kind == "saa":
        return None
    if kind == "trimmed_mean":
        return None if int(cfg.trim_k) <= 0 else ("trimmed_mean",
                                                  int(cfg.trim_k))
    if kind == "coord_median":
        return ("coord_median",)
    if kind in ("krum", "multi_krum"):
        if kind == "multi_krum" and int(cfg.krum_f) <= 0 \
                and cfg.multi_krum_m is None:
            return None       # m = c - 0 = c keeps every row: plain saa
        m = 1 if kind == "krum" else (
            None if cfg.multi_krum_m is None else int(cfg.multi_krum_m))
        return (kind, int(cfg.krum_f), m)
    if kind == "norm_median_clip":
        if cfg.guard_clip is None and cfg.guard_reject_mult is None:
            return None
        return ("norm_median_clip",
                None if cfg.guard_clip is None else float(cfg.guard_clip),
                None if cfg.guard_reject_mult is None
                else float(cfg.guard_reject_mult))
    raise ValueError(f"unknown aggregator {kind!r} "
                     f"(choose from {ROBUST_AGGREGATORS})")


# -- mask-style ---------------------------------------------------------------

def krum_select(u: torch.Tensor, valid: torch.Tensor, *, f: int,
                m: Optional[int]) -> torch.Tensor:
    """(Multi-)Krum survivor mask for one cell.

    ``u``: ``(n, D)`` rows, ``valid``: ``(n,)`` bool.  Each valid row scores
    the sum of its ``max(c - f - 2, 1)`` smallest squared distances to the
    other valid rows (``c`` = valid count); the ``m`` best-scored rows are
    kept (``m=None``: ``m = c - f``; ``m=1`` is classic Krum), ties broken
    by row index with invalid rows behind every valid one.
    """
    n = u.shape[0]
    sq = (u * u).sum(dim=-1)
    gram = u @ u.T
    d = sq[:, None] + sq[None, :] - 2.0 * gram
    idx = torch.arange(n, device=u.device)
    pair = valid[:, None] & valid[None, :] & (idx[:, None] != idx[None, :])
    # NaN distances (from non-finite rows) must not poison the order
    d = torch.where(pair & torch.isfinite(d), d, torch.inf)
    ds = torch.sort(d, dim=1).values
    c = valid.sum()
    kk = torch.clamp(c - int(f) - 2, 1, n)
    col = idx[None, :]
    score = torch.where((col < kk) & torch.isfinite(ds), ds, 0.0).sum(dim=1)
    # rows whose neighbour band ran past the finite distances score +inf
    short = torch.isfinite(ds).sum(dim=1) < kk
    score = torch.where(valid & ~short, score, torch.inf)
    m_eff = (torch.clamp(c - int(f), 1, n) if m is None
             else min(max(int(m), 1), n))
    tie = torch.where(valid, idx, idx + n)
    rank = ((score[None, :] < score[:, None])
            | ((score[None, :] == score[:, None])
               & (tie[None, :] < tie[:, None]))).sum(dim=1)
    return valid & (rank < m_eff)


# -- coordinate-wise ----------------------------------------------------------

def weighted_rows(u, fresh, tau, valid, beta, rule_id):
    """Rows rescaled to ``y_i = c * w_i * u_i`` with the SAA weights ``w``
    of the valid rows; invalid rows and NaNs become ``+inf``.  Returns
    ``(y (n, D), c)`` with ``c`` the int32 valid count (0-d tensor)."""
    w = staleness_weights_by_id(u, fresh, tau, rule_id, beta=beta,
                                valid=valid)
    c = valid.sum(dtype=torch.int32)
    y = c.to(u.dtype) * w[:, None] * u
    y = torch.where(valid[:, None], y, torch.inf)
    return torch.where(torch.isnan(y), torch.inf, y), c


def _trim_depth(c, trim_k: int, median: bool):
    """``k_eff``: ``(c-1)//2`` for the median, else ``min(trim_k, that)``."""
    k_half = torch.clamp((c - 1) // 2, min=0)
    return k_half if median else torch.clamp(k_half, max=int(trim_k))


def trimmed_weighted_aggregate(u, fresh, tau, valid, beta, rule_id, *,
                               trim_k: int, median: bool,
                               use_kernel: bool = False):
    """Per-coordinate k-trimmed mean of the SAA-weighted rows of one cell.

    ``median=True`` ignores ``trim_k`` and trims maximally (even ``c``
    averages the middle pair).  ``use_kernel`` takes the trim through
    ``kernels.trimmed_agg`` (the CUDA kernel on the GPU), else through the
    sort.  Returns ``(aggregate (D,), n_trimmed)``, ``n_trimmed = 2 k_eff``
    (int32, 0 when no row is valid).
    """
    y, c = weighted_rows(u, fresh, tau, valid, beta, rule_id)
    k_eff = _trim_depth(c, trim_k, median)
    if use_kernel:
        out = trimmed_ops.sweep_trimmed_aggregate(y[None], k_eff[None],
                                                  c[None])[0]
    else:
        out = trimmed_from_sorted(torch.sort(y, dim=0, stable=True).values,
                                  c, k_eff)
    out = torch.where(c > 0, out, 0.0)
    return out, torch.where(c > 0, 2 * k_eff, 0)


# -- the shared composition: attack -> robust -> aggregate ---------------------

def robust_cell(u, fresh, tau, valid, att, *, attack, robust, beta: float,
                rule_id: int, use_kernel: bool, no_stale: bool = False,
                defer_trim: bool = False, guard=None):
    """Attack, guard screen, robust strategy and aggregate for one cell's
    operand.

    u: (n, D) fp32; fresh/valid: (n,) bool; tau: (n,) int32; att: (n,)
    bool attacker flags (read only when ``attack`` is set).  ``attack`` /
    ``robust`` are ``attack_key`` / ``robust_key`` descriptors, ``guard``
    the guard's ``(clip, reject_mult)`` (None: no guard).  The SAA part
    takes the plain torch weights path; ``use_kernel`` routes only the
    coordinate-wise trim through the CUDA kernel.  ``no_stale`` (the fused
    pipeline's round with no stale rows) weighs ``fresh & valid``
    directly, the same weight bits as the general path.  Returns
    ``(aggregate (D,), counts int32 [rows rejected, rows trimmed or
    clipped])``, both on u's device (no host sync); under a guard
    ``counts`` goes on with [rejected non-finite, rejected norm,
    survivors] (the survivors after the robust mask, which the quorum
    reads).  ``defer_trim`` (a coordinate-wise kind) stops before the trim
    and returns ``((y, k_eff, c), counts)`` without the trimmed count,
    for ``robust_sweep`` to trim every group of a round in one launch.
    """
    zero = torch.zeros((), dtype=torch.int32, device=u.device)
    if attack is not None:
        kind, scale, z = attack
        u = apply_attack(u, att, valid, kind=kind, scale=scale, z=z)
    screened = ()
    if guard is not None:
        u, valid, n_nf, n_out, _ = screen_rows(u, valid, clip=guard[0],
                                               reject_mult=guard[1])
        screened = (n_nf, n_out)
    rejected = trimmed = zero
    coord = robust is not None and robust[0] in COORD_KINDS
    if robust is not None and not coord:
        if robust[0] in ("krum", "multi_krum"):
            sel = krum_select(u, valid, f=robust[1], m=robust[2])
            rejected = (valid & ~sel).sum(dtype=torch.int32)
            valid = sel
        else:                                        # norm_median_clip
            _, clip, reject_mult = robust
            u, valid, n_nf, n_out, trimmed = screen_rows(
                u, valid, clip=clip, reject_mult=reject_mult)
            rejected = n_nf + n_out
    if guard is not None:
        screened += (valid.sum(dtype=torch.int32),)
    if coord and defer_trim:
        median = robust[0] == "coord_median"
        y, c = weighted_rows(u, fresh, tau, valid, beta, rule_id)
        return (y, _trim_depth(c, 0 if median else robust[1], median),
                c), torch.stack((rejected,) + screened)
    if coord:
        median = robust[0] == "coord_median"
        out, trimmed = trimmed_weighted_aggregate(
            u, fresh, tau, valid, beta, rule_id,
            trim_k=0 if median else robust[1], median=median,
            use_kernel=use_kernel)
    elif no_stale:
        out = no_stale_aggregate(u, fresh, valid)
    else:
        out, _ = weights_and_aggregate_by_id(u, fresh, tau, valid, beta,
                                             rule_id)
    return out, torch.stack((rejected, trimmed) + screened)


def robust_sweep(u, fresh, tau, valid, att, sizes, *, attack, robust,
                 betas, rule_ids, use_kernel: bool, no_stale=None,
                 guard=None):
    """The robust step of a round's G aggregation groups (the reference's
    S-batched ``robust_sweep_fn``).

    u: (G, n, D) fp32 with each group's ``sizes[g]`` rows first (fresh,
    then landing stale); fresh / valid / att: (G, n) bool (``att`` None
    when no attack is armed); tau: (G, n) int32; ``betas`` / ``rule_ids``
    / ``no_stale``: one Python float / int / bool a group.  Each group's
    attack, mask and SAA weights go through ``robust_cell`` on its own
    rows, the calls a serial run makes: torch picks a reduction's blocking
    by its shape, so one batched weights pass would move a group's bits
    with the batch around it.  The coordinate-wise kinds under
    ``use_kernel`` then trim all G groups in ONE launch of kernel 7, on a
    (G, max size, D) operand padded with ``+inf`` rows (past every band)
    and per-group ``k_eff`` / ``c``; the kernel's cells are independent and
    its variants equal bit for bit, so the padding moves no bit.  Returns
    ``(aggregate (G, D), counts (G, 2) int32 [rejected, trimmed])``, under
    a ``guard`` (G, 5) with ``robust_cell``'s guard counts behind.
    """
    coord = robust is not None and robust[0] in COORD_KINDS
    defer = coord and use_kernel
    outs, counts = [], []
    for g, k in enumerate(sizes):
        out, cnt = robust_cell(
            u[g, :k], fresh[g, :k], tau[g, :k], valid[g, :k],
            None if att is None else att[g, :k], attack=attack,
            robust=robust, beta=betas[g], rule_id=rule_ids[g],
            use_kernel=use_kernel,
            no_stale=bool(no_stale is not None and no_stale[g]),
            defer_trim=defer, guard=guard)
        outs.append(out)
        counts.append(cnt)
    if not defer:
        return torch.stack(outs), torch.stack(counts)
    n = max(sizes)
    y = u.new_full((len(sizes) * n, u.shape[2]), torch.inf)
    dst = torch.as_tensor([g * n + j for g, k in enumerate(sizes)
                           for j in range(k)], device=u.device)
    y[dst] = torch.cat([o[0] for o in outs])
    k_eff = torch.stack([o[1] for o in outs])
    c = torch.stack([o[2] for o in outs])
    agg = trimmed_ops.sweep_trimmed_aggregate(y.view(len(sizes), n, -1),
                                              k_eff, c)
    agg = torch.where((c > 0)[:, None], agg, 0.0)
    trimmed = torch.where(c > 0, 2 * k_eff, 0)
    counts = torch.stack(counts)
    return agg, torch.cat([counts[:, :1], trimmed[:, None], counts[:, 1:]],
                          dim=1)


def robust_host_aggregate(stacked, fresh, tau, att, *, attack, robust,
                          use_kernel: bool, beta: float, rule: str,
                          guard=None):
    """The per-stage flat path's entry for attacked or robust rounds (S = 1).

    ``stacked``: (n, D) device rows, fresh first; ``fresh`` / ``tau`` /
    ``att``: (n,) host or device values; ``guard``: ``(clip,
    reject_mult)`` or None.  Runs ``robust_cell`` on exact rows (the
    reference bucket-pads them with invalid rows, which changes no
    result).  Returns ``(aggregate (D,), counts)`` as ``robust_cell``
    does.
    """
    dev = stacked.device
    fr = torch.as_tensor(fresh, dtype=torch.bool, device=dev)
    ta = torch.as_tensor(tau, dtype=torch.int32, device=dev)
    at = (None if att is None
          else torch.as_tensor(att, dtype=torch.bool, device=dev))
    return robust_cell(stacked, fr, ta, torch.ones_like(fr), at,
                       attack=attack, robust=robust, beta=beta,
                       rule_id=RULE_ID[rule], use_kernel=use_kernel,
                       guard=guard)
