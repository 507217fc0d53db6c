"""Checked wrappers of the SAA kernel family, and the host entry points.

One wrapper per TPU Pallas function, under its name:
``sweep_fused_staleness_apply``, ``sweep_fused_staleness_aggregate``,
``fused_staleness_aggregate``, ``fused_staleness_apply``,
``deviation_partials`` and ``weighted_aggregate``.  Each validates its
operands, then runs the plain version (``ref``) when every tensor lies on
the CPU, or launches the CUDA kernel (``csrc/staleness_agg.cu``) on the
current stream when every tensor lies on one CUDA device, and counts the
launch in ``LAUNCHES`` under its own name.  Anything else raises: a CUDA
tensor never falls back to the plain version.

The four fused server-step wrappers (``FUSED``) and ``deviation_partials``
run one of two variants of one function, equal bit for bit: the one-launch
thread-block-cluster kernel, or the chain of launches (three for the
server step, two for the partials).  ``variant(s, n, d)`` picks by shape
(the cluster up to ``CLUSTER_MAX_CHUNKS`` 2048-column chunks, the chain
beyond); ``variant=`` forces one.  Each launch also counts under
``<name>:cluster`` or ``<name>:chain``.

Every wrapper checks its operands through ``repro_torch.kernels._launch``:
in full for a new signature of operands (shapes, types, device, contiguity,
alignment, rule, variant), by one lookup for a repeated one, and launches
through its lean C call (the raw current stream, no ``Stream`` object).

The host entry points (``staleness_aggregate``, ``staleness_apply``,
``sweep_staleness_aggregate``, ``sweep_staleness_apply``) take any D, pad
it to the kernels' 2048-column block on the tensors' device, and slice the
results back.
"""
from __future__ import annotations

import torch

from repro_torch.core.aggregation import bucket_pad, pad_cols
from repro_torch.core.staleness import RULE_ID
from repro_torch.kernels import _launch
from repro_torch.kernels._launch import CEntry, Checked
from repro_torch.kernels.staleness_agg import ref

D_BLK = 2048      # columns per CUDA block; D must be a multiple
MAX_N = 1024      # rows per cell the kernels' shared-memory staging takes
NAME = "sweep_fused_staleness_apply"
NAMES = (NAME, "sweep_fused_staleness_aggregate", "fused_staleness_aggregate",
         "fused_staleness_apply", "deviation_partials", "weighted_aggregate")
FUSED = NAMES[:4]         # the server-step wrappers, each with two variants
PARTIALS = NAMES[4]       # two variants too
VARIANTS = ("cluster", "chain")
# The most chunks the cluster variant takes by default: one cluster of at
# most 8 SMs beats the chain's three launches while U is small, and loses
# to the chain's D / 2048 blocks once each block has to stream 3 or more
# chunks (chip_smoke.py's variant times; PERF.md).
CLUSTER_MAX_CHUNKS = 16

# the C entry points: (pointer operands, int operands), then the stream
_ENTRIES = {name: CEntry("staleness_agg", name, n_ptr, n_int)
            for name, (n_ptr, n_int) in {
                "saa_cluster_fused_apply": (7, 4),
                "saa_cluster_fused_aggregate": (7, 4),
                "saa_sweep_fused_apply": (9, 4),
                "saa_sweep_fused_aggregate": (9, 4),
                "saa_cluster_deviation_partials": (4, 2),
                "saa_deviation_partials": (6, 2),
                "saa_weighted_aggregate": (3, 2)}.items()}
launch_key = _launch.launch_key      # "<kernel>:<variant>", as LAUNCHES counts it
# the cluster entry points' own failures
_ERRORS = {-1: "the card cannot schedule the thread block cluster",
           -2: "n is too large for the cluster kernel's shared memory"}


def variant(s: int, n: int, d: int) -> str:
    """The variant the fused wrappers take for S cells of n rows and D
    columns (D % 2048 == 0): the cluster kernel up to
    ``CLUSTER_MAX_CHUNKS`` chunks, else the chain.  The cluster kernel
    stages U in shared memory while it fits and reads it from L2 beyond,
    so n does not change the choice; nor does S (one cluster a cell)."""
    del s, n
    return "cluster" if d // D_BLK <= CLUSTER_MAX_CHUNKS else "chain"


def _variant(forced, s: int, n: int, d: int) -> str:
    """``forced`` checked, or the variant the shape picks if None."""
    if forced is None:
        return variant(s, n, d)
    if forced not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS} or None, got {forced!r}")
    return forced


def _check(want: dict, s: int, n: int, d: int) -> torch.device:
    """``want``: {operand: (tensor, shape, dtype)}.  Checks each operand's
    shape, type and contiguity, the kernels' size limits, and that all lie
    on one device, which it returns."""
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d % D_BLK or not 1 <= n <= MAX_N or s < 1:
        raise ValueError(f"need D % {D_BLK} == 0, 1 <= n <= {MAX_N}, S >= 1; "
                         f"got S={s} n={n} D={d}")
    devices = {t.device for t, _, _ in want.values()}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    return devices.pop()


def _cuda_device(device: torch.device, *rows):
    """None for the CPU (run the plain version), ``device`` for a CUDA
    device whose float rows are 16-byte aligned; raises for anything else."""
    if device.type == "cpu":
        return None
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    for t in rows:
        if t.data_ptr() % 16:
            raise ValueError("float row operands must be 16-byte aligned")
    return device


def _rule(rule: str) -> int:
    if rule not in RULE_ID:
        raise ValueError(f"unknown scaling rule {rule!r}")
    return RULE_ID[rule]


def _run(kernel: str, cname: str, device, tensors, ints, tag=None) -> None:
    """Launch C entry point ``cname`` on ``tensors`` (by pointer) and
    ``ints``, counted as ``kernel`` (and ``kernel:tag``)."""
    _launch.launch(kernel, _ENTRIES[cname], device.index,
                   [t.data_ptr() for t in tensors] + list(ints), tag, _ERRORS)


def _fused(kernel: str, mode: str, v: str, device, operands, s, n, d,
           rule_id) -> None:
    """One fused server step (``mode`` "apply" or "aggregate") by variant
    ``v``: the cluster kernel, or the chain with its partials scratch."""
    prefix, scratch = (("saa_cluster", ()) if v == "cluster" else
                       ("saa_sweep", _scratch(s, n, d, device)))
    _run(kernel, f"{prefix}_fused_{mode}", device, (*operands, *scratch),
         (s, n, d, rule_id), tag=v)


def _scratch(s: int, n: int, d: int, device):
    """Per-chunk partials scratch (num (S, D/2048, n), den (S, D/2048)).
    Inside a CUDA graph capture (the round graphs of the LM learners, whose
    D takes the chain) the caching allocator serves it from the graph's
    private pool, and every replay reuses it."""
    nchunks = d // D_BLK
    return (torch.empty((s, nchunks, n), dtype=torch.float32, device=device),
            torch.empty((s, nchunks), dtype=torch.float32, device=device))


def _cell_operands(updates, fresh, tau, valid, s, n, d) -> dict:
    return {"updates": (updates, (s, n, d), torch.float32),
            "fresh": (fresh, (s, n), torch.bool),
            "tau": (tau, (s, n), torch.int32),
            "valid": (valid, (s, n), torch.bool)}


def _dims(updates, ndim: int):
    if updates.dim() != ndim:
        shape = "(S, n, D)" if ndim == 3 else "(n, D)"
        raise ValueError(f"updates must be {shape}, got {tuple(updates.shape)}")
    return tuple(updates.shape)


# ---------------------------------------------------------------------------
# Each wrapper's full checks, memoised by operand signature (``_launch``):
# each returns the plan (CUDA device or None for the CPU, sizes, rule id,
# variant)
# ---------------------------------------------------------------------------


@Checked
def _plan_sweep_apply(params, updates, fresh, tau, valid, scal, rule, forced):
    rule_id = _rule(rule)
    s, n, d = _dims(updates, 3)
    device = _check({"params": (params, (s, d), torch.float32),
                     **_cell_operands(updates, fresh, tau, valid, s, n, d),
                     "scal": (scal, (s, 2), torch.float32)}, s, n, d)
    v = _variant(forced, s, n, d)
    return _cuda_device(device, params, updates), s, n, d, rule_id, v


@Checked
def _plan_sweep_aggregate(updates, fresh, tau, beta, valid, rule, forced):
    rule_id = _rule(rule)
    s, n, d = _dims(updates, 3)
    device = _check({**_cell_operands(updates, fresh, tau, valid, s, n, d),
                     "beta": (beta, (s,), torch.float32)}, s, n, d)
    v = _variant(forced, s, n, d)
    return _cuda_device(device, updates), s, n, d, rule_id, v


def _cell(updates, fresh, tau, valid, n, d, params=None) -> dict:
    return {**({} if params is None else
               {"params": (params, (d,), torch.float32)}),
            "updates": (updates, (n, d), torch.float32),
            "fresh": (fresh, (n,), torch.bool),
            "tau": (tau, (n,), torch.int32),
            "valid": (valid, (n,), torch.bool)}


@Checked
def _plan_cell_aggregate(updates, fresh, tau, valid, rule, forced):
    rule_id = _rule(rule)
    n, d = _dims(updates, 2)
    device = _check(_cell(updates, fresh, tau, valid, n, d), 1, n, d)
    v = _variant(forced, 1, n, d)
    return device, _cuda_device(device, updates), n, d, rule_id, v


@Checked
def _plan_cell_apply(params, updates, fresh, tau, valid, rule, forced):
    rule_id = _rule(rule)
    n, d = _dims(updates, 2)
    device = _check(_cell(updates, fresh, tau, valid, n, d, params), 1, n, d)
    v = _variant(forced, 1, n, d)
    return device, _cuda_device(device, params, updates), n, d, rule_id, v


@Checked
def _plan_partials(updates, fresh, forced):
    n, d = _dims(updates, 2)
    device = _check({"updates": (updates, (n, d), torch.float32),
                     "fresh": (fresh, (n,), torch.bool)}, 1, n, d)
    v = _variant(forced, 1, n, d)
    return _cuda_device(device, updates), n, d, v


@Checked
def _plan_weighted(weights, updates):
    n, d = _dims(updates, 2)
    device = _check({"weights": (weights, (n,), torch.float32),
                     "updates": (updates, (n, d), torch.float32)}, 1, n, d)
    return _cuda_device(device, updates), n, d


# ---------------------------------------------------------------------------
# Kernel wrappers, one per Pallas function
# ---------------------------------------------------------------------------


def sweep_fused_staleness_apply(params, updates, fresh, tau, valid, scal, *,
                                rule: str = "relay", variant=None):
    """Fused SAA server step: params[s] += lr_s * (w_s @ U_s), in place.

    params: (S, D) fp32, D % 2048 == 0; updates: (S, n, D) fp32; fresh,
    valid: (S, n) bool; tau: (S, n) int32; scal: (S, 2) fp32 rows
    ``(beta_s, server_lr_s)``.  Returns (params, weights (S, n)); an
    all-invalid cell gets zero weights and keeps its parameters.
    ``variant``: "cluster", "chain" or None (by shape; module docstring).
    """
    device, s, n, d, rule_id, v = _plan_sweep_apply(
        (params, updates, fresh, tau, valid, scal), rule, variant)
    if device is None:
        return ref.sweep_fused_staleness_apply(params, updates, fresh, tau,
                                               valid, scal, rule=rule)
    w = torch.empty((s, n), dtype=torch.float32, device=device)
    _fused(NAME, "apply", v, device,
           (params, updates, fresh, tau, valid, scal, w), s, n, d, rule_id)
    return params, w


def sweep_fused_staleness_aggregate(updates, fresh, tau, beta, valid, *,
                                    rule: str = "relay", variant=None):
    """Per-cell SAA aggregate: updates (S, n, D) fp32, D % 2048 == 0;
    fresh/valid (S, n) bool; tau (S, n) int32; beta (S,) fp32.  Returns
    (aggregate (S, D), weights (S, n)); an all-invalid cell gets zero
    weights and a zero aggregate row.  ``variant`` as the apply's."""
    device, s, n, d, rule_id, v = _plan_sweep_aggregate(
        (updates, fresh, tau, beta, valid), rule, variant)
    if device is None:
        return ref.sweep_fused_staleness_aggregate(updates, fresh, tau, beta,
                                                   valid, rule=rule)
    w = torch.empty((s, n), dtype=torch.float32, device=device)
    agg = torch.empty((s, d), dtype=torch.float32, device=device)
    _fused("sweep_fused_staleness_aggregate", "aggregate", v, device,
           (updates, fresh, tau, valid, beta, w, agg), s, n, d, rule_id)
    return agg, w


def _all_valid(valid, fresh):
    return torch.ones_like(fresh) if valid is None else valid


def fused_staleness_aggregate(updates, fresh, tau, beta, *, rule: str = "relay",
                              valid=None, variant=None):
    """One cell: updates (n, D) fp32, D % 2048 == 0; fresh (n,) bool; tau
    (n,) int32; ``beta`` a float.  ``valid`` (n,) bool masks padding rows
    (default: all).  Returns (aggregate (D,), weights (n,)).  ``variant``
    as ``sweep_fused_staleness_apply``'s."""
    valid = _all_valid(valid, fresh)
    where, device, n, d, rule_id, v = _plan_cell_aggregate(
        (updates, fresh, tau, valid), rule, variant)
    beta_t = torch.full((1,), float(beta), dtype=torch.float32, device=where)
    if device is None:
        return ref.fused_staleness_aggregate(updates, fresh, tau, beta_t,
                                             valid, rule=rule)
    w = torch.empty((n,), dtype=torch.float32, device=device)
    agg = torch.empty((d,), dtype=torch.float32, device=device)
    _fused("fused_staleness_aggregate", "aggregate", v, device,
           (updates, fresh, tau, valid, beta_t, w, agg), 1, n, d, rule_id)
    return agg, w


def fused_staleness_apply(params, updates, fresh, tau, beta, server_lr, *,
                          rule: str = "relay", valid=None, variant=None):
    """One cell's server step, in place: params (D,) += server_lr * (w @ U).
    Operands and ``variant`` as ``fused_staleness_aggregate``; returns
    (params, weights (n,))."""
    valid = _all_valid(valid, fresh)
    where, device, n, d, rule_id, v = _plan_cell_apply(
        (params, updates, fresh, tau, valid), rule, variant)
    scal = torch.empty((1, 2), dtype=torch.float32, device=where)
    scal[:, 0], scal[:, 1] = float(beta), float(server_lr)   # fills, no copy
    if device is None:
        return ref.fused_staleness_apply(params, updates, fresh, tau, valid,
                                         scal, rule=rule)
    w = torch.empty((n,), dtype=torch.float32, device=device)
    _fused("fused_staleness_apply", "apply", v, device,
           (params, updates, fresh, tau, valid, scal, w), 1, n, d, rule_id)
    return params, w


def deviation_partials(updates, fresh, *, variant=None):
    """One cell's Eq. 2 partials: updates (n, D) fp32, D % 2048 == 0; fresh
    (n,) bool.  Returns (num (n,), den ()) with Lam = num / (den + EPS).
    ``variant`` as ``sweep_fused_staleness_apply``'s: the cluster kernel
    allocates only its two outputs, the chain its partials scratch too."""
    device, n, d, v = _plan_partials((updates, fresh), variant)
    if device is None:
        return ref.deviation_partials(updates, fresh)
    num, den = updates.new_empty((n,)), updates.new_empty(())
    if v == "cluster":
        _run(PARTIALS, "saa_cluster_deviation_partials", device,
             (updates, fresh, num, den), (n, d), tag=v)
    else:
        _run(PARTIALS, "saa_deviation_partials", device,
             (updates, fresh, num, den, *_scratch(1, n, d, device)), (n, d),
             tag=v)
    return num, den


_WAGG = _ENTRIES["saa_weighted_aggregate"]


def weighted_aggregate(weights, updates):
    """weights (n,) fp32, updates (n, D) fp32, D % 2048 == 0 -> (D,).  The
    leanest wrapper: one signature, one allocation (``new_empty``, 20%
    cheaper than ``torch.empty`` with its keywords on the card's host), one
    C call."""
    device, n, d = _plan_weighted((weights, updates))
    if device is None:
        return ref.weighted_aggregate(weights, updates)
    out = updates.new_empty((d,))
    _launch.launch("weighted_aggregate", _WAGG, device.index,
                   (weights.data_ptr(), updates.data_ptr(), out.data_ptr(), n, d))
    return out


# ---------------------------------------------------------------------------
# Host entry points: any D, padded to the block on the tensors' device
# ---------------------------------------------------------------------------


def staleness_aggregate(updates, fresh, tau, *, rule: str = "relay",
                        beta: float = 0.35, fused: bool = True):
    """updates: (n, D) any-D fp32; fresh: (n,) bool; tau: (n,) int.

    ``fused=True`` runs ``fused_staleness_aggregate`` on the exact rows;
    ``fused=False`` the two-launch A/B path: ``deviation_partials``, the
    weights in torch, then ``weighted_aggregate``.  Returns (aggregate (D,),
    weights (n,)).
    """
    d = updates.shape[1]
    u, fresh, tau, valid = bucket_pad(updates, fresh, tau, lane_block=D_BLK)
    if fused:
        agg, w = fused_staleness_aggregate(u, fresh, tau, beta, rule=rule,
                                           valid=valid)
        return agg[:d], w
    _rule(rule)
    num, den = deviation_partials(u, fresh)
    w = ref.host_weights(num, den, fresh, tau, beta, rule)
    return weighted_aggregate(w, u)[:d], w


def staleness_apply(params, updates, fresh, tau, *, rule: str = "relay",
                    beta: float = 0.35, server_lr: float = 1.0):
    """Fused server step on a flat parameter vector: params (D,) any-D fp32,
    updates (n, D).  Returns (new_params (D,), weights (n,)), new_params =
    params + server_lr * (w @ updates); ``params`` itself is not changed."""
    d = updates.shape[1]
    u, fresh, tau, valid = bucket_pad(updates, fresh, tau, lane_block=D_BLK)
    new_p, w = fused_staleness_apply(pad_cols(params, D_BLK), u, fresh, tau,
                                     beta, server_lr, rule=rule, valid=valid)
    return new_p[:d], w


def _sweep_operands(updates, fresh, tau, valid):
    s, n, _ = updates.shape
    dev = updates.device
    fresh = torch.as_tensor(fresh, dtype=torch.bool, device=dev)
    tau = torch.as_tensor(tau, dtype=torch.int32, device=dev)
    valid = (torch.ones((s, n), dtype=torch.bool, device=dev) if valid is None
             else torch.as_tensor(valid, dtype=torch.bool, device=dev))
    return pad_cols(updates, D_BLK), fresh, tau, valid


def _per_cell(x, s: int, device) -> torch.Tensor:
    """A scalar or an (S,) vector as an (S,) fp32 tensor."""
    return torch.as_tensor(x, dtype=torch.float32).to(device).expand(s).contiguous()


def sweep_staleness_aggregate(updates, fresh, tau, *, valid=None,
                              rule: str = "relay", beta=0.35):
    """Batched SAA over a sweep axis: updates (S, n, any-D) fp32; fresh/tau
    (S, n); ``valid`` masks padded participant slots (default: all real);
    ``beta`` a scalar or an (S,) vector.  Returns (aggregate (S, D),
    weights (S, n))."""
    s, _, d = updates.shape
    u, fresh, tau, valid = _sweep_operands(updates, fresh, tau, valid)
    agg, w = sweep_fused_staleness_aggregate(
        u, fresh, tau, _per_cell(beta, s, u.device), valid, rule=rule)
    return agg[:, :d], w


def sweep_staleness_apply(params, updates, fresh, tau, *, valid=None,
                          rule: str = "relay", beta=0.35, server_lr=1.0):
    """Batched fused server step over a sweep axis: params (S, any-D) fp32,
    updates (S, n, any-D); ``beta``/``server_lr`` scalars or (S,) vectors.
    Returns (new_params (S, D), weights (S, n)); ``params`` itself is not
    changed."""
    s, _, d = updates.shape
    u, fresh, tau, valid = _sweep_operands(updates, fresh, tau, valid)
    scal = torch.stack([_per_cell(beta, s, u.device),
                        _per_cell(server_lr, s, u.device)], dim=1)
    new_p, w = sweep_fused_staleness_apply(pad_cols(params, D_BLK), u, fresh,
                                           tau, valid, scal, rule=rule)
    return new_p[:, :d], w
