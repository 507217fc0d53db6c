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

The host entry points (``staleness_aggregate``, ``staleness_apply``,
``sweep_staleness_aggregate``, ``sweep_staleness_apply``) take any D, pad
it to the kernels' 2048-column block on the tensors' device, and slice the
results back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.aggregation import bucket_pad, pad_cols
from repro_torch.core.staleness import RULE_ID
from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.staleness_agg import ref

D_BLK = 2048      # columns per CUDA block; D must be a multiple
MAX_N = 1024      # rows per cell the kernels' shared-memory staging takes
NAME = "sweep_fused_staleness_apply"
NAMES = (NAME, "sweep_fused_staleness_aggregate", "fused_staleness_aggregate",
         "fused_staleness_apply", "deviation_partials", "weighted_aggregate")

# C entry point -> (pointer operands, int operands); a stream pointer follows
_SIGNATURES = {
    "saa_sweep_fused_apply": (9, 4),
    "saa_sweep_fused_aggregate": (9, 4),
    "saa_deviation_partials": (6, 2),
    "saa_weighted_aggregate": (3, 2),
}
_fns: dict = {}


def _cfn(name: str):
    if name not in _fns:
        fn = getattr(_build.library("staleness_agg"), name)
        n_ptr, n_int = _SIGNATURES[name]
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


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


def _on_cuda(device: torch.device, *rows) -> bool:
    """False for the CPU (run the plain version), True for a CUDA device
    whose float rows are 16-byte aligned; raises for anything else."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    for t in rows:
        if t.data_ptr() % 16:
            raise ValueError("float row operands must be 16-byte aligned")
    return True


def _rule(rule: str) -> int:
    if rule not in RULE_ID:
        raise ValueError(f"unknown scaling rule {rule!r}")
    return RULE_ID[rule]


def _launch(kernel: str, cname: str, device, *args) -> None:
    """Call C entry point ``cname`` on the current stream of ``device``
    (tensors are passed by pointer; ``args`` keeps them alive through the
    call, and the caching allocator orders any reuse of their memory after
    the launch on this stream) and count one launch of ``kernel``."""
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _cfn(cname)(*ptrs, stream)
    if err:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")
    LAUNCHES[kernel] += 1


def _scratch(s: int, n: int, d: int, device):
    """Per-chunk partials scratch (num (S, D/2048, n), den (S, D/2048))."""
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
# Kernel wrappers, one per Pallas function
# ---------------------------------------------------------------------------


def sweep_fused_staleness_apply(params, updates, fresh, tau, valid, scal, *,
                                rule: str = "relay"):
    """Fused SAA server step: params[s] += lr_s * (w_s @ U_s), in place.

    params: (S, D) fp32, D % 2048 == 0; updates: (S, n, D) fp32; fresh,
    valid: (S, n) bool; tau: (S, n) int32; scal: (S, 2) fp32 rows
    ``(beta_s, server_lr_s)``.  Returns (params, weights (S, n)); an
    all-invalid cell gets zero weights and keeps its parameters.
    """
    rule_id = _rule(rule)
    s, n, d = _dims(updates, 3)
    device = _check({"params": (params, (s, d), torch.float32),
                     **_cell_operands(updates, fresh, tau, valid, s, n, d),
                     "scal": (scal, (s, 2), torch.float32)}, s, n, d)
    if not _on_cuda(device, params, updates):
        return ref.sweep_fused_staleness_apply(params, updates, fresh, tau,
                                               valid, scal, rule=rule)
    w = torch.empty((s, n), dtype=torch.float32, device=device)
    _launch(NAME, "saa_sweep_fused_apply", device, params, updates, fresh,
            tau, valid, scal, w, *_scratch(s, n, d, device), s, n, d, rule_id)
    return params, w


def sweep_fused_staleness_aggregate(updates, fresh, tau, beta, valid, *,
                                    rule: str = "relay"):
    """Per-cell SAA aggregate: updates (S, n, D) fp32, D % 2048 == 0;
    fresh/valid (S, n) bool; tau (S, n) int32; beta (S,) fp32.  Returns
    (aggregate (S, D), weights (S, n)); an all-invalid cell gets zero
    weights and a zero aggregate row."""
    rule_id = _rule(rule)
    s, n, d = _dims(updates, 3)
    device = _check({**_cell_operands(updates, fresh, tau, valid, s, n, d),
                     "beta": (beta, (s,), torch.float32)}, s, n, d)
    if not _on_cuda(device, updates):
        return ref.sweep_fused_staleness_aggregate(updates, fresh, tau, beta,
                                                   valid, rule=rule)
    w = torch.empty((s, n), dtype=torch.float32, device=device)
    agg = torch.empty((s, d), dtype=torch.float32, device=device)
    _launch("sweep_fused_staleness_aggregate", "saa_sweep_fused_aggregate",
            device, updates, fresh, tau, valid, beta, w, agg,
            *_scratch(s, n, d, device), s, n, d, rule_id)
    return agg, w


def _all_valid(valid, fresh):
    return torch.ones_like(fresh) if valid is None else valid


def fused_staleness_aggregate(updates, fresh, tau, beta, *, rule: str = "relay",
                              valid=None):
    """One cell: updates (n, D) fp32, D % 2048 == 0; fresh (n,) bool; tau
    (n,) int32; ``beta`` a float.  ``valid`` (n,) bool masks padding rows
    (default: all).  Returns (aggregate (D,), weights (n,))."""
    rule_id = _rule(rule)
    n, d = _dims(updates, 2)
    valid = _all_valid(valid, fresh)
    device = _check({"updates": (updates, (n, d), torch.float32),
                     "fresh": (fresh, (n,), torch.bool),
                     "tau": (tau, (n,), torch.int32),
                     "valid": (valid, (n,), torch.bool)}, 1, n, d)
    beta_t = torch.full((1,), float(beta), dtype=torch.float32, device=device)
    if not _on_cuda(device, updates):
        return ref.fused_staleness_aggregate(updates, fresh, tau, beta_t,
                                             valid, rule=rule)
    w = torch.empty((n,), dtype=torch.float32, device=device)
    agg = torch.empty((d,), dtype=torch.float32, device=device)
    _launch("fused_staleness_aggregate", "saa_sweep_fused_aggregate", device,
            updates, fresh, tau, valid, beta_t, w, agg,
            *_scratch(1, n, d, device), 1, n, d, rule_id)
    return agg, w


def fused_staleness_apply(params, updates, fresh, tau, beta, server_lr, *,
                          rule: str = "relay", valid=None):
    """One cell's server step, in place: params (D,) += server_lr * (w @ U).
    Operands as ``fused_staleness_aggregate``; returns (params, weights
    (n,))."""
    rule_id = _rule(rule)
    n, d = _dims(updates, 2)
    valid = _all_valid(valid, fresh)
    device = _check({"params": (params, (d,), torch.float32),
                     "updates": (updates, (n, d), torch.float32),
                     "fresh": (fresh, (n,), torch.bool),
                     "tau": (tau, (n,), torch.int32),
                     "valid": (valid, (n,), torch.bool)}, 1, n, d)
    scal = torch.empty((1, 2), dtype=torch.float32, device=device)
    scal[:, 0], scal[:, 1] = float(beta), float(server_lr)   # fills, no copy
    if not _on_cuda(device, params, updates):
        return ref.fused_staleness_apply(params, updates, fresh, tau, valid,
                                         scal, rule=rule)
    w = torch.empty((n,), dtype=torch.float32, device=device)
    _launch("fused_staleness_apply", "saa_sweep_fused_apply", device, params,
            updates, fresh, tau, valid, scal, w, *_scratch(1, n, d, device),
            1, n, d, rule_id)
    return params, w


def deviation_partials(updates, fresh):
    """One cell's Eq. 2 partials: updates (n, D) fp32, D % 2048 == 0; fresh
    (n,) bool.  Returns (num (n,), den ()) with Lam = num / (den + EPS)."""
    n, d = _dims(updates, 2)
    device = _check({"updates": (updates, (n, d), torch.float32),
                     "fresh": (fresh, (n,), torch.bool)}, 1, n, d)
    if not _on_cuda(device, updates):
        return ref.deviation_partials(updates, fresh)
    num = torch.empty((n,), dtype=torch.float32, device=device)
    den = torch.empty((), dtype=torch.float32, device=device)
    _launch("deviation_partials", "saa_deviation_partials", device, updates,
            fresh, num, den, *_scratch(1, n, d, device), n, d)
    return num, den


def weighted_aggregate(weights, updates):
    """weights (n,) fp32, updates (n, D) fp32, D % 2048 == 0 -> (D,)."""
    n, d = _dims(updates, 2)
    device = _check({"weights": (weights, (n,), torch.float32),
                     "updates": (updates, (n, d), torch.float32)}, 1, n, d)
    if not _on_cuda(device, updates):
        return ref.weighted_aggregate(weights, updates)
    out = torch.empty((d,), dtype=torch.float32, device=device)
    _launch("weighted_aggregate", "saa_weighted_aggregate", device, weights,
            updates, out, n, d)
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
