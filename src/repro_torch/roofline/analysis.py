"""Roofline analysis of a placed step (port of ``repro.roofline.analysis``).

  compute    = FLOPs / peak FLOP/s
  memory     = bytes / HBM bandwidth
  collective = collective bytes / link bandwidth

with FLOPs, bytes and collective bytes of one chip's share of the step
(``repro_torch.roofline.dispatch_cost`` counts them on the placed step's
local shards).  The reference takes them from XLA's compiled program and
TPU v5e constants; the port has no compiler and uses the constants of the
card it runs on, an NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit.

``swa_cost`` and ``wkv_cost`` are the work the two LM kernels (sliding-
window attention, the RWKV6 recurrence) must do, the bounds
``chip_smoke.py`` holds them to; the dry run adds them where a counted
step would launch those kernels on the card.
"""
from __future__ import annotations

import dataclasses
import math

H100 = {
    "name": "NVIDIA H100 80GB HBM3",
    "peak_flops_bf16": 989e12,   # dense FLOP/s a chip
    "peak_flops_fp32": 67e12,    # FLOP/s a chip, CUDA cores (no TF32)
    "hbm_bw": 3.35e12,           # B/s a chip
    "link_bw": 450e9,            # NVLink B/s a direction
}


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float            # the step's counted FLOPs (a chip's share)
    hlo_bytes: float
    collective_bytes: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float
    useful_ratio: float
    per_device_hbm: float = float("nan")

    def row(self) -> str:
        return (f"{self.arch},{self.shape},{self.mesh},{self.chips},"
                f"{self.hlo_flops:.3e},{self.hlo_bytes:.3e},"
                f"{self.collective_bytes:.3e},{self.t_compute*1e3:.3f},"
                f"{self.t_memory*1e3:.3f},{self.t_collective*1e3:.3f},"
                f"{self.bottleneck},{self.model_flops:.3e},"
                f"{self.useful_ratio:.3f},{self.per_device_hbm:.3e}")

    HEADER = ("arch,shape,mesh,chips,hlo_flops,hlo_bytes,coll_bytes,"
              "t_compute_ms,t_memory_ms,t_collective_ms,bottleneck,"
              "model_flops,useful_ratio,per_device_hbm_bytes")


def roofline_terms(*, arch: str, shape: str, mesh_name: str, chips: int,
                   cost: dict, coll_bytes: float, model_flops_val: float,
                   per_device_hbm: float = float("nan"),
                   flops_are_per_chip: bool = True) -> RooflineReport:
    """The three roofline times of a step whose ``cost`` holds ``flops``
    and ``bytes accessed`` (a chip's share when ``flops_are_per_chip``,
    else the whole step's) and ``coll_bytes`` a chip sends; the compute
    peak is the H100's dense bf16 rate, as the reference's is v5e's."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    div = 1 if flops_are_per_chip else chips
    t_comp = flops / div / H100["peak_flops_bf16"]
    t_mem = byts / div / H100["hbm_bw"]
    t_coll = coll_bytes / H100["link_bw"]
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)
    useful = model_flops_val / max(flops * (chips if flops_are_per_chip else 1), 1.0)
    return RooflineReport(arch, shape, mesh_name, chips, flops, byts, coll_bytes,
                          t_comp, t_mem, t_coll, bottleneck, model_flops_val,
                          useful, per_device_hbm)


def model_flops(n_params_active: int, n_tokens: int, kind: str) -> float:
    """MODEL_FLOPS = 6*N*D for training, 2*N*D for inference forward."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * n_tokens


def active_params(cfg, params_shape) -> int:
    """Active parameters per token (MoE: routed experts counted top_k/E).
    ``params_shape``: a parameter tree whose leaves have a ``.shape``
    (``shape_params``' meta tensors)."""
    from repro_torch.core.aggregation import _leaves
    total = 0
    for path, leaf in _leaves(params_shape):
        names = [str(k) for k in path]
        n = math.prod(leaf.shape)
        if cfg.moe and any(x in names for x in ("w_gate", "w_up", "w_down")) \
                and "ffn" in names and "shared" not in names \
                and len(leaf.shape) >= 3:
            n = n * cfg.top_k // max(cfg.n_experts, 1)
        total += n
    return int(total)


# ---------------------------------------------------------------------------
# The LM kernels' work (kernels 8 and 9)
# ---------------------------------------------------------------------------


def live_pairs(s, window) -> int:
    """(query, key) pairs of one sequence with j <= i and i - j < window."""
    w = min(s, window)
    return w * (w + 1) // 2 + (s - w) * window


def swa_cost(b, s, h, hkv, dh, window, elem, dv=None):
    """(bytes, flops) sliding-window attention needs: q, k, v read once and
    the output written once (``elem`` bytes an element); per live pair
    2 Dh flops for q.k and 2 Dv for p v (the exponentials are not
    counted).  ``dv``, v's and the output's head dim, is ``dh`` unless
    given (MLA: q / k of nope + rope dims, v of ``v_head_dim``)."""
    dv = dh if dv is None else dv
    return (elem * b * s * (dh + dv) * (h + hkv),
            2 * (dh + dv) * h * b * live_pairs(s, window))


def wkv_cost(b, s, h, n, elem, with_s0):
    """(bytes, flops) WKV6 needs: r, k, v (``elem`` bytes) and w (fp32)
    read once, u and s0 read once, y (``elem``) and the final state (fp32)
    written once; per (batch, head, step) 2 N^2 flops for r.S and 3 N^2 for
    the state's decay and outer product."""
    seq = b * s * h * n
    return (seq * (4 * elem + 4) + h * n * 4 + b * h * n * n * 4 * (2 if with_s0 else 1),
            5 * n * n * b * h * s)
