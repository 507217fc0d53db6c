"""Coordinated (colluding) attack models, on torch tensors; port of
``repro.faults.attacks``.

An ``AttackSpec`` drives a seeded per-round attacker set (drawn by
``FaultPlan.with_attack`` from its own RNG stream) whose rows are rewritten
jointly at aggregation time.  ``apply_attack`` is the one formula both
substrates run on the round's ``(..., n, D)`` operand, so an attack replays
bit-identically on the fused pipeline and the per-stage flat path.

Attack kinds (``SimConfig.attack``):

* ``collude_signflip``   — attackers submit ``-scale * u_i``.
* ``collude_same_value`` — attackers all submit one shared constant vector
  of L2 norm ``scale``.
* ``alie``               — "A Little Is Enough": attackers submit
  ``mu - z * sigma`` of the honest rows.
* ``adaptive``           — attackers submit ``-u_i`` rescaled to
  ``scale * sqrt(median honest ||u||^2)``, the largest reversed update a
  median-norm reject with ``guard_reject_mult > scale`` will not flag.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

ATTACK_KINDS = ("none", "collude_signflip", "collude_same_value", "alie",
                "adaptive")
_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class AttackSpec:
    """Static description of a coordinated attack."""
    kind: str
    frac: float = 0.25       # attacker fraction of the population, per round
    scale: float = 10.0      # magnitude knob (see the kinds above)
    z: float = 1.5           # alie sigma multiplier

    def __post_init__(self):
        if self.kind not in ATTACK_KINDS:
            raise ValueError(f"unknown attack kind {self.kind!r} "
                             f"(choose from {ATTACK_KINDS})")


def attack_key(cfg) -> Optional[Tuple[str, float, float]]:
    """Static attack descriptor for a ``SimConfig``: None when no attack is
    armed, else ``(kind, scale, z)``."""
    if cfg.attack == "none" or float(cfg.attack_frac) <= 0.0:
        return None
    if cfg.attack not in ATTACK_KINDS:
        raise ValueError(f"unknown attack kind {cfg.attack!r} "
                         f"(choose from {ATTACK_KINDS})")
    return (cfg.attack, float(cfg.attack_scale), float(cfg.attack_z))


def apply_attack(u: torch.Tensor, att: torch.Tensor, valid: torch.Tensor, *,
                 kind: str, scale: float, z: float) -> torch.Tensor:
    """Rewrite the attacker rows of the aggregation operand.

    ``u``: ``(..., n, D)`` fp32 rows; ``att`` / ``valid``: ``(..., n)`` bool
    (``att`` marks the rows whose learner is in this round's attacker
    set).  Rows with ``att`` False pass through ``torch.where`` bit for
    bit.  The honest statistics (``alie``, ``adaptive``) are taken over
    the valid non-attacker rows; the median index is ``(h - 1) // 2``.
    """
    attc = (att & valid)[..., None]
    if kind == "collude_signflip":
        return torch.where(attc, -scale * u, u)
    if kind == "collude_same_value":
        d = u.shape[-1]
        crafted = torch.full(u.shape[-1:], scale / (d ** 0.5), dtype=u.dtype,
                             device=u.device)
        return torch.where(attc, crafted, u)
    honest = (valid & ~att)[..., None]
    hcnt = torch.clamp(honest.sum(dim=-2, keepdim=True), min=1)
    if kind == "alie":
        mu = torch.where(honest, u, 0.0).sum(dim=-2, keepdim=True) / hcnt
        var = torch.where(honest, (u - mu) ** 2, 0.0).sum(
            dim=-2, keepdim=True) / hcnt
        crafted = mu - z * torch.sqrt(var)
        return torch.where(attc, crafted, u)
    if kind == "adaptive":
        n2 = (u * u).sum(dim=-1)
        srt = torch.sort(torch.where(honest[..., 0], n2, torch.inf),
                         dim=-1).values
        h1 = hcnt[..., 0, 0]
        med = torch.gather(srt, -1, ((h1 - 1) // 2)[..., None])
        target = scale * torch.sqrt(torch.clamp(med, min=0.0))
        rn = torch.sqrt(torch.clamp(n2, min=_EPS))[..., None]
        return torch.where(attc, -u * (target[..., None] / rn), u)
    raise ValueError(f"unknown attack kind {kind!r}")
