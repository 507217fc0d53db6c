"""SAA weight-scaling rules (paper §4.2.4, Eq. 2), on torch tensors.

Port of ``repro.core.staleness``.  Given a round's fresh updates F and
stale updates S (delayed tau_s rounds):

  Equal :  w_s = 1
  DynSGD:  w_s = 1 / (tau_s + 1)
  AdaSGD:  w_s = exp(-(tau_s + 1))
  RELAY :  w_s = (1-beta)/(tau_s+1) + beta * (1 - exp(-Lam_s / Lam_max))

with the deviation score
  Lam_s = || u_hat_F - (u_s + n_F u_hat_F) / (n_F + 1) ||^2 / || u_hat_F ||^2.

Fresh updates always get w_f = 1; the final coefficients are w_i / sum_j w_j.
"""
from __future__ import annotations

import torch

EPS = 1e-12


def fresh_average(updates: torch.Tensor, fresh: torch.Tensor) -> torch.Tensor:
    """updates: (n, D); fresh: (n,) bool. Returns u_hat_F (D,) (zeros if no fresh)."""
    n_f = fresh.sum()
    s = torch.where(fresh[:, None], updates, 0.0).sum(dim=0)
    return s / torch.clamp(n_f, min=1)


def deviation_scores(updates: torch.Tensor, fresh: torch.Tensor) -> torch.Tensor:
    """Lam_s per update (Eq. 2 numerator/denominator); 0 for fresh entries."""
    u_hat = fresh_average(updates, fresh)
    n_f = fresh.sum().to(updates.dtype)
    mixed = (updates + n_f * u_hat[None, :]) / (n_f + 1.0)
    num = torch.sum((u_hat[None, :] - mixed) ** 2, dim=-1)
    den = torch.sum(u_hat ** 2) + EPS
    return torch.where(fresh, 0.0, num / den)


def _rule_equal(tau, lam, lam_max, beta):
    return torch.ones_like(tau, dtype=torch.float32)


def _rule_dynsgd(tau, lam, lam_max, beta):
    return 1.0 / (tau.to(torch.float32) + 1.0)


def _rule_adasgd(tau, lam, lam_max, beta):
    return torch.exp(-(tau.to(torch.float32) + 1.0))


def _rule_relay(tau, lam, lam_max, beta):
    damp = 1.0 / (tau.to(torch.float32) + 1.0)
    boost = 1.0 - torch.exp(-lam / torch.clamp(lam_max, min=EPS))
    return (1.0 - beta) * damp + beta * boost


SCALING_RULES = {
    "equal": _rule_equal,
    "dynsgd": _rule_dynsgd,
    "adasgd": _rule_adasgd,
    "relay": _rule_relay,
}

# stable rule indexing: the CUDA kernel takes the rule as this integer
RULE_ORDER = tuple(SCALING_RULES)
RULE_ID = {r: i for i, r in enumerate(RULE_ORDER)}


def staleness_weights(updates: torch.Tensor, fresh: torch.Tensor,
                      tau: torch.Tensor, *, rule: str = "relay",
                      beta: float = 0.35,
                      valid: torch.Tensor | None = None) -> torch.Tensor:
    """Normalized aggregation coefficients w_hat (n,).

    updates: (n, D) flat updates; fresh: (n,) bool; tau: (n,) staleness in
    rounds (0 for fresh); valid: optional (n,) mask for padded slots.
    """
    return staleness_weights_by_id(updates, fresh, tau, RULE_ID[rule],
                                   beta=beta, valid=valid)


def staleness_weights_by_id(updates, fresh, tau, rule_id: int, *, beta=0.35,
                            valid=None):
    """``staleness_weights`` with the scaling rule given by its
    ``RULE_ORDER`` index (the reference selects it with ``lax.switch``)."""
    if valid is None:
        valid = torch.ones_like(fresh)
    lam = deviation_scores(updates, fresh & valid)
    stale_mask = (~fresh) & valid
    lam_max = torch.max(torch.where(stale_mask, lam, 0.0))
    w_stale = SCALING_RULES[RULE_ORDER[int(rule_id)]](tau, lam, lam_max, beta)
    w = torch.where(fresh, 1.0, w_stale)
    w = torch.where(valid, w, 0.0)
    return w / torch.clamp(w.sum(), min=EPS)
