"""Seeded fault plans and coordinated attacks (port of ``repro.faults``).

The engine applies all of a plan: update corruption (a per-row fp32
multiplier after local training), post-training drops, replayed stale
deliveries, host crashes after a round, and coordinated attacks.
"""
from repro_torch.faults.attacks import (ATTACK_KINDS, AttackSpec,  # noqa: F401
                                        apply_attack, attack_key)
from repro_torch.faults.plan import (CORRUPTION_KINDS, KINDS,  # noqa: F401
                                     FaultPlan, FaultSpec, InjectedCrash)
