"""Seeded fault plans and coordinated attacks (port of ``repro.faults``).

The engine applies the attacks; update corruption, post-drop, replay and
host crashes stay with ROADMAP.md queue 1 item 10, so a plan that carries
fault specs or a crash is refused by ``Simulator``.
"""
from repro_torch.faults.attacks import (ATTACK_KINDS, AttackSpec,  # noqa: F401
                                        apply_attack, attack_key)
from repro_torch.faults.plan import (CORRUPTION_KINDS, KINDS,  # noqa: F401
                                     FaultPlan, FaultSpec, InjectedCrash)
