"""Participant selection (port of ``repro.selection``): the strategy table
with the reference's seven selectors, registered in its order.

  random        uniform sampling (FedAvg baseline)
  oort          utility x speed, eps-greedy + pacer (Lai et al., OSDI'21)
  priority      RELAY IPS Alg. 1: least-available-first + hold-off
  safa          select-all, target-ratio round end (Wu et al., 2021)
  flips         label-distribution k-means, cluster-balanced budgets
  ucb           UCB1 bandit on stat-utility rewards
  contribution  decayed contribution ranking + fairness floor
"""
from repro_torch.selection.base import (BuildContext, Knob, LearnerView,  # noqa: F401
                                        Selector, SelectorSpec, class_factory)
from repro_torch.selection.registry import (SELECTOR_TABLE,  # noqa: F401
                                            build_selector,
                                            describe_selectors,
                                            normalize_selector_params,
                                            register_selector, selector_key)

# importing a strategy module registers it; table order = listing order
from repro_torch.selection.uniform import RandomSelector  # noqa: F401,E402
from repro_torch.selection.oort import OortSelector  # noqa: F401,E402
from repro_torch.selection.priority import PrioritySelector  # noqa: F401,E402
from repro_torch.selection.safa import SafaSelector  # noqa: F401,E402
from repro_torch.selection.flips import FlipsSelector  # noqa: F401,E402
from repro_torch.selection.ucb import UcbSelector  # noqa: F401,E402
from repro_torch.selection.contribution import ContributionSelector  # noqa: F401,E402
