"""Participant selection (port of ``repro.selection``): the strategy table
with the slice's two selectors, ``random`` and ``priority`` (RELAY IPS)."""
from repro_torch.selection.base import (BuildContext, Knob, LearnerView,  # noqa: F401
                                        Selector, SelectorSpec, class_factory)
from repro_torch.selection.registry import (SELECTOR_TABLE,  # noqa: F401
                                            build_selector,
                                            normalize_selector_params,
                                            register_selector)
from repro_torch.selection.uniform import RandomSelector  # noqa: F401,E402
from repro_torch.selection.priority import PrioritySelector  # noqa: F401,E402
