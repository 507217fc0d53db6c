"""Compatibility shim (port of ``repro.core.selection``): participant
selection lives in ``repro_torch.selection``, one strategy per module.
This module re-exports the names of the API that predates the selector
zoo, so old import paths, and pickled snapshots naming the old module,
resolve to the same classes."""
from repro_torch.selection import (LearnerView, OortSelector,  # noqa: F401
                                   PrioritySelector, RandomSelector,
                                   SafaSelector, Selector, SELECTORS)
