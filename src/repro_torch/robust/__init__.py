"""Byzantine-robust aggregation strategies (port of ``repro.robust``).

``SimConfig.aggregator`` picks a strategy from ``ROBUST_AGGREGATORS``;
``robust_key`` maps a config to the descriptor both substrates run.
"""
from repro_torch.robust.aggregators import (COORD_KINDS, MASK_KINDS,  # noqa: F401
                                            ROBUST_AGGREGATORS, krum_select,
                                            robust_key,
                                            trimmed_weighted_aggregate)
