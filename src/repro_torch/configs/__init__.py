"""Architecture registry, as ``repro.configs``: one module per architecture
of the reference's zoo, each exporting ``CONFIG`` (the published spec) and
``REDUCED`` (a 2-4 layer, narrow variant of the same family for CPU
tests)."""
from repro_torch.configs.base import (  # noqa: F401
    ALIASES,
    ARCH_IDS,
    INPUT_SHAPES,
    SWA_WINDOW,
    adapt_for_shape,
    get_config,
    get_reduced,
    shape_for,
)
