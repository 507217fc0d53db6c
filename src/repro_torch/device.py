"""The device an entry point runs on: the GPU unless the caller asks for
another.  A module of its own so that the models, the engine and the CLIs
can all import it without importing one another."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The GPU unless the caller asks for another device; with no GPU and
    no explicit request this raises instead of running on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch path on the CPU")
    return torch.device("cuda")
