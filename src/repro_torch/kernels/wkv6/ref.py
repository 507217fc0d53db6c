"""Plain PyTorch version of the WKV6 kernel: the model's sequential scan, as
``repro.kernels.wkv6.ref`` is.  The CPU tests and the wrapper (for CPU
tensors) run it, and ``chip_smoke.py`` holds the CUDA kernel against it on
the card."""
from repro_torch.models.rwkv6 import wkv6_scan  # noqa: F401
