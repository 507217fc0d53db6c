"""RWKV6 WKV recurrence of the RWKV6 time mixing: CUDA kernel (``csrc/``),
wrapper (``ops``) and plain PyTorch version (``ref``)."""
