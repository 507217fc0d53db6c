"""Per-coordinate trimmed mean of the robust coordinate-wise aggregators:
CUDA kernel (``csrc/``), wrapper (``ops``) and plain PyTorch version
(``ref``)."""
