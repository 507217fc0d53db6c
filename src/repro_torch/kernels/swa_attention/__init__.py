"""Causal sliding-window attention of the GQA transformer's prefill: CUDA
kernel (``csrc/``), wrapper (``ops``) and plain PyTorch version (``ref``)."""
