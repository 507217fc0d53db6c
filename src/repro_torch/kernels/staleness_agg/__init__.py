"""Fused SAA server step: CUDA kernel (``csrc/``), wrapper (``ops``) and
plain PyTorch version (``ref``)."""
