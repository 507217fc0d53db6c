"""PyTorch + CUDA port of the REFL simulator (``repro``), for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its module
paths (``repro_torch.sim.engine`` ports ``repro.sim.engine``, and so on) and
imports neither ``jax`` nor anything of ``repro``.  This slice ports the
main path: ``Simulator(SimConfig(...)).run()`` on the classifier benchmarks
with the ``mlp`` learner, random or priority (RELAY IPS) selection, APT,
SAA, and the fused round pipeline with its device stale cache.  The SAA
server step runs through a hand-written CUDA kernel
(``repro_torch.kernels.staleness_agg``) under ``use_agg_kernel=True``.
The per-stage flat path, YoGi, the robust aggregators
(``repro_torch.robust``; the coordinate-wise trim through the CUDA kernel
``repro_torch.kernels.trimmed_agg``) and coordinated attacks
(``repro_torch.faults``) run on both substrates.  The model zoo's serve
path (``repro_torch.models``, ``repro_torch.launch.serve``,
``python -m repro_torch.serve_model``) serves the global LM for the GQA
transformer with its sliding window (internlm2-1.8b) and RWKV6
(rwkv6-1.6b): prefill, full-sequence logits and greedy decode, through the
CUDA kernels ``repro_torch.kernels.swa_attention`` and
``repro_torch.kernels.wkv6``.

Entry points run on the GPU unless the caller passes ``device="cpu"``;
there the kernels' plain PyTorch versions run instead.
"""
