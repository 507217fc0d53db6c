"""PyTorch + CUDA port of the REFL simulator (``repro``), for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its module
paths (``repro_torch.sim.engine`` ports ``repro.sim.engine``, and so on) and
imports neither ``jax`` nor anything of ``repro``.  This slice ports the
main path: ``Simulator(SimConfig(...)).run()`` on the classifier benchmarks
with the ``mlp`` learner, random or priority (RELAY IPS) selection, APT,
SAA, and the fused round pipeline with its device stale cache.  The SAA
server step runs through a hand-written CUDA kernel
(``repro_torch.kernels.staleness_agg``) under ``use_agg_kernel=True``.

Entry points run on the GPU unless the caller passes ``device="cpu"``;
there the kernels' plain PyTorch versions run instead.
"""
