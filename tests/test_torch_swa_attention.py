"""The sliding-window attention kernel's wrappers and plain version
(``repro_torch.kernels.swa_attention``) against the JAX Pallas kernel
``swa_attention`` in interpret mode, on ``tests/test_kernels.py``'s shapes
(GQA groups 1, 2 and 4; S off the 128 tile; windows of 1 and 3 tiles) and
the CUDA kernels' tile edges (S = 63, 65, 129; G = 8) and head dims (64,
128, and kimi-k2's 112) in fp32 and bf16, the window's exact reach, the TPU kernel layout
(``swa_attention_bhsd``), and the wrappers' checks.

Tolerance: 1e-4 in fp32 and 3e-2 in bf16, the reference's own for its
kernel against its oracle (the two sum the online softmax in other orders;
bf16 rounds the output once).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.swa_attention import ops as jops
from repro.kernels.swa_attention import ref as jref
from repro.kernels.swa_attention.swa_attention import swa_attention_bhsd as j_bhsd
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.swa_attention import ops, ref

torch.set_num_threads(1)

SHAPES = [(1, 256, 2, 1, 64, 128),
          (2, 384, 4, 2, 64, 256),
          (1, 200, 2, 2, 128, 128),   # S off the 128 tile
          (1, 512, 8, 2, 64, 384),
          # the GPU kernels' edges: a 64-row warpgroup, a 128-row tile; G = 8
          (1, 63, 2, 1, 128, 128),
          (2, 65, 4, 2, 64, 128),
          (1, 129, 8, 1, 64, 128),
          # kimi-k2's head dim, 112: the 128-wide kernels keep 112 columns
          (1, 200, 4, 2, 112, 128),
          (2, 129, 8, 1, 112, 256)]
DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _operands(B, S, H, Hkv, Dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, Dh)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32))


def _to(arrs, jdt, tdt):
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("B,S,H,Hkv,Dh,W", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fn", ["ops", "ref"])
def test_port_matches_pallas(B, S, H, Hkv, Dh, W, dtype, fn):
    jdt, tdt, tol = DTYPES[dtype]
    (jq, jk, jv), (tq, tk, tv) = _to(_operands(B, S, H, Hkv, Dh, S + W), jdt, tdt)
    want = jops.swa_attention(jq, jk, jv, window=W)
    port = ops.swa_attention if fn == "ops" else ref.swa_attention_ref
    got = port(tq, tk, tv, window=W)
    assert got.dtype == tdt and got.shape == (B, S, H, Dh)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    # and the JAX package's own oracle
    np.testing.assert_allclose(_f32(got), _f32(jref.swa_attention_ref(
        jq, jk, jv, window=W)), rtol=tol, atol=tol)


def test_respects_window():
    """Keys beyond the last query's window have no influence on it; the
    key at exactly ``window - 1`` back does (the bound is strict)."""
    B, S, H, Dh, W = 1, 384, 1, 64, 128
    q, k, v = (torch.from_numpy(a) for a in _operands(B, S, H, H, Dh, 0))
    out1 = ops.swa_attention(q, k, v, window=W)
    rng = np.random.default_rng(1)
    k2, v2 = k.clone(), v.clone()
    far = S - W          # keys [0, S - W) are outside the last query's window
    k2[:, :far] = torch.from_numpy(rng.standard_normal((B, far, H, Dh)).astype(np.float32))
    v2[:, :far] = torch.from_numpy(rng.standard_normal((B, far, H, Dh)).astype(np.float32))
    out2 = ops.swa_attention(q, k2, v2, window=W)
    torch.testing.assert_close(out1[:, -1], out2[:, -1], rtol=1e-5, atol=1e-6)
    v3 = v.clone()
    v3[:, far] += 1.0    # the oldest key inside the window
    assert not torch.allclose(ops.swa_attention(q, k, v3, window=W)[:, -1],
                              out1[:, -1])


@pytest.mark.parametrize("B,S,H,Hkv,Dh,W", [(1, 256, 2, 1, 64, 128),
                                            (2, 384, 4, 2, 64, 256)])
def test_bhsd_layout_matches_pallas_kernel(B, S, H, Hkv, Dh, W):
    """The TPU kernel's own layout: q (B*H, S, Dh), k / v (B*Hkv, S, Dh)."""
    q, k, v = _operands(B, S, H, Hkv, Dh, 3)
    bh = lambda a: np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(-1, S, Dh))
    q, k, v = bh(q), bh(k), bh(v)
    got = ops.swa_attention_bhsd(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), window=W, n_kv_heads=Hkv)
    want = j_bhsd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=W,
                  n_kv_heads=Hkv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def _cpu_operands():
    return [torch.from_numpy(a) for a in _operands(1, 130, 4, 2, 64, 5)]


@pytest.mark.parametrize("bad", [
    lambda q, k, v: (q, k, v, 100),                     # window off the tile
    lambda q, k, v: (q.double(), k.double(), v.double(), 128),
    lambda q, k, v: (q, k.to(torch.bfloat16), v, 128),
    lambda q, k, v: (q, k[:, :-1], v[:, :-1], 128),     # S differs
    lambda q, k, v: (q[:, :, :3], k, v, 128),           # H not a multiple of Hkv
    lambda q, k, v: (q, k, v[..., :32], 128),
])
def test_wrapper_rejects_bad_operands(bad):
    q, k, v, window = bad(*_cpu_operands())
    with pytest.raises(ValueError):
        ops.swa_attention(q, k, v, window=window)


def test_wrapper_never_falls_back_off_the_cpu():
    """A tensor on a device without a kernel (here ``meta``) raises instead
    of running the plain version; a CPU call counts no launch."""
    q, k, v = _cpu_operands()
    before = LAUNCHES[ops.NAME]
    ops.swa_attention(q, k, v, window=128)
    assert LAUNCHES[ops.NAME] == before
    with pytest.raises(ValueError, match="no kernel"):
        ops.swa_attention(q.to("meta"), k.to("meta"), v.to("meta"), window=128)
    with pytest.raises(ValueError, match="several devices"):
        ops.swa_attention(q.to("meta"), k, v, window=128)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """On the card: the CUDA kernel == the plain version, both layouts;
    bf16 takes the tensor-core kernel, fp32 the CUDA-core one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    for B, S, H, Hkv, Dh, W in SHAPES:
        for _, tdt, tol in DTYPES.values():
            q, k, v = (torch.from_numpy(a).to("cuda", tdt)
                       for a in _operands(B, S, H, Hkv, Dh, 7))
            before = LAUNCHES[ops.NAME], LAUNCHES[ops.KERNELS[tdt]]
            got = ops.swa_attention(q, k, v, window=W)
            torch.cuda.synchronize()
            assert (LAUNCHES[ops.NAME], LAUNCHES[ops.KERNELS[tdt]]) == \
                (before[0] + 1, before[1] + 1)
            torch.testing.assert_close(got.float(), ref.swa_attention_ref(
                q, k, v, window=W).float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_kernel_rejects_other_head_dims():
    """On the card a head dim outside (64, 112, 128) raises and launches
    nothing: no fallback to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    before = LAUNCHES[ops.NAME]
    for dh in (32, 96, 120, 256):
        q, k, v = (torch.zeros((1, 130, 2, dh), device="cuda", dtype=torch.bfloat16)
                   for _ in range(3))
        with pytest.raises(ValueError, match="head dims"):
            ops.swa_attention(q, k, v, window=128)
    assert LAUNCHES[ops.NAME] == before
