"""The WKV6 kernel's wrappers and plain version (``repro_torch.kernels.
wkv6``) against the JAX Pallas kernel ``wkv6`` in interpret mode, on
``tests/test_kernels.py``'s shapes (head sizes 8 to 64, S off the 128
chunk) and around the CUDA kernel's 32-step chunk (S = 31, 33), with an
initial state, a state carried from one call into the next, S = 1 (a
decode step), bf16 r / k / v, the TPU kernel layout (``wkv6_bhsn``), and
the wrappers' checks.

Tolerance rtol 1e-4 / atol 1e-5: the two sum the fp32 recurrence in other
orders (the reference's own tolerance for its kernel against its scan).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6 import ops as jops
from repro.kernels.wkv6.wkv6 import wkv6_bhsn as j_bhsn
from repro.models.rwkv6 import wkv6_scan as j_scan
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.wkv6 import ops, ref

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
SHAPES = [(2, 128, 2, 16), (1, 200, 3, 32), (2, 256, 1, 64), (1, 384, 4, 8),
          (2, 31, 2, 64), (1, 33, 3, 8)]     # around the CUDA kernel's 32-step chunk


def _operands(B, S, H, N, seed):
    """r, k, v, w (B, S, H, N), u (H, N), s0 (B, H, N, N) as numpy fp32."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, N)).astype(np.float32) * 0.5
               for _ in range(3))
    w = rng.uniform(0.8, 0.999, (B, S, H, N)).astype(np.float32)
    u = rng.standard_normal((H, N)).astype(np.float32) * 0.1
    s0 = rng.standard_normal((B, H, N, N)).astype(np.float32) * 0.1
    return r, k, v, w, u, s0


def _t(*arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


def _j(*arrs):
    return [None if a is None else jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("B,S,H,N", SHAPES)
@pytest.mark.parametrize("with_s0", [True, False])
@pytest.mark.parametrize("fn", ["ops", "ref"])
def test_port_matches_pallas(B, S, H, N, with_s0, fn):
    r, k, v, w, u, s0 = _operands(B, S, H, N, B * S)
    s0 = s0 if with_s0 else None
    y_k, s_k = jops.wkv6(*_j(r, k, v, w, u), state0=None if s0 is None else jnp.asarray(s0))
    port = ops.wkv6 if fn == "ops" else ref.wkv6_scan
    y, s = port(*_t(r, k, v, w, u), state0=None if s0 is None else torch.from_numpy(s0))
    assert y.shape == (B, S, H, N) and s.shape == (B, H, N, N)
    assert s.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_k), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_k), **TOL)


@pytest.mark.parametrize("split", [1, 77, 128])
def test_state_continuation(split):
    """Two calls with the first's final state carried into the second equal
    one call over the whole sequence, and the reference's scan."""
    r, k, v, w, u, s0 = _operands(2, 200, 3, 16, split)
    rt, kt, vt, wt, ut, s0t = _t(r, k, v, w, u, s0)
    y_all, s_all = ops.wkv6(rt, kt, vt, wt, ut, state0=s0t)
    y1, s1 = ops.wkv6(rt[:, :split], kt[:, :split], vt[:, :split], wt[:, :split],
                      ut, state0=s0t)
    y2, s2 = ops.wkv6(rt[:, split:], kt[:, split:], vt[:, split:], wt[:, split:],
                      ut, state0=s1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y_all, **TOL)
    torch.testing.assert_close(s2, s_all, **TOL)
    y_r, s_r = j_scan(*_j(r, k, v, w, u), state0=jnp.asarray(s0))
    np.testing.assert_allclose(y_all.numpy(), np.asarray(y_r), **TOL)
    np.testing.assert_allclose(s2.numpy(), np.asarray(s_r), **TOL)


@pytest.mark.parametrize("N", [8, 16, 32, 64])
def test_single_step(N):
    """S = 1, the decode step: y_0 = r.(s0 + diag(u) k v^T), s1 = w s0 + k v^T."""
    r, k, v, w, u, s0 = _operands(3, 1, 2, N, N)
    y, s = ops.wkv6(*_t(r, k, v, w, u), state0=torch.from_numpy(s0))
    kv = k[:, 0, :, :, None] * v[:, 0, :, None, :]
    y_want = np.einsum("bhk,bhkv->bhv", r[:, 0], s0 + u[None, :, :, None] * kv)
    np.testing.assert_allclose(y[:, 0].numpy(), y_want, **TOL)
    np.testing.assert_allclose(s.numpy(), w[:, 0, :, :, None] * s0 + kv, **TOL)
    y_k, s_k = j_scan(*_j(r, k, v, w, u), state0=jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_k), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_k), **TOL)


def test_bf16_inputs():
    """bf16 r, k, v (fp32 w): y comes back in bf16, the state in fp32, both
    from the same fp32 recurrence as the reference's."""
    r, k, v, w, u, s0 = _operands(1, 130, 2, 32, 9)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    y, s = ops.wkv6(bf(r), bf(k), bf(v), *_t(w, u), state0=torch.from_numpy(s0))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    y_k, s_k = jops.wkv6(jb(r), jb(k), jb(v), *_j(w, u), state0=jnp.asarray(s0))
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_k, np.float32),
                               rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_k), **TOL)


@pytest.mark.parametrize("B,S,H,N", [(2, 128, 2, 16), (2, 256, 1, 64)])
def test_bhsn_layout_matches_pallas_kernel(B, S, H, N):
    """The TPU kernel's own layout: (B*H, S, N) rows, u (B*H, 1, N)."""
    r, k, v, w, u, s0 = _operands(B, S, H, N, 11)
    bh = lambda a: np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(B * H, S, N))
    r, k, v, w = bh(r), bh(k), bh(v), bh(w)
    u = np.ascontiguousarray(np.broadcast_to(u[None], (B, H, N)).reshape(B * H, 1, N))
    s0 = s0.reshape(B * H, N, N)
    y, s = ops.wkv6_bhsn(*_t(r, k, v, w, u, s0))
    y_k, s_k = j_bhsn(*_j(r, k, v, w, u, s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_k), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_k), **TOL)


def _cpu_operands():
    return _t(*_operands(1, 5, 2, 8, 0))


@pytest.mark.parametrize("field,bad", [
    (0, lambda t: t.double()),
    (1, lambda t: t.to(torch.bfloat16)),   # r, k, v dtypes differ
    (3, lambda t: t.to(torch.bfloat16)),   # w must be fp32
    (4, lambda t: t[:1]),                  # u (H, N)
    (5, lambda t: t[..., :4]),             # state0 (B, H, N, N)
    (2, lambda t: t[:, :4]),               # shapes differ
])
def test_wrapper_rejects_bad_operands(field, bad):
    args = _cpu_operands()
    args[field] = bad(args[field])
    with pytest.raises(ValueError):
        ops.wkv6(*args[:5], state0=args[5])


def test_wrapper_never_falls_back_off_the_cpu():
    """A tensor on a device without a kernel (here ``meta``) raises instead
    of running the plain version; a CPU call counts no launch."""
    args = _cpu_operands()
    before = LAUNCHES[ops.NAME]
    ops.wkv6(*args[:5], state0=args[5])
    assert LAUNCHES[ops.NAME] == before
    with pytest.raises(ValueError, match="no kernel"):
        ops.wkv6(*[a.to("meta") for a in args[:5]], state0=args[5].to("meta"))
    with pytest.raises(ValueError, match="several devices"):
        ops.wkv6(args[0].to("meta"), *args[1:5], state0=args[5])


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """On the card: the CUDA kernel == the plain version, both layouts."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for B, S, H, N in SHAPES + [(2, 1, 4, 64)]:
        r, k, v, w, u, s0 = (t.cuda() for t in _t(*_operands(B, S, H, N, 3)))
        before = LAUNCHES[ops.NAME]
        y, s = ops.wkv6(r, k, v, w, u, state0=s0)
        torch.cuda.synchronize()
        assert LAUNCHES[ops.NAME] == before + 1
        y_r, s_r = ref.wkv6_scan(r, k, v, w, u, state0=s0)
        torch.testing.assert_close(y, y_r, **TOL)
        torch.testing.assert_close(s, s_r, **TOL)
