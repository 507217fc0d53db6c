"""MLA (``repro_torch.models.attention.mla_*``) against the reference's
functions, and deepseek-v2-lite's absorbed decode inside the whole model.

At d_model 64, 4 heads, latent rank 32, q/k head dims 16 (nope) + 8
(rope) against v's 16, fp32, weights from the reference's ``mla_init``
carried with ``weights.from_jax_tree``: ``mla_forward`` (full causal and
a 16-token window, S off every block) and its compressed cache;
``mla_decode`` naive and absorbed, 12 steps from a prefilled cache of 8
slots (the ring buffer wraps), each step's output and cache; absorbed ==
naive in the port.  Tolerance rtol = atol = 1e-4 (fp32 sums in other
orders).  Then deepseek-v2-lite's REDUCED config with ``mla_absorb=True``
against the reference, as ``tests/_zoo_parity.py`` sets out."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _zoo_parity as zoo
from repro.models import attention as jattn
from repro_torch.models import attention as attn
from repro_torch.weights import from_jax_tree

torch.set_num_threads(1)

D_MODEL = 64
DIMS = dict(n_heads=4, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
ROPE = 1e4
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def params():
    jp = jattn.mla_init(jax.random.PRNGKey(3), D_MODEL, dtype=jnp.float32, **DIMS)
    return jp, from_jax_tree(jax.tree.map(np.asarray, jp))


def _x(B, S, seed):
    return np.random.default_rng(seed).standard_normal((B, S, D_MODEL)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mla_init_matches_reference_tree(params):
    jp, _ = params
    tp = attn.mla_init(torch.Generator().manual_seed(0), D_MODEL, dtype=torch.bfloat16,
                       **DIMS)
    assert sorted(tp) == sorted(jp)
    for k, w in jp.items():
        assert tuple(tp[k].shape) == w.shape and tp[k].dtype == torch.bfloat16, k


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("S", [1, 33, 100])
def test_mla_forward_matches_reference(params, S, window):
    jp, tp = params
    x = _x(2, S, S)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    oj, (cj, kj) = jattn.mla_forward(jp, jnp.asarray(x), jnp.asarray(pos), rope_theta=ROPE,
                                     window=window, **DIMS)
    ot, (ct, kt) = attn.mla_forward(tp, torch.from_numpy(x), torch.from_numpy(pos.copy()),
                                    rope_theta=ROPE, window=window, **DIMS)
    assert ot.shape == (2, S, D_MODEL) and ct.shape == (2, S, 32) and kt.shape == (2, S, 8)
    _close(ot, oj)
    _close(ct, cj)
    _close(kt, kj)


def _cache(jp, B, L, Sc):
    """A ring cache of Sc slots holding the reference's compressed kv of an
    L-token prompt (slot p % Sc for position p), as numpy arrays."""
    x = _x(B, L, 100)
    pos = np.broadcast_to(np.arange(L, dtype=np.int32), (B, L))
    _, (c, k) = jattn.mla_forward(jp, jnp.asarray(x), jnp.asarray(pos), rope_theta=ROPE,
                                  **DIMS)
    cache = {"c_kv": np.zeros((B, Sc, 32), np.float32),
             "k_rope": np.zeros((B, Sc, 8), np.float32),
             "pos": np.full((B, Sc), -1, np.int32)}
    for p in range(L):
        cache["c_kv"][:, p % Sc] = np.asarray(c[:, p])
        cache["k_rope"][:, p % Sc] = np.asarray(k[:, p])
        cache["pos"][:, p % Sc] = p
    return cache


@pytest.mark.parametrize("absorbed", [False, True])
@pytest.mark.parametrize("window", [None, 8])
def test_mla_decode_matches_reference(params, absorbed, window):
    """12 steps after a 5-token prompt in an 8-slot ring: each step's output
    and the whole cache."""
    jp, tp = params
    B, L, Sc = 3, 5, 8
    cache = _cache(jp, B, L, Sc)
    cj = {k: jnp.asarray(v) for k, v in cache.items()}
    ct = {k: torch.from_numpy(v) for k, v in cache.items()}
    xs = _x(B, 12, 7)
    for t in range(12):
        position = np.full((B,), L + t, np.int32)
        position[0] += t            # rows at other positions
        oj, cj = jattn.mla_decode(jp, jnp.asarray(xs[:, t:t + 1]), jnp.asarray(position), cj,
                                  rope_theta=ROPE, window=window, absorbed=absorbed, **DIMS)
        given, before = ct, {k: v.clone() for k, v in ct.items()}
        ot, ct = attn.mla_decode(tp, torch.from_numpy(xs[:, t:t + 1]),
                                 torch.from_numpy(position), ct, rope_theta=ROPE,
                                 window=window, absorbed=absorbed, **DIMS)
        assert all(torch.equal(before[k], given[k]) for k in given)   # left as it was
        _close(ot, oj)
        for k in ct:
            np.testing.assert_allclose(ct[k].numpy(), np.asarray(cj[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("window", [None, 8])
def test_mla_absorbed_equals_naive(params, window):
    """Folding w_uk into the query and w_uv into the output changes no value
    beyond fp32 rounding; the absorbed path's output keeps x's dtype."""
    _, tp = params
    B, L, Sc = 2, 6, 8
    cache = {k: torch.from_numpy(v) for k, v in _cache(params[0], B, L, Sc).items()}
    x = torch.from_numpy(_x(B, 1, 8))
    position = torch.full((B,), L, dtype=torch.int32)
    kw = dict(rope_theta=ROPE, window=window, **DIMS)
    naive, c1 = attn.mla_decode(tp, x, position, cache, absorbed=False, **kw)
    absorbed, c2 = attn.mla_decode(tp, x, position, cache, absorbed=True, **kw)
    torch.testing.assert_close(absorbed, naive, **TOL)
    assert absorbed.dtype == x.dtype
    assert all(torch.equal(c1[k], c2[k]) for k in c1)


@pytest.fixture(scope="module")
def absorbed_model():
    return zoo.model("deepseek-v2-lite-16b", mla_absorb=True)


def test_absorbed_model_decode_steps_match_reference(absorbed_model):
    zoo.check_decode_steps(absorbed_model)


def test_absorbed_model_greedy_generate_matches_reference(absorbed_model):
    zoo.check_greedy(absorbed_model)


def test_absorbed_model_prefill_equals_decode_in_port(absorbed_model):
    zoo.check_prefill_equals_decode(absorbed_model)
