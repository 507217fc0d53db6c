"""Mamba (``repro_torch.models.mamba``) against the reference's functions.

At d_model 64 (d_inner 128, 16 states, dt rank 4, conv width 4), weights
from the reference's ``mamba_init`` carried with
``weights.from_jax_tree``: ``mamba_forward`` in fp32 from no state and
from a carried one, at S = 1, 3 (shorter than the conv), 200, 256 (one
scan chunk) and 512 (the reference's chunked, rematerialized branch; the
port's two chunks), output and final state; 40 ``mamba_decode`` steps;
in the port, one forward == the same tokens in pieces with the state
carried; bf16 by relative L2; and the init's fp32 leaves in a bf16 model.
Tolerance rtol = atol = 1e-4 in fp32 (the scan sums in the same order;
matrix products and exponentials differ in rounding)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jmb
from repro_torch.models import mamba as mb
from repro_torch.weights import from_jax_tree

torch.set_num_threads(1)

D_MODEL = 64
DIMS = dict(d_state=16, expand=2, conv_width=4)
TOL = dict(rtol=1e-4, atol=1e-4)


def _params(dtype):
    jp = jmb.mamba_init(jax.random.PRNGKey(5), D_MODEL, dtype=dtype, **DIMS)
    return jp, from_jax_tree(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def params():
    return _params(jnp.float32)


def _x(B, S, seed):
    return np.random.default_rng(seed).standard_normal((B, S, D_MODEL)).astype(np.float32)


def _state(B, seed):
    rng = np.random.default_rng(seed)
    return {"conv": rng.standard_normal((B, 3, 128)).astype(np.float32),
            "ssm": 0.5 * rng.standard_normal((B, 128, 16)).astype(np.float32)}


def _both(state):
    if state is None:
        return None, None
    return ({k: jnp.asarray(v) for k, v in state.items()},
            {k: torch.from_numpy(v) for k, v in state.items()})


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("S", [1, 3, 200, 256, 512])
def test_mamba_forward_matches_reference(params, S, carried):
    jp, tp = params
    x = _x(2, S, S)
    sj, st = _both(_state(2, S + 1) if carried else None)
    oj, nj = jmb.mamba_forward(jp, jnp.asarray(x), state=sj, **DIMS)
    ot, nt = mb.mamba_forward(tp, torch.from_numpy(x), state=st, **DIMS)
    assert ot.shape == (2, S, D_MODEL)
    assert nt["conv"].shape == (2, 3, 128) and nt["ssm"].dtype == torch.float32
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(nt[k].numpy(), np.asarray(nj[k]), err_msg=k, **TOL)


def test_mamba_decode_steps_match_reference(params):
    """40 single-token steps from a zero state: each output and the final
    state."""
    jp, tp = params
    B = 3
    xs = _x(B, 40, 9)
    sj = {"conv": jnp.zeros((B, 3, 128)), "ssm": jnp.zeros((B, 128, 16))}
    st = {"conv": torch.zeros((B, 3, 128)), "ssm": torch.zeros((B, 128, 16))}
    for t in range(40):
        oj, sj = jmb.mamba_decode(jp, jnp.asarray(xs[:, t:t + 1]), sj, **DIMS)
        ot, st = mb.mamba_decode(tp, torch.from_numpy(xs[:, t:t + 1]), st, **DIMS)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), err_msg=f"step {t}", **TOL)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("cut", [1, 2, 100, 256, 300])
def test_mamba_pieces_equal_one_forward(params, cut):
    """Tokens [0, cut) then [cut, 400) with the state carried give one
    forward's outputs and final state."""
    _, tp = params
    x = torch.from_numpy(_x(2, 400, 10))
    whole, s_whole = mb.mamba_forward(tp, x, **DIMS)
    a, s_a = mb.mamba_forward(tp, x[:, :cut], **DIMS)
    b, s_b = mb.mamba_forward(tp, x[:, cut:], state=s_a, **DIMS)
    torch.testing.assert_close(torch.cat([a, b], dim=1), whole, rtol=1e-5, atol=1e-5)
    for k in s_whole:
        torch.testing.assert_close(s_b[k], s_whole[k], rtol=1e-5, atol=1e-5)


def test_mamba_bf16_matches_reference():
    """bf16 weights and activations (the scan in fp32): relative L2 within
    2e-2 of the reference's bf16 output (the conv and gate round at other
    places in the two frameworks)."""
    jp, tp = _params(jnp.bfloat16)
    x = _x(2, 200, 12)
    oj, _ = jmb.mamba_forward(jp, jnp.asarray(x, jnp.bfloat16), **DIMS)
    ot, st = mb.mamba_forward(tp, torch.from_numpy(x).to(torch.bfloat16), **DIMS)
    assert ot.dtype == torch.bfloat16 and st["ssm"].dtype == torch.float32
    oj, ot = np.asarray(oj, np.float32), ot.float().numpy()
    assert np.linalg.norm(ot - oj) / np.linalg.norm(oj) <= 2e-2


def test_mamba_init_matches_reference_tree():
    """The reference's keys, shapes and dtypes: ``A_log``, ``dt_bias`` and
    ``D`` fp32 inside a bf16 block; ``dt_rank`` = d_model // 16; the
    constants exactly."""
    jp, _ = _params(jnp.bfloat16)
    tp = mb.mamba_init(torch.Generator().manual_seed(0), D_MODEL, dtype=torch.bfloat16,
                       **DIMS)
    assert sorted(tp) == sorted(jp)
    for k, w in jp.items():
        assert tuple(tp[k].shape) == w.shape, k
        assert str(tp[k].dtype).removeprefix("torch.") == str(w.dtype), k
    assert tp["w_dt"].shape == (D_MODEL // 16, 128)
    for k in ("A_log", "dt_bias", "D", "conv_b"):
        np.testing.assert_allclose(tp[k].float().numpy(), np.asarray(jp[k], np.float32),
                                   rtol=1e-6, err_msg=k)
