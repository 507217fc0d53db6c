"""The port's SAA math and the plain version of its SAA kernel, held against
the JAX reference on the CPU.

The reference kernel ``sweep_fused_staleness_apply`` runs in Pallas
interpret mode, as ``tests/test_kernels.py`` runs it; the port's side is
``repro_torch.kernels.staleness_agg.ref`` (what the wrapper runs for CPU
tensors, and what ``chip_smoke.py`` holds the CUDA kernel against on the
card).  Tolerances are those of ``tests/test_kernels.py``: weights rtol
1e-5 / atol 1e-6, parameters and aggregates rtol 1e-4 / atol 1e-5 (fp32
sums taken in other orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import staleness as jst
from repro.kernels.staleness_agg.staleness_agg import \
    sweep_fused_staleness_apply as jax_sweep_apply
from repro_torch.core import aggregation as tagg
from repro_torch.core import staleness as tst
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.staleness_agg import ops, ref

torch.set_num_threads(1)

W_TOL = dict(rtol=1e-5, atol=1e-6)
P_TOL = dict(rtol=1e-4, atol=1e-5)
RULES = ("equal", "dynsgd", "adasgd", "relay")
CASES = ("mixed", "padding", "no_stale", "no_fresh", "all_invalid")


def _operands(s, n, d, case, seed):
    """numpy operands for one SAA step; ``case`` picks the masks."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((s, n, d)).astype(np.float32)
    params = rng.standard_normal((s, d)).astype(np.float32)
    fresh = np.zeros((s, n), bool)
    valid = np.ones((s, n), bool)
    if case in ("mixed", "padding", "all_invalid"):
        fresh[:, :n // 2] = True
    elif case == "no_stale":
        fresh[:] = True
    if case == "padding":
        valid[:, -2:] = False
        u[~valid] = 0.0                  # padding rows are exact zeros
    if case == "all_invalid":
        valid[-1] = False
    tau = np.where(fresh, 0, rng.integers(1, 6, (s, n))).astype(np.int32)
    scal = np.stack([rng.uniform(0.1, 0.5, s), rng.uniform(0.5, 1.5, s)],
                    axis=1).astype(np.float32)
    return params, u, fresh, tau, valid, scal


def _torch(*arrays):
    """Copies: the port updates params in place, and JAX may still read a
    numpy buffer it shares (asynchronous dispatch)."""
    return [torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("s,n,d", [(1, 6, 2 * 2048), (3, 7, 3 * 2048)])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("rule", RULES)
def test_plain_kernel_matches_jax_kernel(rule, case, s, n, d):
    params, u, fresh, tau, valid, scal = _operands(s, n, d, case, seed=s * n + d)
    p_jax, w_jax = jax_sweep_apply(jnp.asarray(params), jnp.asarray(u),
                                   jnp.asarray(fresh), jnp.asarray(tau),
                                   jnp.asarray(valid), jnp.asarray(scal),
                                   rule=rule, interpret=True)
    p_jax, w_jax = np.asarray(p_jax), np.asarray(w_jax)
    tp, tu, tf, tt, tv, ts = _torch(params, u, fresh, tau, valid, scal)
    ptr = tp.data_ptr()
    p_out, w = ops.sweep_fused_staleness_apply(tp, tu, tf, tt, tv, ts, rule=rule)
    assert p_out.data_ptr() == ptr                     # updated in place
    np.testing.assert_allclose(w.numpy(), np.asarray(w_jax), **W_TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(p_jax), **P_TOL)
    if case == "all_invalid":
        np.testing.assert_array_equal(w.numpy()[-1], 0.0)
        np.testing.assert_array_equal(tp.numpy()[-1], params[-1])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("rule", RULES)
def test_core_staleness_weights_match_jax(rule, case):
    _, u, fresh, tau, valid, scal = _operands(2, 9, 300, case, seed=17)
    beta = float(scal[0, 0])
    for c in range(2):
        w_jax = jst.staleness_weights(jnp.asarray(u[c]), jnp.asarray(fresh[c]),
                                      jnp.asarray(tau[c]), rule=rule, beta=beta,
                                      valid=jnp.asarray(valid[c]))
        tu, tf, tt, tv = _torch(u[c], fresh[c], tau[c], valid[c])
        w = tst.staleness_weights(tu, tf, tt, rule=rule, beta=beta, valid=tv)
        np.testing.assert_allclose(w.numpy(), np.asarray(w_jax), **W_TOL)
        agg_j, w_j = jagg.weights_and_aggregate_by_id(
            jnp.asarray(u[c]), jnp.asarray(fresh[c]), jnp.asarray(tau[c]),
            jnp.asarray(valid[c]), beta, jst.RULE_ID[rule])
        agg_t, w_t = tagg.weights_and_aggregate_by_id(tu, tf, tt, tv, beta,
                                                      tst.RULE_ID[rule])
        np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), **W_TOL)
        np.testing.assert_allclose(agg_t.numpy(), np.asarray(agg_j), **P_TOL)


def test_deviation_scores_and_rule_table_match_jax():
    assert tst.RULE_ORDER == jst.RULE_ORDER and tst.EPS == jst.EPS
    rng = np.random.default_rng(3)
    u = rng.standard_normal((8, 500)).astype(np.float32)
    fresh = np.array([1, 1, 1, 0, 0, 0, 0, 1], bool)
    lam_j = jst.deviation_scores(jnp.asarray(u), jnp.asarray(fresh))
    lam_t = tst.deviation_scores(*_torch(u, fresh))
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j), rtol=1e-5)
    np.testing.assert_allclose(
        tst.fresh_average(*_torch(u, fresh)).numpy(),
        np.asarray(jst.fresh_average(jnp.asarray(u), jnp.asarray(fresh))),
        rtol=1e-5, atol=1e-6)


def test_plain_partials_match_jax_kernel_semantics():
    """n_f = max(sum fresh, 1) enters the mixed update (no fresh rows here),
    matching the Pallas kernel's ``_deviation_increments``."""
    from repro.kernels.staleness_agg.staleness_agg import _deviation_increments
    rng = np.random.default_rng(5)
    u = rng.standard_normal((1, 5, 2048)).astype(np.float32)
    for fr in (np.zeros((1, 5), bool), np.array([[1, 0, 1, 0, 0]], bool)):
        num_j, den_j = _deviation_increments(
            jnp.asarray(u[0]), jnp.asarray(fr[0].astype(np.float32))[:, None])
        num_t, den_t = ref.deviation_partials(*_torch(u, fr))
        np.testing.assert_allclose(num_t.numpy()[0], np.asarray(num_j)[:, 0],
                                   rtol=1e-5)
        np.testing.assert_allclose(den_t.numpy()[0], np.asarray(den_j)[0, 0],
                                   rtol=1e-5, atol=1e-12)


def _cpu_operands():
    return _torch(*_operands(2, 4, 2048, "mixed", seed=0))


@pytest.mark.parametrize("field,bad", [
    ("params", lambda t: t.double()),
    ("updates", lambda t: t[:, :, :1024]),
    ("fresh", lambda t: t.to(torch.uint8)),
    ("tau", lambda t: t.long()),
    ("valid", lambda t: t[:, :3]),
    ("scal", lambda t: t.t().contiguous().t()),
])
def test_wrapper_rejects_bad_operands(field, bad):
    ops_ = dict(zip(("params", "updates", "fresh", "tau", "valid", "scal"),
                    _cpu_operands()))
    ops_[field] = bad(ops_[field])
    with pytest.raises(ValueError):
        ops.sweep_fused_staleness_apply(*ops_.values())


def test_wrapper_never_falls_back_off_the_cpu():
    """A tensor on a device without a kernel (here ``meta``) raises instead
    of running the plain version; a CPU call counts no launch."""
    args = _cpu_operands()
    before = LAUNCHES[ops.NAME]
    ops.sweep_fused_staleness_apply(*args)
    assert LAUNCHES[ops.NAME] == before
    with pytest.raises(ValueError, match="no kernel"):
        ops.sweep_fused_staleness_apply(*[a.to("meta") for a in args])
    with pytest.raises(ValueError, match="several devices"):
        ops.sweep_fused_staleness_apply(args[0].to("meta"), *args[1:])
    with pytest.raises(ValueError, match="rule"):
        ops.sweep_fused_staleness_apply(*args, rule="bogus")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """On the card: the CUDA kernel == the plain version, in place."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for rule in RULES:
        for case in CASES:
            args = [t.cuda() for t in _torch(*_operands(3, 7, 3 * 2048, case, 1))]
            p_ref = args[0].clone()
            ptr = args[0].data_ptr()
            _, w = ops.sweep_fused_staleness_apply(*args, rule=rule)
            _, w_ref = ref.sweep_fused_staleness_apply(p_ref, *args[1:], rule=rule)
            torch.cuda.synchronize()
            assert args[0].data_ptr() == ptr
            torch.testing.assert_close(w, w_ref, **W_TOL)
            torch.testing.assert_close(args[0], p_ref, **P_TOL)
