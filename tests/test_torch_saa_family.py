"""The rest of the SAA kernel family — ``sweep_fused_staleness_aggregate``,
``fused_staleness_aggregate``, ``fused_staleness_apply``,
``deviation_partials`` and ``weighted_aggregate`` — through the port's
wrappers on CPU tensors (their plain versions), held against the Pallas
kernels in interpret mode; the host entry points against the JAX package's;
and the YoGi server step against the reference's.

Tolerances are those of ``tests/test_kernels.py``: weights rtol 1e-5 / atol
1e-6, aggregates, partials and parameters rtol 1e-4 / atol 1e-5 (fp32 sums
taken in other orders).  Where two port routes share their arithmetic the
test asks for equal bits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.kernels.staleness_agg import ops as jops
from repro.kernels.staleness_agg import staleness_agg as jk
from repro_torch.core import aggregation as tagg
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.staleness_agg import ops, ref

torch.set_num_threads(1)

W_TOL = dict(rtol=1e-5, atol=1e-6)
P_TOL = dict(rtol=1e-4, atol=1e-5)
RULES = ("equal", "dynsgd", "adasgd", "relay")
CASES = ("mixed", "padding", "no_stale", "no_fresh", "all_invalid")


def _operands(s, n, d, case, seed):
    """numpy operands of one SAA step; ``case`` picks the masks."""
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
    beta = rng.uniform(0.1, 0.5, s).astype(np.float32)
    lr = rng.uniform(0.5, 1.5, s).astype(np.float32)
    return params, u, fresh, tau, valid, beta, lr


def _t(*arrays):
    """torch copies (the port may update params in place)."""
    return [torch.tensor(a) for a in arrays]


def _np(*tensors):
    return [np.asarray(t) for t in tensors]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("rule", RULES)
def test_sweep_fused_aggregate_matches_pallas(rule, case):
    _, u, fresh, tau, valid, beta, _ = _operands(3, 7, 2 * 2048, case, seed=11)
    agg_j, w_j = _np(*jk.sweep_fused_staleness_aggregate(
        jnp.asarray(u), jnp.asarray(fresh), jnp.asarray(tau),
        jnp.asarray(beta), jnp.asarray(valid), rule=rule, interpret=True))
    agg, w = ops.sweep_fused_staleness_aggregate(*_t(u, fresh, tau, beta, valid),
                                                 rule=rule)
    np.testing.assert_allclose(w.numpy(), w_j, **W_TOL)
    np.testing.assert_allclose(agg.numpy(), agg_j, **P_TOL)
    if case == "all_invalid":
        assert not w[-1].any() and not agg[-1].any()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("rule", RULES)
def test_single_cell_aggregate_and_apply_match_pallas(rule, case):
    """Kernels 3 and 4 (one cell, ``valid`` masking bucket rows)."""
    p, u, fresh, tau, valid, beta, lr = _operands(1, 6, 2048, case, seed=5)
    p, u, fresh, tau, valid = p[0], u[0], fresh[0], tau[0], valid[0]
    b, l = float(beta[0]), float(lr[0])
    agg_j, w_j = _np(*jk.fused_staleness_aggregate(
        jnp.asarray(u), jnp.asarray(fresh), jnp.asarray(tau), b, rule=rule,
        interpret=True, valid=jnp.asarray(valid)))
    tu, tf, tt, tv = _t(u, fresh, tau, valid)
    agg, w = ops.fused_staleness_aggregate(tu, tf, tt, b, rule=rule, valid=tv)
    np.testing.assert_allclose(w.numpy(), w_j, **W_TOL)
    np.testing.assert_allclose(agg.numpy(), agg_j, **P_TOL)

    p_j, w_aj = _np(*jk.fused_staleness_apply(
        jnp.asarray(p), jnp.asarray(u), jnp.asarray(fresh), jnp.asarray(tau),
        b, l, rule=rule, interpret=True, valid=jnp.asarray(valid)))
    tp = torch.tensor(p)
    ptr = tp.data_ptr()
    out, w_a = ops.fused_staleness_apply(tp, tu, tf, tt, b, l, rule=rule,
                                         valid=tv)
    assert out.data_ptr() == ptr                       # updated in place
    np.testing.assert_allclose(w_a.numpy(), w_aj, **W_TOL)
    np.testing.assert_allclose(tp.numpy(), p_j, **P_TOL)
    # one plain function behind both: the apply is the aggregate, applied
    assert torch.equal(w_a, w)
    assert torch.equal(tp, torch.tensor(p) + torch.tensor(np.float32(l)) * agg)
    if case == "all_invalid":
        np.testing.assert_array_equal(tp.numpy(), p)


@pytest.mark.parametrize("case", CASES)
def test_deviation_partials_match_pallas(case):
    _, u, fresh, *_ = _operands(1, 7, 3 * 2048, case, seed=9)
    num_j, den_j = _np(*jk.deviation_partials(jnp.asarray(u[0]),
                                              jnp.asarray(fresh[0]),
                                              interpret=True))
    num, den = ops.deviation_partials(*_t(u[0], fresh[0]))
    assert num.shape == (7,) and den.shape == ()
    np.testing.assert_allclose(num.numpy(), num_j, **P_TOL)
    np.testing.assert_allclose(den.numpy(), den_j, **P_TOL)


@pytest.mark.parametrize("case", CASES)
def test_weighted_aggregate_matches_pallas(case):
    _, u, fresh, tau, valid, beta, _ = _operands(1, 7, 2 * 2048, case, seed=3)
    w = np.where(valid[0], np.random.default_rng(4).random(7), 0.0)
    w = (w / max(w.sum(), 1e-12)).astype(np.float32)
    out_j = np.asarray(jk.weighted_aggregate(jnp.asarray(w), jnp.asarray(u[0]),
                                             interpret=True))
    out = ops.weighted_aggregate(*_t(w, u[0]))
    np.testing.assert_allclose(out.numpy(), out_j, **P_TOL)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("n,d", [(2, 2048), (5, 2048), (8, 4096 + 77), (3, 1000)])
@pytest.mark.parametrize("rule", RULES)
def test_staleness_aggregate_matches_jax_ops(rule, n, d, fused):
    """The host entry point at any D, both the fused kernel and the
    two-launch A/B path, against the JAX package's."""
    rng = np.random.default_rng(n * d)
    u = rng.standard_normal((n, d)).astype(np.float32)
    fresh = np.array([True] + list(rng.random(n - 1) < 0.5))
    tau = np.where(fresh, 0, rng.integers(1, 6, n)).astype(np.int32)
    agg_j, w_j = _np(*jops.staleness_aggregate(
        jnp.asarray(u), jnp.asarray(fresh), jnp.asarray(tau), rule=rule,
        fused=fused, interpret=True))
    agg, w = ops.staleness_aggregate(*_t(u, fresh, tau), rule=rule,
                                     fused=fused)
    assert agg.shape == (d,) and w.shape == (n,)
    np.testing.assert_allclose(w.numpy(), w_j, **W_TOL)
    np.testing.assert_allclose(agg.numpy(), agg_j, **P_TOL)


def test_staleness_apply_matches_jax_ops():
    rng = np.random.default_rng(42)
    n, d = 6, 4096 + 33
    u = rng.standard_normal((n, d)).astype(np.float32)
    p0 = rng.standard_normal(d).astype(np.float32)
    fresh = np.array([True, True, True, False, False, False])
    tau = np.array([0, 0, 0, 2, 3, 5], np.int32)
    tp = torch.tensor(p0)
    p, w = ops.staleness_apply(tp, *_t(u, fresh, tau), rule="relay",
                               server_lr=0.5)
    assert torch.equal(tp, torch.tensor(p0))          # the caller's row is kept
    # the port runs the exact rows; the reference's result is the same
    # with or without its participant-axis bucketing
    for bucketed in (True, False):
        p_j, w_j = _np(*jops.staleness_apply(
            jnp.asarray(p0), jnp.asarray(u), jnp.asarray(fresh),
            jnp.asarray(tau), rule="relay", server_lr=0.5, interpret=True,
            bucketed=bucketed))
        np.testing.assert_allclose(w.numpy(), w_j, **W_TOL)
        np.testing.assert_allclose(p.numpy(), p_j, **P_TOL)


@pytest.mark.parametrize("rule", ["equal", "relay"])
def test_sweep_staleness_apply_is_params_plus_lr_aggregate(rule):
    """As ``tests/test_kernels.py`` holds the Pallas pair: the sweep server
    step == the sweep aggregate applied with per-cell lr, bit for bit, and
    an all-invalid cell keeps its bits; both against the JAX entry points."""
    rng = np.random.default_rng(7)
    s, n, d = 3, 6, 4096 + 33
    u = rng.standard_normal((s, n, d)).astype(np.float32)
    params = rng.standard_normal((s, d)).astype(np.float32)
    fresh = rng.random((s, n)) < 0.5
    fresh[:, 0] = True
    tau = np.where(fresh, 0, rng.integers(1, 5, (s, n))).astype(np.int32)
    valid = np.ones((s, n), bool)
    valid[2] = False                                   # all-invalid cell
    beta = np.array([0.2, 0.35, 0.5], np.float32)
    lr = np.array([1.0, 0.5, 2.0], np.float32)
    agg, w_k = ops.sweep_staleness_aggregate(*_t(u, fresh, tau), valid=valid,
                                             rule=rule, beta=beta)
    new_p, w_a = ops.sweep_staleness_apply(*_t(params, u, fresh, tau),
                                           valid=valid, rule=rule, beta=beta,
                                           server_lr=lr)
    assert torch.equal(w_a, w_k)
    assert torch.equal(new_p, torch.tensor(params)
                       + torch.tensor(lr)[:, None] * agg)
    np.testing.assert_array_equal(new_p[2].numpy(), params[2])
    agg_j, w_j = _np(*jops.sweep_staleness_aggregate(
        u, fresh, tau, valid=valid, rule=rule, beta=beta, interpret=True))
    p_j, _ = _np(*jops.sweep_staleness_apply(
        params, u, fresh, tau, valid=valid, rule=rule, beta=beta,
        server_lr=lr, interpret=True))
    np.testing.assert_allclose(w_k.numpy(), w_j, **W_TOL)
    np.testing.assert_allclose(agg.numpy(), agg_j, **P_TOL)
    np.testing.assert_allclose(new_p.numpy(), p_j, **P_TOL)


@pytest.mark.parametrize("lane_block", [0, 2048])
def test_bucket_pad_matches_reference(lane_block):
    """The port pads only D; the reference without its row bucketing."""
    rng = np.random.default_rng(1)
    u = rng.standard_normal((5, 3000)).astype(np.float32)
    fresh = np.array([1, 0, 1, 0, 0], bool)
    tau = np.array([0, 2, 0, 1, 4], np.int32)
    want = jagg.bucket_pad(u, fresh, tau, bucketed=False,
                           lane_block=lane_block)
    got = tagg.bucket_pad(*_t(u, fresh, tau), lane_block=lane_block)
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(np.asarray(w)).dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("rule", RULES)
def test_stale_synchronous_aggregate_flat_matches_reference(rule, use_kernel):
    rng = np.random.default_rng(8)
    u = rng.standard_normal((7, 3000)).astype(np.float32)
    fresh = np.array([1, 1, 1, 0, 0, 0, 0], bool)
    tau = np.array([0, 0, 0, 1, 2, 3, 5], np.int32)
    agg_j, w_j = _np(*jagg.stale_synchronous_aggregate_flat(
        u, fresh, tau, rule=rule, beta=0.3, use_kernel=use_kernel))
    agg, w = tagg.stale_synchronous_aggregate_flat(
        *_t(u, fresh, tau), rule=rule, beta=0.3, use_kernel=use_kernel)
    np.testing.assert_allclose(w.numpy(), w_j, **W_TOL)
    np.testing.assert_allclose(agg.numpy(), agg_j, **P_TOL)


def test_no_stale_shortcut_weights_equal_general_weights():
    """The fused pipeline's no-stale shortcut (fresh rows weigh 1, then
    normalise) gives the general Eq. 2 path's weight bits, so the two
    substrates agree bitwise whichever each takes."""
    rng = np.random.default_rng(2)
    for n in (1, 3, 7, 10):
        u = torch.tensor(rng.standard_normal((n, 500)).astype(np.float32))
        fresh = torch.ones(n, dtype=torch.bool)
        tau = torch.zeros(n, dtype=torch.int32)
        for rule in RULES:
            agg, w = tagg.stale_synchronous_aggregate_flat(u, fresh, tau,
                                                           rule=rule)
            w_s = fresh.to(torch.float32)
            w_s = w_s / torch.clamp(w_s.sum(), min=1e-12)
            assert torch.equal(w, w_s)
            assert torch.equal(agg, tagg.aggregate_updates(u, w_s))


def test_yogi_matches_reference():
    """Ten YoGi steps from the reference's init on the same deltas.  Each
    step starts from the reference's state, so the comparison is per step;
    an element whose ``sign(v - d^2)`` flips between the two (float noise
    where v ~ d^2) must lie within the tolerance of the tie."""
    rng = np.random.default_rng(0)
    d = 2000
    st_j = jagg.yogi_init_flat(d)
    st_t = tagg.yogi_init_flat(d)
    for k in ("m", "v", "t"):
        np.testing.assert_array_equal(st_t[k].numpy(), np.asarray(st_j[k]))
    p = rng.standard_normal(d).astype(np.float32)
    flips = 0
    for _ in range(10):
        delta = (rng.standard_normal(d) * 1e-2).astype(np.float32)
        st_np = {k: np.asarray(v) for k, v in st_j.items()}
        p_j, st_j = jagg.yogi_apply_flat(jnp.asarray(p), jnp.asarray(delta),
                                         st_j)
        p_t, st_t = tagg.yogi_apply_flat(
            torch.tensor(p), torch.tensor(delta),
            {k: torch.tensor(v) for k, v in st_np.items()})
        d2 = delta.astype(np.float64) ** 2
        tie = np.abs(st_np["v"] - d2) <= 1e-4 * d2 + 1e-12
        flip = ~np.isclose(st_t["v"].numpy(), np.asarray(st_j["v"]), rtol=1e-5,
                           atol=1e-12)
        assert not (flip & ~tie).any()
        flips += int(flip.sum())
        ok = ~flip
        np.testing.assert_allclose(st_t["m"].numpy(), np.asarray(st_j["m"]),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(st_t["v"].numpy()[ok],
                                   np.asarray(st_j["v"])[ok], rtol=1e-5,
                                   atol=1e-12)
        np.testing.assert_allclose(p_t.numpy()[ok], np.asarray(p_j)[ok],
                                   rtol=1e-4, atol=1e-6)
        assert int(st_t["t"]) == int(st_j["t"])
        p = np.asarray(p_j)
    assert flips == 0          # none on these inputs; the rule is for runs


def test_yogi_pad_columns_stay_zero():
    st = tagg.yogi_init_flat(5, width=8)
    assert st["v"][:5].eq(1e-6).all() and not st["v"][5:].any()
    p = torch.zeros(8)
    p[:5] = 1.0
    for _ in range(3):
        delta = torch.zeros(8)
        delta[:5] = torch.randn(5)
        p, st = tagg.yogi_apply_flat(p, delta, st)
        assert not p[5:].any() and not st["m"][5:].any() and not st["v"][5:].any()


# ---------------------------------------------------------------------------
# Wrapper checks
# ---------------------------------------------------------------------------


def _cpu_calls():
    """One valid CPU call per wrapper: {kernel name: (fn, args, kwargs)}."""
    p, u, fresh, tau, valid, beta, lr = _t(*_operands(2, 4, 2048, "mixed", 0))
    return {
        "sweep_fused_staleness_aggregate": (
            ops.sweep_fused_staleness_aggregate, (u, fresh, tau, beta, valid), {}),
        "fused_staleness_aggregate": (
            ops.fused_staleness_aggregate, (u[0], fresh[0], tau[0], 0.3),
            {"valid": valid[0]}),
        "fused_staleness_apply": (
            ops.fused_staleness_apply, (p[0], u[0], fresh[0], tau[0], 0.3, 1.0),
            {"valid": valid[0]}),
        "deviation_partials": (ops.deviation_partials, (u[0], fresh[0]), {}),
        "weighted_aggregate": (ops.weighted_aggregate,
                               (torch.full((4,), 0.25), u[0]), {}),
    }


@pytest.mark.parametrize("kernel", ops.NAMES[1:])
def test_new_wrappers_check_and_never_fall_back(kernel):
    """Each wrapper runs its plain version on the CPU without counting a
    launch, raises for a device without a kernel and for operands on
    several devices, and rejects a wrong type, shape or D."""
    fn, args, kw = _cpu_calls()[kernel]
    before = LAUNCHES[kernel]
    fn(*args, **kw)
    assert LAUNCHES[kernel] == before
    meta = lambda a: a.to("meta") if isinstance(a, torch.Tensor) else a
    with pytest.raises(ValueError, match="no kernel"):
        fn(*map(meta, args), **{k: meta(v) for k, v in kw.items()})
    with pytest.raises(ValueError, match="several devices"):
        fn(meta(args[0]), *args[1:], **kw)
    with pytest.raises(ValueError):
        fn(args[0].double(), *args[1:], **kw)
    u_arg = 1 if kernel in ("fused_staleness_apply", "weighted_aggregate") else 0
    short = list(args)
    short[u_arg] = short[u_arg][..., :1024].contiguous()
    with pytest.raises(ValueError):
        fn(*short, **kw)
    if kernel not in ("deviation_partials", "weighted_aggregate"):
        with pytest.raises(ValueError, match="rule"):
            fn(*args, rule="bogus", **kw)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """On the card: kernels 2-6 == their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for rule in RULES:
        for case in CASES:
            p, u, fresh, tau, valid, beta, lr = [
                t.cuda() for t in _t(*_operands(3, 7, 3 * 2048, case, 1))]
            agg, w = ops.sweep_fused_staleness_aggregate(u, fresh, tau, beta,
                                                         valid, rule=rule)
            agg_r, w_r = ref.sweep_fused_staleness_aggregate(
                u, fresh, tau, beta, valid, rule=rule)
            torch.testing.assert_close(w, w_r, **W_TOL)
            torch.testing.assert_close(agg, agg_r, **P_TOL)
            agg1, w1 = ops.fused_staleness_aggregate(u[0], fresh[0], tau[0],
                                                     0.3, rule=rule,
                                                     valid=valid[0])
            p_k = p[0].clone()
            _, w2 = ops.fused_staleness_apply(p_k, u[0], fresh[0], tau[0], 0.3,
                                              1.0, rule=rule, valid=valid[0])
            assert torch.equal(w1, w2)
            assert torch.equal(p_k, p[0] + 1.0 * agg1)
    num, den = ops.deviation_partials(u[0], fresh[0])
    num_r, den_r = ref.deviation_partials(u[0], fresh[0])
    torch.testing.assert_close(num, num_r, **P_TOL)
    torch.testing.assert_close(den, den_r, **P_TOL)
    torch.testing.assert_close(ops.weighted_aggregate(w_r[0], u[0]),
                               ref.weighted_aggregate(w_r[0], u[0]), **P_TOL)
