"""The trimmed-mean kernel's plain version (``repro_torch.kernels.
trimmed_agg``) against the JAX Pallas kernel ``sweep_trimmed_aggregate`` in
interpret mode, on the cases of ``tests/test_trimmed_agg_kernel.py``: mixed
per-cell trim depths and valid counts, ``+inf`` exclusion rows, feature
widths off the TPU kernel's 2048-column block, ties, even and odd median bands, degenerate cells; and the wrapper's checks.

Tolerance rtol 1e-5 / atol 1e-6, as the JAX package holds its kernel to its
sort oracle: the Pallas kernel sums the band in row order, the plain
version in sorted order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.trimmed_agg import ops as jops
from repro.kernels.trimmed_agg.ref import sweep_trimmed_ref
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.trimmed_agg import ops, ref

torch.set_num_threads(1)

D_BLK = 2048          # the Pallas kernel's feature-axis block
TOL = dict(rtol=1e-5, atol=1e-6)


def _operand(rng, s, n, d, c):
    """Rows past c are the +inf exclusion rows the robust layer emits."""
    y = rng.normal(size=(s, n, d)).astype(np.float32)
    for i, ci in enumerate(c):
        y[i, ci:] = np.inf
    return y


def _both(y, k, c):
    """(port wrapper on the CPU, JAX Pallas kernel in interpret mode)."""
    k, c = np.asarray(k, np.int32), np.asarray(c, np.int32)
    got = ops.sweep_trimmed_aggregate(torch.from_numpy(y), torch.from_numpy(k),
                                      torch.from_numpy(c))
    want = jops.sweep_trimmed_aggregate(jnp.asarray(y), jnp.asarray(k),
                                        jnp.asarray(c), interpret=True)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("n,d", [(2, D_BLK), (6, D_BLK), (9, 2 * D_BLK),
                                 (16, D_BLK), (64, D_BLK)])
def test_plain_matches_pallas_mixed_k_and_c(n, d):
    rng = np.random.default_rng(n * d)
    c = np.array([n, n - 1, max(n - 3, 1), 2, 1], np.int32)
    k = np.array([0, 1 if n > 2 else 0, (int(c[2]) - 1) // 2, 0, 0], np.int32)
    y = _operand(rng, len(c), n, d, c)
    got, want = _both(y, k, c)
    np.testing.assert_allclose(got, want, **TOL)
    # and the JAX package's own sort oracle
    np.testing.assert_allclose(got, np.asarray(sweep_trimmed_ref(
        jnp.asarray(y), jnp.asarray(k), jnp.asarray(c))), **TOL)


@pytest.mark.parametrize("d", [D_BLK + 37, 2 * D_BLK + 37, 100])
def test_wrapper_takes_any_feature_width(d):
    """The port launches on the true D; the JAX wrapper pads D to its
    block and slices back: the same band means."""
    rng = np.random.default_rng(7)
    s, n = 3, 8
    c = np.array([8, 5, 3], np.int32)
    k = np.array([2, 1, 1], np.int32)
    y = _operand(rng, s, n, d, c)
    got, want = _both(y, k, c)
    assert got.shape == (s, d)
    np.testing.assert_allclose(got, want, **TOL)


def test_tie_ranks_agree_with_stable_sort():
    """Duplicated values make the rank's row-index tie-break matter."""
    n, d = 6, D_BLK
    y = np.ones((1, n, d), np.float32)
    y[0, 3] = 2.0
    y[0, 4] = 0.0
    y[0, :, :7] = -0.0                    # signed zeros tie with each other
    got, want = _both(y, [1], [n])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_all_equal_columns_give_the_value():
    y = np.full((2, 7, D_BLK), 0.25, np.float32)
    got, want = _both(y, [2, 0], [7, 5])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, 0.25)


@pytest.mark.parametrize("c_val", [9, 10])
def test_median_band_even_and_odd(c_val):
    """Maximal trim k = (c-1)//2 is the coordinate median (even c averages
    the middle pair)."""
    rng = np.random.default_rng(1)
    n, d = 10, D_BLK
    c = np.array([c_val], np.int32)
    k = (c - 1) // 2
    y = _operand(rng, 1, n, d, c)
    got, want = _both(y, k, c)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[0], np.median(y[0, :c_val].astype(np.float64),
                                                 axis=0), **TOL)


def test_degenerate_cells():
    """c = 0 gives zeros (the denominator floor); c = 1 passes its row."""
    n, d = 4, D_BLK
    y = np.full((2, n, d), np.inf, np.float32)
    y[1, 0] = 3.0
    got, want = _both(y, [0, 0], [0, 1])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], 0.0)
    np.testing.assert_array_equal(got[1], 3.0)


def test_plain_version_is_the_sort_formula_per_cell():
    """``ref.trimmed_from_sorted`` on one cell's sorted rows equals the
    sweep's row for that cell, bit for bit."""
    rng = np.random.default_rng(3)
    c = np.array([9, 6], np.int32)
    k = np.array([3, 1], np.int32)
    y = torch.from_numpy(_operand(rng, 2, 9, D_BLK, c))
    out = ref.sweep_trimmed_aggregate(y, torch.from_numpy(k), torch.from_numpy(c))
    for i in range(2):
        ys = torch.sort(y[i], dim=0, stable=True).values
        assert torch.equal(out[i], ref.trimmed_from_sorted(ys, int(c[i]),
                                                           int(k[i])))


def _cpu_operands():
    y = torch.zeros((2, 3, D_BLK))
    return y, torch.zeros(2, dtype=torch.int32), torch.full((2,), 3,
                                                             dtype=torch.int32)


@pytest.mark.parametrize("field,bad", [
    (0, lambda t: t[0]),
    (0, lambda t: t.double()),
    (1, lambda t: t.long()),
    (2, lambda t: t[:1]),
])
def test_wrapper_rejects_bad_operands(field, bad):
    args = list(_cpu_operands())
    args[field] = bad(args[field])
    with pytest.raises(ValueError):
        ops.sweep_trimmed_aggregate(*args)


def test_wrapper_never_falls_back_off_the_cpu():
    """A tensor on a device without a kernel (here ``meta``) raises instead
    of running the plain version; a CPU call counts no launch."""
    args = _cpu_operands()
    before = LAUNCHES[ops.NAME]
    ops.sweep_trimmed_aggregate(*args)
    assert LAUNCHES[ops.NAME] == before
    with pytest.raises(ValueError, match="no kernel"):
        ops.sweep_trimmed_aggregate(*[a.to("meta") for a in args])
    with pytest.raises(ValueError, match="several devices"):
        ops.sweep_trimmed_aggregate(args[0].to("meta"), *args[1:])


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """On the card: the CUDA kernel == the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(5)
    c = np.array([9, 8, 1], np.int32)
    k = np.array([4, 1, 0], np.int32)
    y = torch.from_numpy(_operand(rng, 3, 9, 2 * D_BLK + 37, c)).cuda()
    kt, ct = torch.from_numpy(k).cuda(), torch.from_numpy(c).cuda()
    before = LAUNCHES[ops.NAME]
    got = ops.sweep_trimmed_aggregate(y, kt, ct)
    torch.cuda.synchronize()
    assert LAUNCHES[ops.NAME] == before + 1
    torch.testing.assert_close(got, ref.sweep_trimmed_aggregate(y, kt, ct),
                               **TOL)
