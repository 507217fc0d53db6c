"""The trimmed-mean kernel's three variants (``repro_torch.kernels.
trimmed_agg``: ``regs``, ``sort``, ``rank``) and its row-order plain
version.

On the CPU: the row-order plain version (``ref.sweep_trimmed_aggregate_rows``,
the Pallas body's loop in torch) against the JAX Pallas kernel in interpret
mode, bit for bit (n >= 2; at n = 1 XLA folds the loop's one ``0 + y`` into
``y`` and keeps a -0.0 that IEEE addition makes +0.0, so there the two agree
as values), and against the sort formula within the weights' tolerance;
which variant each n takes; forced variants on CPU tensors run the sort
formula and count no launch; every variant keeps the operand checks and
never falls back off the CPU.  On the card (``cuda`` marker): every variant
equals the row-order plain version bit for bit.
"""
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.trimmed_agg import ops as jops
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.trimmed_agg import ops, ref

torch.set_num_threads(1)

D_BLK = 2048          # the Pallas kernel's feature-axis block
TOL = dict(rtol=1e-5, atol=1e-6)


def _case(kind, n, d, seed):
    """Seeded operands of three cells: y (3, n, d) with +inf rows past each
    cell's valid count, k_eff, c (3,) int32."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(3, n, d)).astype(np.float32)
    if kind == "ties":
        y = np.round(y * 2) / 2
    elif kind == "signed_zero":               # -0.0 and +0.0 tie; +-1, +-2
        y = np.round(y * 0.7).astype(np.float32)
        y[y == 0] = np.where(rng.random(int((y == 0).sum())) < 0.5, -0.0, 0.0)
    elif kind == "equal":
        y = np.repeat(y[:, :1], n, axis=1)
    if kind == "degenerate":
        c = [0, 1, n]
        k = [0, 0, (n - 1) // 2]
    else:
        c = [n, max(n - 1, 1), max(n - 3, 1)]
        k = [0, min(1, (c[1] - 1) // 2), (c[2] - 1) // 2]
    for i, ci in enumerate(c):
        y[i, ci:] = np.inf
    return y, np.asarray(k, np.int32), np.asarray(c, np.int32)


def _rows(y, k, c):
    return ref.sweep_trimmed_aggregate_rows(
        torch.from_numpy(y), torch.from_numpy(k), torch.from_numpy(c)).numpy()


def _pallas(y, k, c):
    return np.asarray(jops.sweep_trimmed_aggregate(
        jnp.asarray(y), jnp.asarray(k), jnp.asarray(c), interpret=True))


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


CASES = ("mixed", "ties", "signed_zero", "equal", "degenerate")


@pytest.mark.parametrize("kind", CASES)
@pytest.mark.parametrize("n", [2, 3, 9, 17, 33])
def test_rows_version_equals_pallas_bitwise(kind, n):
    y, k, c = _case(kind, n, D_BLK, seed=n)
    np.testing.assert_array_equal(_bits(_rows(y, k, c)), _bits(_pallas(y, k, c)))


@pytest.mark.parametrize("kind", CASES)
def test_rows_version_equals_pallas_at_one_row(kind):
    """n = 1: equal as values (XLA keeps -0.0 where IEEE adds give +0.0)."""
    y, k, c = _case(kind, 1, D_BLK, seed=1)
    np.testing.assert_array_equal(_rows(y, k, c), _pallas(y, k, c))


def test_signed_zeros_tie_by_row_index():
    """-0.0 and +0.0 compare equal: the band picks them by row index, so
    which zero lands in the band follows the rows, bit for bit."""
    y = np.zeros((1, 4, D_BLK), np.float32)
    y[0, 0] = -0.0
    y[0, 1] = 0.0
    y[0, 2] = 1.0
    y[0, 3] = -1.0
    k, c = np.array([1], np.int32), np.array([4], np.int32)
    got = _rows(y, k, c)
    np.testing.assert_array_equal(_bits(got), _bits(_pallas(y, k, c)))
    np.testing.assert_array_equal(got, 0.0)


@pytest.mark.parametrize("kind", CASES)
@pytest.mark.parametrize("n", [2, 9, 33, 64])
def test_rows_version_near_the_sort_formula(kind, n):
    """The row-order sum against the sorted-order sum: the weights'
    tolerance, as the JAX package holds its kernel to its sort oracle."""
    y, k, c = (torch.from_numpy(a) for a in _case(kind, n, D_BLK + 37, seed=3 * n))
    torch.testing.assert_close(ref.sweep_trimmed_aggregate_rows(y, k, c),
                               ref.sweep_trimmed_aggregate(y, k, c), **TOL)


@pytest.mark.parametrize("n, want", [
    (1, "regs"), (10, "regs"), (ops.REGS_MAX_N, "regs"),
    (ops.REGS_MAX_N + 1, "sort"), (32, "sort"), (33, "sort"), (64, "sort"),
    (256, "sort"), (ops.MAX_ROWS["sort"], "sort"),
    (ops.MAX_ROWS["sort"] + 1, "rank"), (4096, "rank"),
])
def test_variant_by_n(n, want):
    assert ops.variant(n) == want


def test_variant_threshold_is_monotone():
    got = [ops.variant(n) for n in range(1, 1100)]
    r, s = ops.REGS_MAX_N, ops.MAX_ROWS["sort"]
    assert got == ["regs"] * r + ["sort"] * (s - r) + ["rank"] * (1099 - s)


def _operands(n, d=D_BLK + 5, seed=0):
    y, k, c = _case("mixed", n, d, seed)
    return torch.from_numpy(y), torch.from_numpy(k), torch.from_numpy(c)


def _takes(v, n):
    return ops.MAX_ROWS[v] is None or n <= ops.MAX_ROWS[v]


@pytest.mark.parametrize("v, n", [(v, n) for v in ops.VARIANTS
                                  for n in (1, 9, 16, 40) if _takes(v, n)])
def test_forced_variant_on_cpu_is_the_sort_formula(v, n):
    """On CPU tensors any variant runs the plain sort formula and counts
    no launch."""
    y, k, c = _operands(n)
    before = Counter(LAUNCHES)
    got = ops.sweep_trimmed_aggregate(y, k, c, variant=v)
    assert Counter(LAUNCHES) == before
    assert torch.equal(got, ref.sweep_trimmed_aggregate(y, k, c))


@pytest.mark.parametrize("v, n", [("regs", ops.MAX_ROWS["regs"] + 1),
                                  ("sort", ops.MAX_ROWS["sort"] + 1)])
def test_forced_variant_past_its_rows_raises(v, n):
    y = torch.zeros((1, n, 8))
    k, c = torch.zeros(1, dtype=torch.int32), torch.full((1,), n, dtype=torch.int32)
    with pytest.raises(ValueError, match=f"variant '{v}' takes n <="):
        ops.sweep_trimmed_aggregate(y, k, c, variant=v)
    ops.sweep_trimmed_aggregate(y, k, c)          # the default takes any n


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="variant must be one of"):
        ops.sweep_trimmed_aggregate(*_operands(4), variant="bitonic")


@pytest.mark.parametrize("v", ops.VARIANTS)
def test_forced_variant_never_falls_back(v):
    """A tensor on a device without a kernel (here ``meta``) raises with
    any variant forced, as the default does."""
    args = _operands(4)
    with pytest.raises(ValueError, match="no kernel"):
        ops.sweep_trimmed_aggregate(*[a.to("meta") for a in args], variant=v)
    with pytest.raises(ValueError, match="several devices"):
        ops.sweep_trimmed_aggregate(args[0].to("meta"), *args[1:], variant=v)


@pytest.mark.parametrize("v", ops.VARIANTS)
@pytest.mark.parametrize("field, bad, match", [
    (0, lambda t: t[0], "y must be fp32"),
    (0, lambda t: t.double(), "y must be fp32"),
    (1, lambda t: t.long(), "k_eff: expected"),
    (2, lambda t: t[:1], "c: expected"),
])
def test_forced_variant_keeps_the_operand_checks(v, field, bad, match):
    args = list(_operands(4))
    args[field] = bad(args[field])
    with pytest.raises(ValueError, match=match):
        ops.sweep_trimmed_aggregate(*args, variant=v)


@pytest.mark.cuda
def test_cuda_every_variant_equals_the_row_order_version():
    """On the card: each variant that takes n, forced, == the row-order
    plain version bit for bit, around each variant's edges, with +-0.0
    ties; each launch counted under its variant."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for n in (1, 2, 15, 16, 17, 32, 33, 64, 65, 257):
        for kind in CASES:
            y, k, c = (t.cuda() for t in (torch.from_numpy(a) for a in
                                          _case(kind, n, 2 * D_BLK + 37, seed=n)))
            want = ref.sweep_trimmed_aggregate_rows(y, k, c)
            for v in ops.VARIANTS:
                if not _takes(v, n):
                    continue
                before = Counter(LAUNCHES)
                got = ops.sweep_trimmed_aggregate(y, k, c, variant=v)
                torch.cuda.synchronize()
                assert Counter(LAUNCHES) - before == Counter(
                    {ops.NAME: 1, f"{ops.NAME}:{v}": 1})
                assert torch.equal(got.view(torch.int32), want.view(torch.int32))
