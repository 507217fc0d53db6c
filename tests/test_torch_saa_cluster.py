"""The SAA family's two variants: the one-launch thread-block-cluster
kernels and the chains (three launches for the server step, two for the
deviation partials) (``repro_torch.kernels.staleness_agg``).

On the CPU: which variant each shape takes (``ops.variant``), the tagged
launch keys, that a forced variant runs the same plain version as the
default and counts no launch, and that every entry point still rejects bad
operands and never falls back off the CPU.  Kernel 5's CUDA route, with
torch's CUDA bindings and the C entry points stood in for: the entry point
each chunk count takes, the launch keys, no partials scratch on the
cluster route, and the cluster's own errors raised with no fall back to
the chain.  On the card (``cuda`` marker): each cluster kernel equals its
chain bit for bit.
"""
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.staleness_agg import ops, ref

torch.set_num_threads(1)

MAIN_D = 14336            # the mlp on speech, padded to the 2048-column block
BLK = ops.D_BLK


def _operands(s, n, d, seed=0):
    """Seeded CPU operands of one server step over S cells: (params, U,
    fresh, tau, valid, scal) with half the rows fresh, the last row of
    each cell padding."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((s, n, d)).astype(np.float32)
    params = rng.standard_normal((s, d)).astype(np.float32)
    fresh = np.zeros((s, n), bool)
    fresh[:, :max(1, n // 2)] = True
    valid = np.ones((s, n), bool)
    if n > 2:
        valid[:, -1] = False
        u[:, -1] = 0.0
    tau = np.where(fresh, 0, rng.integers(1, 6, (s, n))).astype(np.int32)
    scal = np.stack([rng.uniform(0.1, 0.5, s), rng.uniform(0.5, 1.5, s)],
                    axis=1).astype(np.float32)
    return [torch.tensor(a) for a in (params, u, fresh, tau, valid, scal)]


def _calls(s=2, n=4, d=BLK):
    """One valid CPU call per entry point: {kernel: (fn, args, kwargs, index
    of U in args)}."""
    p, u, fresh, tau, valid, scal = _operands(s, n, d)
    beta = scal[:, 0].contiguous()
    return {
        "sweep_fused_staleness_apply": (
            ops.sweep_fused_staleness_apply, (p, u, fresh, tau, valid, scal), {}, 1),
        "sweep_fused_staleness_aggregate": (
            ops.sweep_fused_staleness_aggregate, (u, fresh, tau, beta, valid), {}, 0),
        "fused_staleness_aggregate": (
            ops.fused_staleness_aggregate, (u[0], fresh[0], tau[0], 0.3),
            {"valid": valid[0]}, 0),
        "fused_staleness_apply": (
            ops.fused_staleness_apply, (p[0], u[0], fresh[0], tau[0], 0.3, 1.0),
            {"valid": valid[0]}, 1),
        "deviation_partials": (ops.deviation_partials, (u[0], fresh[0]), {}, 0),
        "weighted_aggregate": (ops.weighted_aggregate,
                               (torch.full((n,), 1.0 / n), u[0]), {}, 1),
    }


def _clone(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


def _run(kernel, **extra):
    """One fresh CPU call of ``kernel`` (params cloned: the apply updates
    them in place)."""
    fn, args, kw, _ = _calls()[kernel]
    return fn(*map(_clone, args), **kw, **extra)


# ---------------------------------------------------------------------------
# Which variant a shape takes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s, n, d, want", [
    (1, 10, MAIN_D, "cluster"),         # the main shape: 7 chunks
    (3, 10, MAIN_D, "cluster"),         # S cells: one cluster each
    (1, 16, MAIN_D, "cluster"),
    (1, 1, BLK, "cluster"),             # one chunk: a cluster of one block
    (1, 10, 8 * BLK, "cluster"),        # the 8/9-chunk edge: 8 blocks of one
    (1, 10, 9 * BLK, "cluster"),        # chunk, then 5 blocks of two
    (1, 10, 16 * BLK, "cluster"),       # 8 blocks of two chunks
    (1, 10, 17 * BLK, "chain"),         # three chunks a block: the chain
    (1, 28, MAIN_D, "cluster"),         # the last n whose U fits in shared memory
    (1, 29, MAIN_D, "cluster"),         # U read from L2: still one launch
    (1, 30, MAIN_D, "cluster"),
    (1, ops.MAX_N, MAIN_D, "cluster"),
    (1, 10, ops.CLUSTER_MAX_CHUNKS * BLK, "cluster"),   # the threshold
    (1, 10, (ops.CLUSTER_MAX_CHUNKS + 1) * BLK, "chain"),
    (1, 64, 1 << 20, "chain"),          # the large shape: 512 chunks
])
def test_variant_by_shape(s, n, d, want):
    assert ops.variant(s, n, d) == want


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 10, 12, 16, 20, 30, 64])
def test_main_path_shapes_take_the_cluster(n):
    """Every participant count at the model's padded width takes the
    cluster kernel, whatever S."""
    for s in (1, 3):
        assert ops.variant(s, n, MAIN_D) == "cluster"


def test_variant_threshold_is_monotone():
    """The cluster up to the threshold, the chain from there on."""
    got = [ops.variant(1, 10, c * BLK) for c in range(1, 513)]
    k = ops.CLUSTER_MAX_CHUNKS
    assert got == ["cluster"] * k + ["chain"] * (512 - k)


# ---------------------------------------------------------------------------
# Launch keys, forced variants, checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("v", ops.VARIANTS)
@pytest.mark.parametrize("kernel", ops.FUSED)
def test_launch_keys(kernel, v):
    assert ops.launch_key(kernel, v) == f"{kernel}:{v}"


def test_fused_names():
    assert ops.FUSED == ("sweep_fused_staleness_apply",
                         "sweep_fused_staleness_aggregate",
                         "fused_staleness_aggregate", "fused_staleness_apply")
    assert ops.VARIANTS == ("cluster", "chain")


@pytest.mark.parametrize("v", ops.VARIANTS + (None,))
@pytest.mark.parametrize("kernel", ops.FUSED)
def test_forced_variant_on_cpu_is_the_plain_version(kernel, v):
    """On the CPU a forced variant runs the plain version, bit for bit the
    default call's, and counts no launch under any key."""
    before = Counter(LAUNCHES)
    got = _run(kernel, variant=v)
    want = _run(kernel)
    assert Counter(LAUNCHES) == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kernel", ops.FUSED)
def test_bad_variant_raises(kernel):
    with pytest.raises(ValueError, match="variant"):
        _run(kernel, variant="bogus")


@pytest.mark.parametrize("kernel", ops.FUSED)
def test_forced_variant_never_falls_back(kernel):
    """A forced variant on a device without a kernel raises, as the
    default does."""
    fn, args, kw, _ = _calls()[kernel]
    meta = lambda a: a.to("meta") if isinstance(a, torch.Tensor) else a
    for v in ops.VARIANTS:
        with pytest.raises(ValueError, match="no kernel"):
            fn(*map(meta, args), **{k: meta(x) for k, x in kw.items()}, variant=v)


def test_sweep_apply_matches_its_plain_version():
    """Kernel 1's wrapper on CPU tensors is its plain version, in place."""
    p, u, fresh, tau, valid, scal = _operands(3, 7, 2 * BLK, seed=4)
    p_k, p_r = p.clone(), p.clone()
    out, w = ops.sweep_fused_staleness_apply(p_k, u, fresh, tau, valid, scal)
    _, w_r = ref.sweep_fused_staleness_apply(p_r, u, fresh, tau, valid, scal)
    assert out.data_ptr() == p_k.data_ptr()
    assert torch.equal(p_k, p_r) and torch.equal(w, w_r)


# ---------------------------------------------------------------------------
# Every entry point still checks its operands and never falls back
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ops.NAMES)
def test_cpu_call_counts_no_launch(kernel):
    before = Counter(LAUNCHES)
    _run(kernel)
    assert Counter(LAUNCHES) == before


@pytest.mark.parametrize("kernel", ops.NAMES)
def test_meta_device_raises(kernel):
    fn, args, kw, _ = _calls()[kernel]
    meta = lambda a: a.to("meta") if isinstance(a, torch.Tensor) else a
    with pytest.raises(ValueError, match="no kernel"):
        fn(*map(meta, args), **{k: meta(x) for k, x in kw.items()})


@pytest.mark.parametrize("kernel", ops.NAMES)
def test_several_devices_raise(kernel):
    fn, args, kw, _ = _calls()[kernel]
    with pytest.raises(ValueError, match="several devices"):
        fn(args[0].to("meta"), *args[1:], **kw)


@pytest.mark.parametrize("kernel", ops.NAMES)
def test_wrong_dtype_raises(kernel):
    fn, args, kw, u_at = _calls()[kernel]
    bad = list(args)
    bad[u_at] = bad[u_at].double()
    with pytest.raises(ValueError, match="expected"):
        fn(*bad, **kw)


@pytest.mark.parametrize("kernel", ops.NAMES)
def test_d_off_the_block_raises(kernel):
    """D not a multiple of 2048, all operands cut alike."""
    s, n, d = 2, 4, BLK + 512
    fn, args, kw, _ = _calls(s, n, d)[kernel]
    with pytest.raises(ValueError, match="D % 2048"):
        fn(*args, **kw)


@pytest.mark.parametrize("kernel", ops.NAMES)
def test_too_many_rows_raise(kernel):
    fn, args, kw, _ = _calls(2, ops.MAX_N + 1, BLK)[kernel]
    with pytest.raises(ValueError, match="n <="):
        fn(*args, **kw)


@pytest.mark.parametrize("kernel", ops.NAMES)
def test_non_contiguous_raises(kernel):
    fn, args, kw, u_at = _calls()[kernel]
    bad = list(args)
    u = bad[u_at]
    bad[u_at] = torch.cat([u, u], dim=-1)[..., ::2]    # same shape, strided
    with pytest.raises(ValueError, match="contiguous"):
        fn(*bad, **kw)


# ---------------------------------------------------------------------------
# Kernel 5 (deviation_partials): the cluster kernel or the two-launch chain
# ---------------------------------------------------------------------------

PARTIAL_ENTRIES = {"cluster": "saa_cluster_deviation_partials",
                   "chain": "saa_deviation_partials"}


class _Entry:
    """A C entry point stand-in: logs its name and arguments, returns
    ``err``."""

    def __init__(self, name, log, err=0):
        self.name, self.log, self.err = name, log, err
        self.fn = self

    def __call__(self, *args):
        self.log.append((self.name, args))
        return self.err


@pytest.fixture
def card_route(monkeypatch):
    """Kernel 5's CUDA route on a CPU-only build: every plan names CUDA
    device 0, the two calls ``launch`` makes into torch's CUDA bindings
    return device 0 and stream 1234, both C entry points log their calls,
    and the chain's scratch allocation is logged.  Returns the log and a
    setter of the entry points' return code."""
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 1234,
                        raising=False)
    monkeypatch.setattr(ops, "_cuda_device",
                        lambda device, *rows: torch.device("cuda", 0))
    monkeypatch.setattr(ops._plan_partials, "seen", {})
    log = {"entries": [], "scratch": []}

    def returning(err):
        for name in PARTIAL_ENTRIES.values():
            monkeypatch.setitem(ops._ENTRIES, name, _Entry(name, log["entries"], err))
    returning(0)

    def scratch(s, n, d, device):
        log["scratch"].append((s, n, d))
        return (torch.empty((s, d // BLK, n)), torch.empty((s, d // BLK)))
    monkeypatch.setattr(ops, "_scratch", scratch)
    return log, returning


def _partials(n, chunks, **kw):
    u = torch.zeros((n, chunks * BLK))
    fresh = torch.arange(n) < max(1, n // 2)
    return ops.deviation_partials(u, fresh, **kw)


@pytest.mark.parametrize("chunks", [1, 2, 7, 8, 9, 15, 16, 17, 24, 64, 512])
@pytest.mark.parametrize("n", [1, 2, 29, 64])
def test_partials_route_by_chunks(card_route, n, chunks):
    """Up to 16 chunks one launch of the cluster entry point with only the
    two outputs (no scratch); beyond, the chain's entry point with its
    scratch.  Each call counts one launch under the kernel and its
    variant."""
    log, _ = card_route
    want = "cluster" if chunks <= ops.CLUSTER_MAX_CHUNKS else "chain"
    assert ops.variant(1, n, chunks * BLK) == want
    before = Counter(LAUNCHES)
    num, den = _partials(n, chunks)
    assert (num.shape, den.shape) == ((n,), ())
    assert Counter(LAUNCHES) - before == Counter(
        {ops.PARTIALS: 1, ops.launch_key(ops.PARTIALS, want): 1})
    (name, args), = log["entries"]
    assert name == PARTIAL_ENTRIES[want]
    assert args[-3:] == (n, chunks * BLK, 1234)          # n, D, the stream
    assert len(args) == {"cluster": 7, "chain": 9}[want]  # pointers, ints, stream
    assert args[2:4] == (num.data_ptr(), den.data_ptr())
    assert log["scratch"] == ([] if want == "cluster" else [(1, n, chunks * BLK)])
    for key in (ops.PARTIALS, ops.launch_key(ops.PARTIALS, want)):
        LAUNCHES[key] -= 1


@pytest.mark.parametrize("v", ops.VARIANTS)
def test_partials_forced_variant(card_route, v):
    """A forced variant takes its own entry point at any chunk count."""
    log, _ = card_route
    before = Counter(LAUNCHES)
    for chunks in (1, 7, 17, 64):
        _partials(10, chunks, variant=v)
    assert [name for name, _ in log["entries"]] == [PARTIAL_ENTRIES[v]] * 4
    assert len(log["scratch"]) == (4 if v == "chain" else 0)
    got = Counter(LAUNCHES) - before
    assert got == Counter({ops.PARTIALS: 4, ops.launch_key(ops.PARTIALS, v): 4})
    for key in got:
        LAUNCHES[key] -= 4


@pytest.mark.parametrize("err, why", [(-1, "cannot schedule the thread block cluster"),
                                      (-2, "too large for the cluster kernel")])
def test_partials_cluster_errors_raise_without_fall_back(card_route, err, why):
    """The cluster entry point's own errors raise with their messages and
    count nothing; the chain is never tried in their place."""
    log, returning = card_route
    returning(err)
    before = Counter(LAUNCHES)
    for _ in range(2):                 # the memoised plan raises again too
        with pytest.raises(RuntimeError, match=rf"error {err}: .*{why}"):
            _partials(10, 7)
    assert Counter(LAUNCHES) == before
    assert [name for name, _ in log["entries"]] == [PARTIAL_ENTRIES["cluster"]] * 2
    assert log["scratch"] == []


def test_partials_cuda_error_raises(card_route):
    log, returning = card_route
    returning(700)
    with pytest.raises(RuntimeError, match="error 700$"):
        _partials(4, 20)
    assert [name for name, _ in log["entries"]] == [PARTIAL_ENTRIES["chain"]]


@pytest.mark.parametrize("v", ops.VARIANTS + (None,))
def test_partials_forced_variant_on_cpu_is_the_plain_version(v):
    _, u, fresh, _, _, _ = _operands(1, 6, 3 * BLK, seed=3)
    before = Counter(LAUNCHES)
    got = ops.deviation_partials(u[0], fresh[0], variant=v)
    want = ref.deviation_partials(u[0], fresh[0])
    assert Counter(LAUNCHES) == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_partials_bad_variant_raises():
    _, u, fresh, _, _, _ = _operands(1, 4, BLK)
    with pytest.raises(ValueError, match="variant"):
        ops.deviation_partials(u[0], fresh[0], variant="bogus")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_cluster_equals_chain_bitwise():
    """On the card: the cluster kernel == the three-launch chain bit for
    bit (weights, aggregates, params in place) at the main shape, S > 1,
    U read from L2 (n = 30) and two chunks a block (9 chunks); each launch
    counted under its variant."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for s, n, d in ((1, 10, MAIN_D), (3, 16, MAIN_D), (1, 30, MAIN_D),
                    (2, 10, 9 * BLK)):
        p, u, fresh, tau, valid, scal = [t.cuda() for t in _operands(s, n, d, 7)]
        beta = scal[:, 0].contiguous()
        out = {}
        for v in ops.VARIANTS:
            before = Counter(LAUNCHES)
            p_v = p.clone()
            _, w_a = ops.sweep_fused_staleness_apply(p_v, u, fresh, tau, valid,
                                                     scal, variant=v)
            agg, w_g = ops.sweep_fused_staleness_aggregate(u, fresh, tau, beta,
                                                           valid, variant=v)
            torch.cuda.synchronize()
            assert Counter(LAUNCHES) - before == Counter({
                ops.NAME: 1, ops.launch_key(ops.NAME, v): 1,
                ops.FUSED[1]: 1, ops.launch_key(ops.FUSED[1], v): 1})
            out[v] = (w_a, p_v, agg, w_g)
        for a, b in zip(out["cluster"], out["chain"]):
            assert torch.equal(a, b)
        agg_r, w_r = ref.sweep_fused_staleness_aggregate(u, fresh, tau, beta, valid)
        torch.testing.assert_close(out["cluster"][2], agg_r, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(out["cluster"][3], w_r, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_cuda_partials_cluster_equals_chain_bitwise():
    """On the card: kernel 5's cluster kernel == its two-launch chain bit
    for bit (int32 views) at every chunk count from 1 to 16, and past the
    rows the server step's cluster stages; each launch counted under its
    variant."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for n in (1, 2, 10, 29, 64):
        for chunks in range(1, ops.CLUSTER_MAX_CHUNKS + 1):
            _, u, fresh, *_ = [t.cuda() for t in _operands(1, n, chunks * BLK, n)]
            before = Counter(LAUNCHES)
            got = {v: ops.deviation_partials(u[0], fresh[0], variant=v)
                   for v in ops.VARIANTS}
            torch.cuda.synchronize()
            assert Counter(LAUNCHES) - before == Counter(
                {ops.PARTIALS: 2, **{ops.launch_key(ops.PARTIALS, v): 1
                                     for v in ops.VARIANTS}})
            for a, b in zip(got["cluster"], got["chain"]):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
