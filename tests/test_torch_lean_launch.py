"""The lean checked launch (``repro_torch.kernels._launch``) that every
wrapper of the SAA family (kernels 1-6) and the trimmed mean (kernel 7)
goes through.

On the CPU: the memo's key holds each operand's shape, dtype, device,
contiguity and 16-byte alignment, so after a good call a call with any of
them changed is checked in full again and raises the same ``ValueError``
as on a first call; a failed check is never kept; CPU calls count no
launch however often the signature repeats; ``launch`` counts one launch
(and one of its variant) per call and none when the C call fails.  On the
card (``cuda`` marker): kernel 6's own launch equals the chain's
``saa_apply`` aggregate bit for bit, and a misaligned operand raises after
a cached good call.
"""
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.kernels import LAUNCHES, _launch
from repro_torch.kernels.staleness_agg import ops as saa
from repro_torch.kernels.trimmed_agg import ops as trim

torch.set_num_threads(1)

BLK = saa.D_BLK


def _saa_operands(s=2, n=4, d=BLK, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((s, n, d)).astype(np.float32)
    params = rng.standard_normal((s, d)).astype(np.float32)
    fresh = np.zeros((s, n), bool)
    fresh[:, :n // 2] = True
    valid = np.ones((s, n), bool)
    tau = np.where(fresh, 0, rng.integers(1, 6, (s, n))).astype(np.int32)
    scal = np.stack([rng.uniform(0.1, 0.5, s), rng.uniform(0.5, 1.5, s)],
                    axis=1).astype(np.float32)
    return [torch.tensor(a) for a in (params, u, fresh, tau, valid, scal)]


def _calls():
    """One good CPU call per wrapper of both families: {name: (fn, args,
    kwargs, index of the float row operand in args, its plan)}."""
    p, u, fresh, tau, valid, scal = _saa_operands()
    beta = scal[:, 0].contiguous()
    y = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 5, 300)).astype(np.float32))
    k, c = torch.tensor([1, 0], dtype=torch.int32), torch.tensor([5, 3], dtype=torch.int32)
    return {
        "sweep_fused_staleness_apply": (saa.sweep_fused_staleness_apply,
                                        (p, u, fresh, tau, valid, scal), {}, 1,
                                        saa._plan_sweep_apply),
        "sweep_fused_staleness_aggregate": (saa.sweep_fused_staleness_aggregate,
                                            (u, fresh, tau, beta, valid), {}, 0,
                                            saa._plan_sweep_aggregate),
        "fused_staleness_aggregate": (saa.fused_staleness_aggregate,
                                      (u[0], fresh[0], tau[0], 0.3),
                                      {"valid": valid[0]}, 0, saa._plan_cell_aggregate),
        "fused_staleness_apply": (saa.fused_staleness_apply,
                                  (p[0], u[0], fresh[0], tau[0], 0.3, 1.0),
                                  {"valid": valid[0]}, 1, saa._plan_cell_apply),
        "deviation_partials": (saa.deviation_partials, (u[0], fresh[0]), {}, 0,
                               saa._plan_partials),
        "weighted_aggregate": (saa.weighted_aggregate,
                               (torch.full((4,), 0.25), u[0]), {}, 1,
                               saa._plan_weighted),
        "sweep_trimmed_aggregate": (trim.sweep_trimmed_aggregate, (y, k, c), {}, 0,
                                    trim._plan),
    }


WRAPPERS = tuple(_calls())
SAA_WRAPPERS = WRAPPERS[:6]


def _good_call(name):
    fn, args, kw, at, plan = _calls()[name]
    args = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    fn(*args, **kw)
    return fn, args, kw, at, plan


def _with(args, at, new):
    out = list(args)
    out[at] = new
    return out


def _strided(t):
    """``t``'s values, same shape, not contiguous."""
    return torch.stack([t, t], dim=-1)[..., 0]


def _misaligned(t):
    """``t``'s values, contiguous, starting 4 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    out = flat[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def test_wrappers_cover_both_families():
    assert set(WRAPPERS) == set(saa.NAMES) | {trim.NAME}


@pytest.mark.parametrize("name", WRAPPERS)
@pytest.mark.parametrize("change, match", [
    ("shape", None), ("dtype", None), ("device", "no kernel|several devices"),
])
def test_changed_operand_after_a_good_call_raises(name, change, match):
    """A cached good call does not let a changed operand through: it raises
    the same ValueError as a first call would."""
    fn, args, kw, at, _ = _good_call(name)
    t = args[at]
    new = {"shape": t[..., :t.shape[-1] // 2 + 1].contiguous() if name != trim.NAME
           else t[0],
           "dtype": t.double(), "device": t.to("meta")}[change]
    bad = _with(args, at, new)
    for _ in range(2):                     # the failure is not cached either
        with pytest.raises(ValueError, match=match):
            fn(*bad, **kw)
    fn(*args, **kw)                        # the good signature still passes


@pytest.mark.parametrize("name", SAA_WRAPPERS)
def test_non_contiguous_after_a_good_call_raises(name):
    fn, args, kw, at, _ = _good_call(name)
    with pytest.raises(ValueError, match="contiguous"):
        fn(*_with(args, at, _strided(args[at])), **kw)


def test_trimmed_takes_a_non_contiguous_y_after_a_good_call():
    """The trimmed mean copies a strided y (its key differs, the full
    check passes it): the same result as the contiguous call."""
    fn, args, kw, at, _ = _good_call(trim.NAME)
    want = fn(*args, **kw)
    assert torch.equal(fn(*_with(args, at, _strided(args[at])), **kw), want)


@pytest.mark.parametrize("name", WRAPPERS)
@pytest.mark.parametrize("change", ["shape", "dtype", "device", "contiguity",
                                    "alignment"])
def test_each_changed_property_misses_the_memo(name, change):
    """Every property the checks read is in the key: a changed operand is
    checked in full (here counted on the memo's check, from an empty memo),
    a repeated one is not."""
    fn, args, kw, at, plan = _calls()[name]
    t = args[at]
    new = {"shape": t[:1], "dtype": t.double(), "device": t.to("meta"),
           "contiguity": _strided(t), "alignment": _misaligned(t)}[change]
    calls = Counter()
    check = plan.check

    def counted(*a):
        calls["check"] += 1
        return check(*a)
    plan.seen.clear()
    plan.check = counted
    try:
        for _ in range(2):
            fn(*[a.clone() if isinstance(a, torch.Tensor) else a for a in args], **kw)
        assert calls["check"] == 1
        try:
            fn(*_with(args, at, new), **kw)
        except ValueError:
            pass
        assert calls["check"] == 2
    finally:
        plan.check = check


@pytest.mark.parametrize("name", WRAPPERS)
def test_cpu_calls_count_no_launch_through_the_memo(name):
    fn, args, kw, _, _ = _good_call(name)
    before = Counter(LAUNCHES)
    for _ in range(3):
        fn(*[a.clone() if isinstance(a, torch.Tensor) else a for a in args], **kw)
    assert Counter(LAUNCHES) == before


@pytest.mark.parametrize("name", WRAPPERS)
def test_repeated_call_gives_the_same_result(name):
    """The memoised route runs the same plain version as the first call."""
    fn, args, kw, _, _ = _calls()[name]
    fresh = lambda: [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    first, second = fn(*fresh(), **kw), fn(*fresh(), **kw)
    first = first if isinstance(first, tuple) else (first,)
    second = second if isinstance(second, tuple) else (second,)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_signature_holds_each_property():
    t = torch.zeros((4, 8))
    base = _launch.signature((t,))
    for other in (t[:2], t.double(), t.to("meta"), _strided(t), _misaligned(t)):
        assert _launch.signature((other,)) != base
    assert _launch.signature((t.clone(),)) == base


def test_memo_keeps_only_passing_checks():
    calls = []

    def check(t, flag):
        calls.append(flag)
        if flag == "bad":
            raise ValueError("bad operand")
        return ("plan", flag)
    memo = _launch.Checked(check)
    t = torch.zeros(3)
    assert memo((t,), "ok") == ("plan", "ok")
    assert memo((t,), "ok") == ("plan", "ok")
    for _ in range(2):
        with pytest.raises(ValueError, match="bad operand"):
            memo((t,), "bad")
    assert calls == ["ok", "bad", "bad"]


def test_memo_starts_over_past_its_limit(monkeypatch):
    monkeypatch.setattr(_launch, "SEEN_LIMIT", 3)
    memo = _launch.Checked(lambda t: t.shape)
    for n in range(1, 8):
        memo((torch.zeros(n),))
        assert len(memo.seen) <= 3


class _FakeEntry:
    """A C entry point stand-in: records its arguments, returns ``err``."""

    def __init__(self, err=0):
        self.err, self.seen = err, []
        self.fn = self

    def __call__(self, *args):
        self.seen.append(args)
        return self.err


@pytest.fixture
def fake_cuda(monkeypatch):
    """The two calls ``launch`` makes into torch's CUDA bindings, stood in
    for on a CPU-only build: device 0 current, stream pointer 1234."""
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 1234,
                        raising=False)


def test_launch_counts_each_call_and_its_variant(fake_cuda):
    entry = _FakeEntry()
    before = Counter(LAUNCHES)
    for _ in range(3):
        _launch.launch("probe kernel", entry, 0, (11, 22, 5), tag="v1")
    _launch.launch("probe kernel", entry, 0, (11, 22, 5))
    assert Counter(LAUNCHES) - before == Counter({"probe kernel": 4,
                                                  "probe kernel:v1": 3})
    assert entry.seen == [(11, 22, 5, 1234)] * 4      # the raw stream goes last
    for key in ("probe kernel", "probe kernel:v1"):
        LAUNCHES.pop(key)


def test_launch_failure_raises_and_counts_nothing(fake_cuda):
    before = Counter(LAUNCHES)
    with pytest.raises(RuntimeError, match="error -1: the cluster"):
        _launch.launch("probe kernel", _FakeEntry(-1), 0, (1,), tag="v",
                       errors={-1: "the cluster cannot be scheduled"})
    with pytest.raises(RuntimeError, match="error 700$"):
        _launch.launch("probe kernel", _FakeEntry(700), 0, (1,))
    assert Counter(LAUNCHES) == before


def test_launch_key_format():
    assert _launch.launch_key("k", "v") == "k:v" == saa.launch_key("k", "v")


@pytest.mark.cuda
def test_cuda_weighted_aggregate_equals_chain_apply_bitwise():
    """On the card: kernel 6's own launch == the chain's saa_apply aggregate
    on the same weights, bit for bit; a misaligned U raises after a cached
    good call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for n, d in ((1, BLK), (10, 7 * BLK), (17, 3 * BLK), (64, 8 * BLK)):
        _, u, fresh, tau, valid, scal = [t.cuda() for t in _saa_operands(1, n, d, seed=n)]
        agg, w = saa.sweep_fused_staleness_aggregate(
            u, fresh, tau, scal[:, 0].contiguous(), valid, variant="chain")
        before = Counter(LAUNCHES)
        got = saa.weighted_aggregate(w[0], u[0])
        torch.cuda.synchronize()
        assert Counter(LAUNCHES) - before == Counter({"weighted_aggregate": 1})
        assert torch.equal(got.view(torch.int32), agg[0].view(torch.int32))
        with pytest.raises(ValueError, match="16-byte aligned"):
            saa.weighted_aggregate(w[0], _misaligned(u[0]))
