"""The pod dry run's whole grid on the REDUCED dense and RWKV configs
(``repro_torch.launch.dryrun``), and the closed forms that count the two
recurrences.

- every (arch, shape) of the grid counted on a fake (2, 4) mesh
  (``tests/_dryrun_cases.reduced_record``): a step of each kind, the vmap
  cohort's train step included, with FLOPs and bytes above 0 and the
  model's own FLOPs at most 1.05 of the counted ones (``useful_ratio`` in
  (0, 1.05]); a train step on more than one chip moves collective bytes;
- ``mamba_scan_cost`` and ``wkv_scan_cost`` ``==`` the counter's count of
  the dispatched ``mamba._scan`` and ``rwkv6.wkv6_scan`` at S = 64 (and
  other shapes, dtypes, a start state), and the closed-form stand-in
  (``dryrun._closed_form_scan``) counting a training step's backward as
  twice its forward, with gradients of the inputs' shapes;
- ``dryrun.useful_ok``'s one exception (a recurrent-only decode step is
  held against 2 N T less its embedding rows, which it does not multiply),
  shown on the REDUCED rwkv6 decode's count by op;
- ``dryrun.main`` over several archs (one child process an arch, the
  children stood in for) fails on a child that exits non-zero after
  writing some records, on records missing, and on a useful ratio out of
  bounds, and passes only with every combination counted.
"""
import pytest
import torch

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config, get_reduced

from _dryrun_cases import SHAPES, check_record, reduced_record
from repro_torch.launch import dryrun as dr
from repro_torch.models import mamba, rwkv6
from repro_torch.roofline import CostCounter

torch.set_num_threads(1)

ARCHS = ["internlm2-1.8b", "qwen2.5-3b", "minicpm-2b", "musicgen-medium",
         "rwkv6-1.6b"]


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_grid_counted(monkeypatch, arch, shape):
    check_record(reduced_record(monkeypatch, arch, shape), shape)


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


@pytest.mark.parametrize("b,s,d,n", [(2, 64, 32, 16), (1, 300, 8, 4), (3, 512, 4, 2)])
def test_mamba_scan_closed_form_equals_dispatched(b, s, d, n):
    with CostCounter() as c:
        mamba._scan(_meta(b, s, d), _meta(b, s, d), _meta(b, s, n), _meta(b, s, n),
                    _meta(d, n), _meta(b, d, n))
    assert (c.flops, c.bytes) == dr.mamba_scan_cost(b, s, d, n)


@pytest.mark.parametrize("b,dtype,with_s0", [(2, torch.float32, False),
                                             (2, torch.float32, True),
                                             (1, torch.float32, False),
                                             (2, torch.bfloat16, True)])
def test_wkv_scan_closed_form_equals_dispatched(b, dtype, with_s0):
    s, h, n = 64, 4, 8
    with CostCounter() as c:
        rwkv6.wkv6_scan(*(_meta(b, s, h, n, dtype=dtype) for _ in range(3)),
                        _meta(b, s, h, n), _meta(h, n),
                        state0=_meta(b, h, n, n) if with_s0 else None)
    e = torch.empty((), dtype=dtype).element_size()
    assert (c.flops, c.bytes) == dr.wkv_scan_cost(b, s, h, n, e, e, 4, with_s0)


def test_closed_form_scan_stands_in_forward_and_backward():
    b, s, d, n, h, hn = 2, 64, 8, 4, 2, 4
    ins = [_meta(b, s, d, grad=True), _meta(b, s, d, grad=True),
           _meta(b, s, n, grad=True), _meta(b, s, n, grad=True),
           _meta(d, n, grad=True), _meta(b, d, n)]
    wins = [_meta(b, s, h, hn, grad=True) for _ in range(4)] + [_meta(h, hn, grad=True)]
    counter = CostCounter()
    with dr._closed_form_scan(counter):
        ys, hf = mamba._scan(*ins)
        y, st = rwkv6.wkv6_scan(*wins)
        assert ys.shape == (b, s, d) and hf.shape == (b, d, n)
        assert y.shape == (b, s, h, hn) and st.shape == (b, h, hn, hn)
        assert st.dtype == torch.float32
        fwd = dict(counter.by_op)
        grads = torch.autograd.grad(ys.sum() + hf.sum() + y.sum() + st.sum(),
                                    ins[:5] + wins)
    assert [g.shape for g in grads] == [t.shape for t in ins[:5] + wins]
    m = dr.mamba_scan_cost(b, s, d, n)
    w = dr.wkv_scan_cost(b, s, h, hn, 4, 4)
    assert fwd["mamba scan (closed form)"] == list(m)
    assert fwd["wkv6 scan (closed form)"] == list(w)
    assert counter.by_op["mamba scan (closed form) backward"] == [2 * m[0], 2 * m[1]]
    assert counter.by_op["wkv6 scan (closed form) backward"] == [2 * w[0], 2 * w[1]]
    assert mamba._scan.__module__ == "repro_torch.models.mamba"   # restored


def test_recurrent_decode_misses_only_its_embedding_rows():
    """The REDUCED rwkv6 decode step, counted plain: its FLOPs fall under
    2 N B (a ratio above 1 against the model's own FLOPs), and its matrix
    products alone reach 2 (N - V d) B: what is missing is the embedding
    rows, which a lookup does not multiply.  ``useful_ok`` takes such a
    step against 2 (N - V d) B, and no other kind or architecture."""
    from repro_torch.models import init_params
    from repro_torch.models.transformer import (decode_step, init_decode_state,
                                                shape_params)
    from repro_torch.roofline import active_params
    cfg = get_reduced("rwkv6-1.6b")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    b = 4
    state = init_decode_state(cfg, b, 256, device="cpu")
    c = CostCounter()
    with torch.no_grad(), dr._closed_form_scan(c), c:
        decode_step(cfg, params, state, torch.zeros(b, dtype=torch.int32),
                    torch.full((b,), 3, dtype=torch.int32))
    n = active_params(cfg, shape_params(cfg))
    embed = cfg.vocab_size * cfg.d_model
    products = sum(f for op, (f, _) in c.by_op.items() if op in ("mm", "addmm", "bmm"))
    assert c.flops < 2 * n * b
    assert products >= 2 * (n - embed) * b
    assert 0 < 2 * (n - embed) * b / c.flops <= dr.USEFUL_MAX

    ratio = 2 * n * b / c.flops
    rec = {"kind": "decode", "n_active_params": n, "roofline": {"useful_ratio": ratio}}
    assert dr.useful_ok(rec, cfg)
    assert not dr.useful_ok(dict(rec, roofline={"useful_ratio": 1.2 * ratio}), cfg)
    full = get_config("rwkv6-1.6b")
    at_full = {"kind": "decode", "n_active_params": 1_600_000_000,
               "roofline": {"useful_ratio": 1.07}}
    assert dr.useful_ok(at_full, full)
    assert not dr.useful_ok(dict(at_full, kind="prefill"), full)
    assert not dr.useful_ok(at_full, get_config("internlm2-1.8b"))
    assert not dr.useful_ok(dict(at_full, roofline={"useful_ratio": 0.0}), full)


def _fake_records(arch, n=None, ratio=0.5):
    recs = [{"arch": arch, "shape": s, "mesh": m, "kind": INPUT_SHAPES[s].kind,
             "step": "counted", "n_active_params": 10 ** 9,
             "roofline": {"useful_ratio": ratio}}
            for s in INPUT_SHAPES for m in ("16x16", "2x16x16")]
    return recs[:n]


@pytest.mark.parametrize("case", ["ok", "child_failed_after_records",
                                  "records_missing", "useful_out_of_bounds"])
def test_grid_parent_fails_unless_every_combination_counted(monkeypatch, capsys, case):
    bad = ARCH_IDS[3]
    seen = []

    def child(arch, argv):
        seen.append((arch, tuple(argv)))
        if arch != bad or case == "ok":
            return 0, _fake_records(arch), ""
        if case == "child_failed_after_records":
            return 1, _fake_records(arch, n=7), "Traceback: param_pspecs raised"
        if case == "records_missing":
            return 0, _fake_records(arch, n=6), ""
        return 0, _fake_records(arch, ratio=1.2), ""
    monkeypatch.setattr(dr, "_run_child", child)
    argv = ["--arch", "all", "--shape", "all", "--both-meshes"]
    if case == "ok":
        dr.main(argv)
        assert capsys.readouterr().out.rstrip().endswith("ALL DRY-RUNS PLACED")
    else:
        with pytest.raises(SystemExit) as e:
            dr.main(argv)
        assert e.value.code == 1
        assert "ALL DRY-RUNS PLACED" not in capsys.readouterr().out
    assert sorted(a for a, _ in seen) == sorted(ARCH_IDS)
    assert all(v == ("--shape", "all", "--cohort", "auto", "--stream-participants",
                     "8", "--variant", "", "--both-meshes") for _, v in seen)
