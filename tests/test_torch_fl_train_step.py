"""The port's pod FL train step (``repro_torch.launch.train``) against the
reference's (``repro.launch.train``), and the refusal of kernels 8 and 9
under autograd on the card.

Params come from the reference's ``init_params(cfg, PRNGKey(0))``, carried
across with ``repro_torch.weights.from_jax_tree``; batches from a numpy
seed; the reference's steps are jitted.  Held:

- each of the ten REDUCED configs, fp32: one ``make_fl_train_step`` (fresh
  [T, T, F], tau [0, 0, 2], B = 2, S = 16): loss, weights and new params at
  rtol = atol = 1e-4 (as ``tests/_zoo_parity.py`` holds the zoo; rwkv6's
  ``u`` leaf, which moves by ~18 in one step, at an atol of 1e-4 times its
  largest update), and the update (new - old) by relative L2 <= 1e-3 (the
  update is small beside most params, so the params alone would hide it);
  both packages start from the reference's bf16 draw, widened to fp32;
- the same in bf16 through ``make_fl_aggregate_step``: the delta is
  bf16-quantized each local step ((w - lr g) rounds to bf16), and the two
  frameworks round in other places, so the aggregate is held by relative
  L2: <= 0.25 from the reference's bf16 aggregate (measured 0.027-0.185,
  jamba's eight layers the largest), and no further from the port's fp32
  aggregate than 1.1x the reference's bf16 distance + 0.01 (each is
  0.02-0.42 from it);
- cohorts: the port's ``vmap`` == its ``stream`` within the reference
  test's bounds (weights rtol 1e-3 / atol 1e-5, params rtol 1e-2 / atol
  1e-5, ``tests/test_models_smoke.py``) over all ten configs, with two
  stale participants so that Lam differs between them; the port's
  ``stream`` against the reference's ``stream``;
- the YoGi server: two steps, t == 2, m and v and params against the
  reference's;
- ``default_cohort`` == the reference's for all ten published configs,
  counted from shapes (the reference's ``jax.eval_shape``) as meta tensors:
  no weights are built;
- the CLI on ``--device cpu``; ``param_specs`` other than None raises;
- kernels 8 and 9 on CUDA operands (``FakeTensorMode``'s, on this
  CPU-only build) raise ``NotImplementedError`` before a launch when
  autograd would record the call, and reach the launch (stood in for)
  otherwise; on the CPU the plain versions stay differentiable.
"""
import dataclasses
import functools
import math
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jget_full
from repro.configs import get_reduced as jget
from repro.core.aggregation import yogi_init as jyogi_init
from repro.launch import train as jtrain
from repro.models import init_params as jinit
from repro_torch.configs import get_config as tget_full
from repro_torch.configs import get_reduced as tget
from repro_torch.core.aggregation import tree_leaves, yogi_init
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.launch import train as ttrain
from repro_torch.models import init_params, lm_loss
from repro_torch.weights import from_jax_tree

torch.set_num_threads(1)

ARCHS = ("internlm2-1.8b", "rwkv6-1.6b", "deepseek-v2-lite-16b", "jamba-v0.1-52b",
         "kimi-k2-1t-a32b", "internvl2-76b", "minicpm-2b", "musicgen-medium",
         "qwen2.5-32b", "qwen2.5-3b")
TOL = dict(rtol=1e-4, atol=1e-4)
FRESH, TAU = [True, True, False], [0, 0, 2]
# two stale participants: Lam_s / Lam_max differs from 1, so the weights
# depend on the deltas
FRESH2, TAU2 = [True, True, False, False], [0, 0, 1, 3]


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """The reference's ``init_params(REDUCED, PRNGKey(0))`` in its own
    dtype, drawn once per file (the eager init costs seconds a config)."""
    return jinit(jget(arch), jax.random.PRNGKey(0))


def _model(arch, fp32=True):
    """(reference config, port config, reference params, port params); in
    fp32 the bf16 draw is widened, so both dtypes start from one model."""
    jc, tc, jp = jget(arch), tget(arch), _ref_params(arch)
    if fp32:
        jc = dataclasses.replace(jc, param_dtype=jnp.float32)
        tc = dataclasses.replace(tc, param_dtype=torch.float32)
        jp = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    return jc, tc, jp, from_jax_tree(jax.tree.map(np.asarray, jp))


def _cohort(cfg, fresh, tau, B=2, S=16, seed=0):
    """(reference's batch, fresh, tau), (the port's): leaves (P, B, S)."""
    rng = np.random.default_rng(seed)
    P = len(fresh)
    toks = rng.integers(0, cfg.vocab_size, (P, B, S + 1)).astype(np.int32)
    nb = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if cfg.frontend == "vision":
        nb["frontend_embeds"] = rng.standard_normal(
            (P, B, cfg.n_frontend_tokens, cfg.d_frontend)).astype(np.float32)
    fr, ta = np.asarray(fresh), np.asarray(tau, np.int32)
    return (({k: jnp.asarray(v) for k, v in nb.items()}, jnp.asarray(fr), jnp.asarray(ta)),
            ({k: torch.from_numpy(v) for k, v in nb.items()}, torch.from_numpy(fr),
             torch.from_numpy(ta)))


def _flat(tree) -> np.ndarray:
    """Leaves in the reference's order as one fp64 vector (either package)."""
    return np.concatenate([np.asarray(l.double() if isinstance(l, torch.Tensor) else l,
                                      np.float64).ravel() for l in tree_leaves(tree)])


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _close_trees(got, want, *, old=None, rtol, atol):
    """Leaf by leaf; with ``old`` (the params before the step) a leaf's atol
    grows with its largest update past 1: rwkv6's ``u`` moves by ~18 at the
    default local_lr (its gradient ~1.8e3 on the reduced config), where
    fp32's rounding of the update alone is ~1e-5 of it."""
    g, w = tree_leaves(got), tree_leaves(want)
    olds = [None] * len(w) if old is None else tree_leaves(old)
    assert len(g) == len(w) == len(olds)
    for a, b, o in zip(g, w, olds):
        assert tuple(a.shape) == tuple(b.shape)
        b = np.asarray(b, np.float64)
        scale = 1.0 if o is None else max(1.0, float(np.abs(b - np.asarray(o, np.float64)).max()))
        np.testing.assert_allclose(a.double().numpy(), b, rtol=rtol, atol=atol * scale)


# ---------------------------------------------------------------------------
# (i) the FedAvg step on each REDUCED config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference_fp32(arch):
    jc, tc, jp, tp = _model(arch)
    jb, tb = _cohort(jc, FRESH, TAU)
    jnew, jm = jax.jit(jtrain.make_fl_train_step(jc))(jp, *jb)
    tnew, tm = ttrain.make_fl_train_step(tc)(tp, *tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(tm["weights"].numpy(), np.asarray(jm["weights"]), **TOL)
    _close_trees(tnew, jnew, old=jp, **TOL)
    assert _rel(_flat(tnew) - _flat(tp), _flat(jnew) - _flat(jp)) <= 1e-3
    assert all(a.dtype == b.dtype for a, b in zip(tree_leaves(tnew), tree_leaves(tp)))


@pytest.mark.parametrize("arch", ARCHS)
def test_aggregate_matches_reference_bf16(arch):
    jc, tc, jp, tp = _model(arch, fp32=False)
    assert tree_leaves(tp)[0].dtype == torch.bfloat16
    jb, tb = _cohort(jc, FRESH, TAU)
    jagg, jm = jax.jit(jtrain.make_fl_aggregate_step(jc))(jp, *jb)
    tagg, tm = ttrain.make_fl_aggregate_step(tc)(tp, *tb)
    assert all(l.dtype == torch.float32 for l in tree_leaves(tagg))
    t32 = dataclasses.replace(tc, param_dtype=torch.float32)
    agg32, _ = ttrain.make_fl_aggregate_step(t32)(
        from_jax_tree(jax.tree.map(lambda x: np.asarray(x, np.float32), jp)), *tb)
    got, want, fp32 = _flat(tagg), _flat(jagg), _flat(agg32)
    assert _rel(got, want) <= 0.25
    assert _rel(got, fp32) <= 1.1 * _rel(want, fp32) + 0.01
    np.testing.assert_allclose(tm["weights"].numpy(), np.asarray(jm["weights"]), **TOL)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-3)


# ---------------------------------------------------------------------------
# (ii) the two cohorts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_vmap_equals_stream_in_the_port(arch):
    tc = dataclasses.replace(tget(arch), param_dtype=torch.float32)
    tp = init_params(tc, torch.Generator().manual_seed(0))
    _, tb = _cohort(tc, FRESH2, TAU2, seed=1)
    n1, m1 = ttrain.make_fl_train_step(tc, cohort="vmap")(tp, *tb)
    n2, m2 = ttrain.make_fl_train_step(tc, cohort="stream")(tp, *tb)
    np.testing.assert_allclose(m1["weights"].numpy(), m2["weights"].numpy(),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-6)
    for a, b in zip(tree_leaves(n1), tree_leaves(n2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-2, atol=1e-5)
    w = m1["weights"]
    assert abs(float(w.sum()) - 1.0) <= 1e-6 and float(w[2]) != float(w[3])


def test_stream_matches_reference_stream():
    jc, tc, jp, tp = _model("qwen2.5-3b")
    jb, tb = _cohort(jc, FRESH2, TAU2, seed=1)
    jagg, jm = jax.jit(jtrain.make_fl_aggregate_step(jc, cohort="stream"))(jp, *jb)
    tagg, tm = ttrain.make_fl_aggregate_step(tc, cohort="stream")(tp, *tb)
    np.testing.assert_allclose(tm["weights"].numpy(), np.asarray(jm["weights"]), **TOL)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    assert _rel(_flat(tagg), _flat(jagg)) <= 1e-4
    _close_trees(tagg, jagg, rtol=1e-4, atol=1e-7)


def test_vmap_hands_out_its_deltas():
    """``deltas_out`` receives the (P, ...) fp32 deltas the weights came
    from: recomputed in fp64 from them, the weights agree."""
    _, tc, _, tp = _model("internlm2-1.8b")
    _, tb = _cohort(tc, FRESH2, TAU2, seed=2)
    out = {}
    agg, m = ttrain.make_fl_aggregate_step(tc)(tp, *tb, deltas_out=out)
    d = [l.double().reshape(4, -1) for l in tree_leaves(out["deltas"])]
    d = torch.cat(d, dim=1)
    fresh = tb[1]
    u_hat = d[fresh].mean(0)
    lam = ((u_hat - d) ** 2).sum(1) / (3.0 ** 2 * (u_hat @ u_hat))
    lam = torch.where(fresh, 0.0, lam)
    w = ttrain._relay_weights(fresh, tb[2], lam, rule="relay", beta=0.35)
    np.testing.assert_allclose(m["weights"].double().numpy(), w.numpy(), rtol=1e-5)
    torch.testing.assert_close(torch.cat([l.reshape(-1) for l in tree_leaves(agg)]).double(),
                               m["weights"].double() @ d, rtol=1e-5, atol=1e-9)


# ---------------------------------------------------------------------------
# (iii) the YoGi server
# ---------------------------------------------------------------------------


def test_yogi_step_matches_reference_over_two_steps():
    jc, tc, jp, tp = _model("internlm2-1.8b")
    jb, tb = _cohort(jc, [True, True, False], [0, 0, 1], seed=3)
    jstep = jax.jit(jtrain.make_fl_train_step_yogi(jc))
    tstep = ttrain.make_fl_train_step_yogi(tc, cohort="stream")
    js, ts = jyogi_init(jp), yogi_init(tp)
    for _ in range(2):
        jp, js, jm = jstep(jp, js, *jb)
        tp, ts, tm = tstep(tp, ts, *tb)
    assert ts["t"].dtype == torch.int32 and int(ts["t"]) == 2 == int(js["t"])
    np.testing.assert_allclose(tm["weights"].numpy(), np.asarray(jm["weights"]), **TOL)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    assert abs(float(tm["weights"].sum()) - 1.0) <= 1e-4
    _close_trees(ts["m"], js["m"], rtol=1e-3, atol=1e-8)
    _close_trees(ts["v"], js["v"], rtol=1e-3, atol=1e-10)
    _close_trees(tp, jp, **TOL)


# ---------------------------------------------------------------------------
# (vi) default_cohort; the CLI; param_specs
# ---------------------------------------------------------------------------


def test_default_cohort_matches_reference_from_shapes():
    for arch in ARCHS:
        shapes = jax.eval_shape(lambda: jinit(jget_full(arch), jax.random.PRNGKey(0)))
        meta = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), shapes)
        want = jtrain.default_cohort(jget_full(arch), shapes)
        assert ttrain.default_cohort(tget_full(arch), meta) == want, arch
    assert ttrain.STREAM_THRESHOLD == jtrain.STREAM_THRESHOLD


def test_cli_runs_on_the_cpu(capsys):
    ttrain.main(["--rounds", "10", "--participants", "3", "--local-batch", "1",
                 "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "done"
    assert out[0].startswith("round   10 loss=") and math.isfinite(float(out[0].split("=")[1]))


def test_cli_needs_a_gpu_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--rounds", "1"])


def test_param_specs_name_their_roadmap_item():
    cfg = tget("internlm2-1.8b")
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md queue 1 item 15\)"):
        ttrain.make_fl_train_step(cfg, param_specs={"embed": None})
    with pytest.raises(ValueError):
        ttrain.make_fl_train_step(cfg, cohort="scan")


# ---------------------------------------------------------------------------
# (viii) kernels 8 and 9 refuse autograd on the card
# ---------------------------------------------------------------------------


def _kernel_call(name, dev, grad):
    """(wrapper call, the operand that requires grad when ``grad``) of a
    small valid call of kernel 8's or 9's wrapper ``name`` on ``dev``."""
    rnd = lambda *shape: torch.randn(shape, device=dev)
    if name.startswith("swa"):
        bhsd = name == "swa_attention_bhsd"
        q = rnd(4, 128, 64) if bhsd else rnd(1, 128, 4, 64)
        k, v = (rnd(2, 128, 64), rnd(2, 128, 64)) if bhsd else (
            rnd(1, 128, 2, 64), rnd(1, 128, 2, 64))
        q.requires_grad_(grad)
        if bhsd:
            return lambda: swa_ops.swa_attention_bhsd(q, k, v, window=128,
                                                      n_kv_heads=2), q
        return lambda: swa_ops.swa_attention(q, k, v, window=128), q
    shape = (2, 8, 16) if name == "wkv6_bhsn" else (1, 8, 2, 16)
    r, k, v, w = rnd(*shape), rnd(*shape), rnd(*shape), -torch.rand(shape, device=dev)
    k.requires_grad_(grad)
    if name == "wkv6_bhsn":
        u, s0 = rnd(2, 1, 16), torch.zeros(2, 16, 16, device=dev)
        return lambda: wkv_ops.wkv6_bhsn(r, k, v, w, u, s0)[0], k
    return lambda: wkv_ops.wkv6(r, k, v, w, rnd(2, 16))[0], k


@pytest.fixture
def standin_launch(monkeypatch):
    """The wrappers' launch step stood in for: it records its calls and
    returns empty results, so nothing reaches a CUDA entry point."""
    calls = []

    def launch_swa(q, k, v, out, *a):
        calls.append("swa")
        return out

    def launch_wkv(r, k, v, w, u, s0, B, H, S, N, *a):
        calls.append("wkv")
        return torch.empty_like(v), torch.empty((B * H, N, N), device=r.device)
    monkeypatch.setattr(swa_ops, "_launch", launch_swa)
    monkeypatch.setattr(wkv_ops, "_launch", launch_wkv)
    monkeypatch.setattr(swa_ops, "contiguous16", lambda t: t)
    return calls


KERNEL_WRAPPERS = ("swa_attention", "swa_attention_bhsd", "wkv6", "wkv6_bhsn")


@pytest.mark.parametrize("name", KERNEL_WRAPPERS)
def test_lm_kernels_refuse_autograd_on_cuda(name, standin_launch):
    before = Counter(LAUNCHES)
    with FakeTensorMode():
        call, _ = _kernel_call(name, "cuda", True)
        with pytest.raises(NotImplementedError,
                           match=r"forward-only.*use_kernels=False.*ROADMAP\.md "
                                 r"queue 1 item 13\)"):
            call()
        assert standin_launch == [] and Counter(LAUNCHES) == before
        with torch.no_grad():                   # inference: the launch is reached
            call()
        with torch.inference_mode():
            call()
        _kernel_call(name, "cuda", False)[0]()  # no operand requires grad
    assert len(standin_launch) == 3


@pytest.mark.parametrize("name", KERNEL_WRAPPERS)
def test_lm_kernels_stay_differentiable_on_the_cpu(name):
    torch.manual_seed(0)
    call, x = _kernel_call(name, "cpu", True)
    (grad,) = torch.autograd.grad(call().square().sum(), [x])
    assert torch.isfinite(grad).all() and grad.abs().sum() > 0


@pytest.mark.parametrize("arch,over", [("internlm2-1.8b", dict(window=128)),
                                       ("rwkv6-1.6b", {})])
def test_lm_loss_through_kernel_configs_trains_on_the_cpu(arch, over):
    """On the CPU ``use_kernels=True`` runs the plain versions, which
    autograd differentiates: the same loss and gradient as the plain path."""
    cfg = dataclasses.replace(tget(arch), param_dtype=torch.float32, **over)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 130), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    grads = {}
    for kern in (False, True):
        c = dataclasses.replace(cfg, use_kernels=kern)
        leaves = [l.requires_grad_() for l in tree_leaves(params)]
        grads[kern] = torch.autograd.grad(lm_loss(c, params, batch), leaves)
        for l in leaves:
            l.requires_grad_(False)
    for a, b in zip(grads[False], grads[True]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,over", [("internlm2-1.8b", dict(window=128)),
                                       ("rwkv6-1.6b", {})])
def test_lm_loss_through_the_kernels_raises_on_the_card(arch, over):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = dataclasses.replace(tget(arch), use_kernels=True, **over)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (1, 257), device="cuda")
    leaves = [l.requires_grad_() for l in tree_leaves(params)]
    with pytest.raises(NotImplementedError, match="item 13"):
        torch.autograd.grad(lm_loss(cfg, params, {"tokens": toks[:, :-1],
                                                  "labels": toks[:, 1:]}), leaves)
