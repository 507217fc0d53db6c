"""The port's client optimizers and schedules (``repro_torch.optim``), the
tree YoGi server (``repro_torch.core.aggregation.yogi_init`` /
``yogi_apply``) and activation checkpointing (``cfg.remat``) against the
reference's.

- ``sgd_init`` / ``sgd_apply`` (momentum 0 and 0.9; fp32 and bf16 params,
  cast back to each param's dtype), ``clip_by_global_norm`` (norms above
  and below the cap) and both schedules over a grid of steps: rtol 1e-6 /
  atol 1e-7 in fp32, and the same bf16 bits (the fp32 update rounds once);
- the tree YoGi against the reference's on a mixed fp32/bf16 tree over
  three steps (rtol 1e-6), its state's dtypes and ``t``, and bit for bit
  ``yogi_apply_flat`` on the flattened tree, leaf by leaf;
- remat: for a dense, an MoE and an rwkv6 REDUCED config, ``lm_loss`` and
  every gradient bit for bit equal with ``remat`` on and off (the
  recompute runs the same ops on the same inputs), and fewer bytes saved
  for the backward with it on (counted with
  ``torch.autograd.graph.saved_tensors_hooks``); a ``loss_chunk`` case (S
  = 64, chunks of 16, remat on) against the reference's loss and gradient
  at rtol 1e-4 / atol 1e-6; without grad, remat changes nothing.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget
from repro.core import aggregation as jagg
from repro.models import init_params as jinit
from repro.models.transformer import lm_loss as jlm_loss
from repro.optim import schedules as jsched
from repro.optim import sgd as jsgd
from repro_torch.configs import get_reduced as tget
from repro_torch.core import aggregation as tagg
from repro_torch.core.aggregation import (_rebuild, _skeleton, flatten_update, tree_leaves,
                                         unflatten_update)
from repro_torch.models import forward, init_params, lm_loss
from repro_torch.optim import (clip_by_global_norm, cosine_schedule, sgd_apply, sgd_init,
                               wsd_schedule)
from repro_torch.weights import from_jax_tree

torch.set_num_threads(1)

FP32 = dict(rtol=1e-6, atol=1e-7)
STEPS = np.array([0, 1, 5, 99, 100, 101, 250, 799, 800, 801, 950, 1000, 1001, 5000],
                 np.float32)


def _trees(seed, dtypes=("float32", "bfloat16")):
    """(reference tree, port tree) of the same values: a nested dict with a
    list, one leaf per dtype given and a fp32 bias."""
    rng = np.random.default_rng(seed)
    arr = lambda *s: rng.standard_normal(s).astype(np.float32)
    jt = {"a": {"w": jnp.asarray(arr(6, 5), dtypes[0]), "b": jnp.asarray(arr(5))},
          "layers": [jnp.asarray(arr(3, 4), dtypes[-1]), jnp.asarray(arr(7))]}
    return jt, from_jax_tree(jax.tree.map(np.asarray, jt))


def _same(got, want):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        if a.dtype == torch.bfloat16:
            assert torch.equal(a, from_jax_tree(np.asarray(b)))
        else:
            np.testing.assert_allclose(a.double().numpy(), np.asarray(b, np.float64), **FP32)


# ---------------------------------------------------------------------------
# (v) SGD, clipping, schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_reference(momentum):
    jp, tp = _trees(0)
    js, ts = jsgd.sgd_init(jp, momentum), sgd_init(tp, momentum)
    assert (ts == {}) == (momentum == 0.0)
    for step in range(3):
        jg, tg = _trees(10 + step)
        jp, js = jsgd.sgd_apply(jp, jg, js, lr=0.05, momentum=momentum)
        tp, ts = sgd_apply(tp, tg, ts, lr=0.05, momentum=momentum)
        _same(tp, jp)
        if momentum:
            _same(ts["mom"], js["mom"])
            assert all(m.dtype == torch.float32 for m in tree_leaves(ts["mom"]))


@pytest.mark.parametrize("max_norm", [0.5, 3.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    jg, tg = _trees(3)
    jc, jn = jsgd.clip_by_global_norm(jg, max_norm)
    tc, tn = clip_by_global_norm(tg, max_norm)
    np.testing.assert_allclose(float(tn), float(jn), **FP32)
    _same(tc, jc)
    if max_norm == 1e3:
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tc), tree_leaves(tg)))


@pytest.mark.parametrize("kw", [
    dict(peak_lr=1e-2, warmup_steps=100, stable_steps=700, decay_steps=200),
    dict(peak_lr=3e-3, warmup_steps=0, stable_steps=50, decay_steps=0, final_ratio=0.3),
])
def test_wsd_schedule_matches_reference(kw):
    want = np.asarray(jsched.wsd_schedule(jnp.asarray(STEPS), **kw))
    got = wsd_schedule(torch.from_numpy(STEPS), **kw)
    assert got.dtype == torch.float32 and got.shape == STEPS.shape
    np.testing.assert_allclose(got.numpy(), want, **FP32)
    for s in (0, 150, 900):            # a plain int step, as the reference takes
        np.testing.assert_allclose(float(wsd_schedule(s, **kw)),
                                   float(jsched.wsd_schedule(s, **kw)), **FP32)


@pytest.mark.parametrize("kw", [
    dict(peak_lr=1e-2, warmup_steps=100, total_steps=1000),
    dict(peak_lr=5e-4, warmup_steps=0, total_steps=1, final_ratio=0.0),
])
def test_cosine_schedule_matches_reference(kw):
    want = np.asarray(jsched.cosine_schedule(jnp.asarray(STEPS), **kw))
    got = cosine_schedule(torch.from_numpy(STEPS), **kw)
    np.testing.assert_allclose(got.numpy(), want, **FP32)
    np.testing.assert_allclose(float(cosine_schedule(550, **kw)),
                               float(jsched.cosine_schedule(550, **kw)), **FP32)


# ---------------------------------------------------------------------------
# (iii) the tree YoGi server
# ---------------------------------------------------------------------------


def test_yogi_tree_matches_reference():
    jp, tp = _trees(4)
    js, ts = jagg.yogi_init(jp), tagg.yogi_init(tp)
    assert ts["t"].dtype == torch.int32 and ts["t"].shape == ()
    assert all(l.dtype == torch.float32 for l in tree_leaves([ts["m"], ts["v"]]))
    for step in range(3):
        jd, td = _trees(20 + step, ("float32",))
        jp, js = jagg.yogi_apply(jp, jd, js, lr=0.05)
        tp, ts = tagg.yogi_apply(tp, td, ts, lr=0.05)
        _same(tp, jp)
        _same(ts["m"], js["m"])
        _same(ts["v"], js["v"])
    assert int(ts["t"]) == 3 == int(js["t"])


def test_yogi_tree_equals_flat_bitwise():
    """The tree version leaf by leaf == ``yogi_apply_flat`` on the flattened
    tree, bit for bit (params, m, v), over three steps."""
    _, tp = _trees(5, ("float32",))
    flat, spec = flatten_update(tp)
    ts, fs = tagg.yogi_init(tp), tagg.yogi_init_flat(flat.numel())
    for step in range(3):
        _, td = _trees(30 + step, ("float32",))
        tp, ts = tagg.yogi_apply(tp, td, ts)
        flat, fs = tagg.yogi_apply_flat(flat, flatten_update(td)[0], fs)
        for key, tree in (("p", tp), ("m", ts["m"]), ("v", ts["v"])):
            row = {"p": flat, "m": fs["m"], "v": fs["v"]}[key]
            for a, b in zip(tree_leaves(tree), tree_leaves(unflatten_update(row, spec))):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32)), key
    assert int(ts["t"]) == int(fs["t"]) == 3


# ---------------------------------------------------------------------------
# (iv) activation checkpointing
# ---------------------------------------------------------------------------


def _grads_and_saved(cfg, params, batch):
    """(loss, grads in leaf order, bytes saved for the backward)."""
    leaves = [l.detach().requires_grad_() for l in tree_leaves(params)]
    q = _rebuild(_skeleton(params, [0]), leaves)
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = lm_loss(cfg, q, batch)
    return loss, torch.autograd.grad(loss, leaves, allow_unused=True,
                                     materialize_grads=True), saved[0]


@pytest.mark.parametrize("arch,over", [
    ("qwen2.5-3b", {}),
    ("deepseek-v2-lite-16b", {}),               # MLA + MoE
    ("rwkv6-1.6b", {}),
    ("internlm2-1.8b", dict(loss_chunk=8)),     # the chunked loss too
])
def test_remat_is_bitwise_neutral_and_saves_less(arch, over):
    cfg = dataclasses.replace(tget(arch), param_dtype=torch.float32, **over)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 33), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    off = _grads_and_saved(dataclasses.replace(cfg, remat=False), params, batch)
    on = _grads_and_saved(dataclasses.replace(cfg, remat=True), params, batch)
    assert torch.equal(on[0], off[0])
    assert all(torch.equal(a, b) for a, b in zip(on[1], off[1]))
    assert on[2] < off[2] / 2
    with torch.no_grad():                       # no grad: remat changes nothing
        x_on = forward(dataclasses.replace(cfg, remat=True), params, batch)[0]
        assert torch.equal(x_on, forward(cfg, params, batch)[0])


def test_remat_loss_chunk_matches_reference():
    over = dict(remat=True, loss_chunk=16)
    jc = dataclasses.replace(jget("internlm2-1.8b"), param_dtype=jnp.float32, **over)
    tc = dataclasses.replace(tget("internlm2-1.8b"), param_dtype=torch.float32, **over)
    jp = jinit(jc, jax.random.PRNGKey(0))
    tp = from_jax_tree(jax.tree.map(np.asarray, jp))
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, (2, 65)).astype(np.int32)
    nb = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jlm_loss(jc, p, {
        k: jnp.asarray(v) for k, v in nb.items()})))(jp)
    tl, tg, _ = _grads_and_saved(tc, tp, {k: torch.from_numpy(v) for k, v in nb.items()})
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for a, b in zip(tg, jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.double().numpy(), np.asarray(b, np.float64),
                                   rtol=1e-4, atol=1e-6)
