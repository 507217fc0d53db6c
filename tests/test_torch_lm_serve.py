"""The port's model zoo serve path (``repro_torch.models``,
``repro_torch.launch.serve``) against the reference's, at the reduced
configs of the two ported architectures: internlm2 (GQA, with a 128-token
sliding window and the kernel path on) and rwkv6 (the WKV6 kernel path on).
The reference's ``init_params(cfg, PRNGKey(0))`` is carried across with
``repro_torch.weights.from_jax_tree``; the reference runs its Pallas kernels
in interpret mode.

Held in fp32 at rtol = atol = 1e-4: ``forward`` hidden states and
``make_logits_fn`` logits at S in {128, 200, 256} (S off the 128 tile and
past the window), ``prefill``'s last logits and states, ``decode_step``'s
logits per step over 40 steps, and ``greedy_generate``'s tokens wherever
the reference's top-2 logit gap exceeds 1e-3.  In the port alone, prefill
equals feeding the prompt token by token through decode (a 200-token prompt
through the 128-slot ring cache).  In bf16 the two frameworks round at
other places (XLA fuses elementwise chains in fp32), and each is ~0.04
(internlm2) / ~0.11 (rwkv6) from the fp32 model in max abs logit: the bf16
run is held to a relative L2 error of 3e-2 against the reference's bf16
logits, and to no more than 1.25x the reference's own bf16 error (+0.01)
against the fp32 logits.  The port's init is held to the reference's tree
(key paths, shapes, dtypes), its constants exactly, and its random leaves'
spread.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget
from repro.launch import serve as jserve
from repro.models import forward as jforward
from repro.models import init_decode_state as jinit_state
from repro.models import init_params as jinit
from repro.models import prefill as jprefill
from repro_torch.configs import get_reduced as tget
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import serve as tserve
from repro_torch.models import decode_step, forward, init_decode_state, init_params, prefill
from repro_torch.models.transformer import tree_map
from repro_torch.weights import from_jax_tree

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = {"internlm2": ("internlm2-1.8b", dict(window=128, use_kernels=True)),
         "rwkv6": ("rwkv6-1.6b", dict(use_kernels=True))}
# std of N(0, 1) cut at +-2: the reference's dense init is this times fan_in^-1/2
TRUNC_STD = 0.8796


def _cfgs(name, fp32=True):
    arch, over = ARCHS[name]
    jc = dataclasses.replace(jget(arch), **over)
    tc = dataclasses.replace(tget(arch), **over)
    if fp32:
        jc = dataclasses.replace(jc, param_dtype=jnp.float32)
        tc = dataclasses.replace(tc, param_dtype=torch.float32)
    return jc, tc


@pytest.fixture(scope="module", params=list(ARCHS))
def model(request):
    jc, tc = _cfgs(request.param)
    jp = jinit(jc, jax.random.PRNGKey(0))
    return request.param, jc, tc, jp, from_jax_tree(jax.tree.map(np.asarray, jp))


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _leaves(tree, prefix=""):
    """{key path: leaf} of nested dicts and lists."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in _leaves(sub, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, sub in enumerate(tree) for p, v in _leaves(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _close_trees(got, want, **tol):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for path, wv in w.items():
        np.testing.assert_allclose(g[path].double().numpy(), np.asarray(wv, np.float64),
                                   err_msg=path, **tol)


@pytest.mark.parametrize("S", [128, 200, 256])
def test_forward_and_logits_match_reference(model, S):
    name, jc, tc, jp, tp = model
    toks = _tokens(jc, 2, S, S)
    xj, _, _ = jforward(jc, jp, {"tokens": jnp.asarray(toks)})
    xt, aux, _ = forward(tc, tp, {"tokens": torch.from_numpy(toks)})
    assert xt.shape == (2, S, tc.d_model) and float(aux) == 0.0
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **TOL)
    lj = jserve.make_logits_fn(jc)(jp, {"tokens": jnp.asarray(toks)})
    lt = tserve.make_logits_fn(tc)(tp, {"tokens": torch.from_numpy(toks)})
    assert lt.shape == (2, S, tc.vocab_size)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


def test_prefill_matches_reference(model):
    name, jc, tc, jp, tp = model
    toks = _tokens(jc, 2, 200, 1)
    lj, sj = jprefill(jc, jp, {"tokens": jnp.asarray(toks)})
    lt, st = tserve.make_prefill_step(tc)(tp, {"tokens": torch.from_numpy(toks)})
    assert lt.shape == (2, 1, tc.vocab_size)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    _close_trees(st, jax.tree.map(np.asarray, sj), **TOL)


def test_decode_steps_match_reference(model):
    """40 steps from an empty state: the logits of every step and the
    final state."""
    name, jc, tc, jp, tp = model
    B, steps = 2, 40
    toks = _tokens(jc, B, steps, 2)
    sj = jinit_state(jc, B, steps + 1)
    st = init_decode_state(tc, B, steps + 1, "cpu")
    jstep = jax.jit(jserve.make_decode_step(jc))
    tstep = tserve.make_decode_step(tc)
    for t in range(steps):
        pos = np.full((B,), t, np.int32)
        lj, sj = jstep(jp, sj, jnp.asarray(toks[:, t]), jnp.asarray(pos))
        lt, st = tstep(tp, st, torch.from_numpy(toks[:, t]), torch.from_numpy(pos))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), err_msg=f"step {t}", **TOL)
    _close_trees(st, jax.tree.map(np.asarray, sj), **TOL)


def test_greedy_generate_matches_reference(model):
    """Greedy tokens after a 12-token prompt equal the reference's wherever
    its top-2 logit gap exceeds 1e-3 (up to the first near tie, after which
    the two continuations may part)."""
    name, jc, tc, jp, tp = model
    B, P, n = 4, 12, 24
    prompt = _tokens(jc, B, P, 3)
    sj = jinit_state(jc, B, P + n + 1)
    st = init_decode_state(tc, B, P + n + 1, "cpu")
    jstep = jax.jit(jserve.make_decode_step(jc))
    for t in range(P):
        pos = np.full((B,), t, np.int32)
        lj, sj = jstep(jp, sj, jnp.asarray(prompt[:, t]), jnp.asarray(pos))
        lt, st = decode_step(tc, tp, st, torch.from_numpy(prompt[:, t]), torch.from_numpy(pos))
    first = np.array(jnp.argmax(lj, -1), np.int32)
    assert np.array_equal(first, torch.argmax(lt, -1).numpy())
    start = np.full((B,), P, np.int32)
    toks_j, _ = jserve.greedy_generate(jc, jp, sj, jnp.asarray(first), jnp.asarray(start), n)
    toks_t, _ = tserve.greedy_generate(tc, tp, st, torch.from_numpy(first),
                                       torch.from_numpy(start), n)
    toks_j = np.asarray(toks_j)
    assert toks_t.shape == (B, n + 1) and toks_t.dtype == torch.int32
    # the reference's top-2 gaps along its own tokens
    gaps, s = [], sj
    for t in range(n):
        lj, s = jstep(jp, s, jnp.asarray(toks_j[:, t]), jnp.asarray(start + t))
        top2 = np.sort(np.asarray(lj), axis=-1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
    checked = 0
    for b in range(B):
        for t in range(n):
            if gaps[t][b] <= 1e-3:
                break
            assert toks_t[b, t + 1] == toks_j[b, t + 1], (b, t)
            checked += 1
    assert checked >= B * n // 2


def test_prefill_equals_decode_in_port(model):
    """A 200-token prompt through ``prefill`` and token by token through
    ``decode_step`` (internlm2: a 128-slot ring cache, so the decode path
    wraps) give the same last logits and recurrent state."""
    name, jc, tc, jp, tp = model
    B, S = 2, 200
    toks = torch.from_numpy(_tokens(jc, B, S, 4))
    lp, sp = prefill(tc, tp, {"tokens": toks})
    st = init_decode_state(tc, B, S + 1, "cpu")
    if tc.window is not None:
        assert st["stack"]["sub0"]["k"].shape[2] == tc.window
    for t in range(S):
        ld, st = decode_step(tc, tp, st, toks[:, t], torch.full((B,), t, dtype=torch.int32))
    torch.testing.assert_close(ld, lp[:, 0], **TOL)
    if name == "rwkv6":
        _close_trees(st, sp, **TOL)


@pytest.mark.parametrize("name", list(ARCHS))
def test_bf16_logits_match_reference(name):
    jc, tc = _cfgs(name, fp32=False)
    jp = jinit(jc, jax.random.PRNGKey(0))
    tp = from_jax_tree(jax.tree.map(np.asarray, jp))
    assert tp["embed"]["embedding"].dtype == torch.bfloat16
    toks = _tokens(jc, 2, 200, 5)
    lj = np.asarray(jserve.make_logits_fn(jc)(jp, {"tokens": jnp.asarray(toks)}), np.float32)
    lt = tserve.make_logits_fn(tc)(tp, {"tokens": torch.from_numpy(toks)})
    assert lt.dtype == torch.bfloat16
    lt = lt.float().numpy()
    assert np.isfinite(lt).all()
    assert np.linalg.norm(lt - lj) / np.linalg.norm(lj) <= 3e-2
    jc32 = dataclasses.replace(jc, param_dtype=jnp.float32)
    l32 = np.asarray(jserve.make_logits_fn(jc32)(
        jax.tree.map(lambda a: a.astype(jnp.float32), jp), {"tokens": jnp.asarray(toks)}))
    assert np.abs(lt - l32).max() <= 1.25 * np.abs(lj - l32).max() + 1e-2


def test_kernel_wrappers_on_the_path(model):
    """On the CPU the path calls the kernels' wrappers (which run the plain
    versions and count no launch); with ``use_kernels`` off it takes the
    plain functions directly, with the same result."""
    name, jc, tc, jp, tp = model
    toks = torch.from_numpy(_tokens(jc, 1, 130, 6))
    before = dict(LAUNCHES)
    x_k, _, _ = forward(tc, tp, {"tokens": toks})
    x_p, _, _ = forward(dataclasses.replace(tc, use_kernels=False), tp, {"tokens": toks})
    assert dict(LAUNCHES) == before
    torch.testing.assert_close(x_k, x_p, **TOL)


@pytest.mark.parametrize("name", list(ARCHS))
def test_init_matches_reference_tree(name):
    """The same key paths, shapes and dtypes as the reference's init; the
    constant leaves exactly; the random leaves' spread that of the
    reference's distributions (embedding N(0, 0.02^2); the rest N(0, 1)
    cut at +-2, times fan_in^-1/2)."""
    jc, tc = _cfgs(name, fp32=False)
    jp = _leaves(jax.tree.map(np.asarray, jinit(jc, jax.random.PRNGKey(0))))
    tp = _leaves(init_params(tc, torch.Generator().manual_seed(0)))
    assert sorted(tp) == sorted(jp)
    for path, w in jp.items():
        t = tp[path]
        assert tuple(t.shape) == w.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(w.dtype), path
        leaf = path.rsplit("/", 1)[-1]
        tf = t.float().numpy()
        if leaf == "w0":
            assert np.all(tf == -6.0)
        elif leaf == "u" or leaf.startswith("mu_") or leaf.startswith("b_"):
            assert np.all(tf == 0.0), path
        elif leaf in ("scale", "ln_x_scale"):
            assert np.all(tf == 1.0), path
        else:
            want = 0.02 if leaf == "embedding" else TRUNC_STD * t.shape[-2] ** -0.5
            for arr in (tf, np.asarray(w, np.float32)):
                assert abs(arr.std() / want - 1) < 0.05, (path, arr.std(), want)
            if leaf != "embedding":
                assert np.abs(tf).max() <= 2.0 * t.shape[-2] ** -0.5 * 1.01, path


# arch -> (prefix specs, super-block specs, repeats) of the published config
FULL_PLANS = {
    "internlm2-1.8b": ([], [("attn", "dense")], 24),
    "rwkv6-1.6b": ([], [("rwkv6", "dense")], 24),
    "qwen2.5-3b": ([], [("attn", "dense")], 36),
    "qwen2.5-32b": ([], [("attn", "dense")], 64),
    "minicpm-2b": ([], [("attn", "dense")], 40),
    "musicgen-medium": ([], [("attn", "dense")], 48),
    "internvl2-76b": ([], [("attn", "dense")], 80),
    "deepseek-v2-lite-16b": ([("attn", "dense")], [("attn", "moe")], 26),
    "kimi-k2-1t-a32b": ([("attn", "dense")], [("attn", "moe")], 60),
    "jamba-v0.1-52b": ([], [("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"),
                            ("attn", "moe"), ("mamba", "dense"), ("mamba", "moe"),
                            ("mamba", "dense"), ("mamba", "moe")], 4),
}


@pytest.mark.parametrize("arch", list(FULL_PLANS))
def test_forward_and_decode_state_shapes_on_full_configs(arch):
    """The published configs' trees at a glance (no weights made): the
    segment plans, and the decode state's shapes under the repo's
    ``long_500k`` adaptation (a ring of at most 8192 slots wherever there
    is attention; MLA's compressed cache; Mamba's conv and fp32 scan
    state; RWKV6's fp32 WKV state)."""
    from repro_torch.configs import adapt_for_shape, get_config, shape_for
    cfg = adapt_for_shape(get_config(arch), shape_for("long_500k"))
    assert cfg.segment_plan() == FULL_PLANS[arch]
    prefix, specs, n_rep = FULL_PLANS[arch]
    assert (cfg.window == 8192) == any(m == "attn" for m, _ in prefix + specs)
    state = init_decode_state(cfg, 1, 3, "cpu")
    assert len(state["prefix"]) == len(prefix)
    for i, (mixer, _) in enumerate(specs):
        sub = {k: tuple(v.shape) for k, v in state["stack"][f"sub{i}"].items()}
        if mixer == "attn" and cfg.attn_type == "mla":
            assert sub == {"c_kv": (n_rep, 1, 3, cfg.kv_lora_rank),
                           "k_rope": (n_rep, 1, 3, cfg.qk_rope_dim), "pos": (n_rep, 1, 3)}
        elif mixer == "attn":
            kv = (n_rep, 1, 3, cfg.n_kv_heads, cfg.head_dim)
            assert sub == {"k": kv, "v": kv, "pos": (n_rep, 1, 3)}
        elif mixer == "mamba":
            d_inner = cfg.mamba_expand * cfg.d_model
            assert sub == {"conv": (n_rep, 1, cfg.mamba_conv_width - 1, d_inner),
                           "ssm": (n_rep, 1, d_inner, cfg.mamba_d_state)}
            assert state["stack"][f"sub{i}"]["ssm"].dtype == torch.float32
        else:
            n = cfg.d_model // cfg.n_heads
            assert sub == {"x_prev": (n_rep, 1, cfg.d_model),
                           "wkv": (n_rep, 1, cfg.n_heads, n, n)}
    if arch == "internlm2-1.8b":
        assert cfg.head_dim == 128 and cfg.n_heads // cfg.n_kv_heads == 2
    if arch == "rwkv6-1.6b":
        assert cfg.d_model // cfg.n_heads == 64
    if arch == "kimi-k2-1t-a32b":
        assert cfg.head_dim == 112          # the attention kernel's Dh 112
    small = dataclasses.replace(tget("internlm2-1.8b"), window=128)
    ring = init_decode_state(small, 3, 1000, "cpu")
    assert ring["stack"]["sub0"]["k"].shape == (2, 3, 128, 2, 64)
    assert (ring["stack"]["sub0"]["pos"] == -1).all()
    assert tree_map(lambda t: t.device.type, ring)["stack"]["sub0"]["v"] == "cpu"


@pytest.mark.parametrize("which", ["CONFIG", "REDUCED"])
@pytest.mark.parametrize("arch", list(FULL_PLANS))
def test_configs_match_the_reference_field_for_field(arch, which):
    """Each of the ten published configs and its reduced cut is the
    reference's, field for field (dtypes by name)."""
    import repro.configs as jconfigs
    import repro_torch.configs as tconfigs
    get = "get_config" if which == "CONFIG" else "get_reduced"
    jc, tc = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
    names = [f.name for f in dataclasses.fields(jc)]
    assert [f.name for f in dataclasses.fields(tc)] == names
    for name in names:
        want, got = getattr(jc, name), getattr(tc, name)
        if name == "param_dtype":
            assert str(got) == f"torch.{jnp.dtype(want).name}", name
        else:
            assert got == want, name
