"""Shared checks of the port's model zoo (``repro_torch.models``,
``repro_torch.launch.serve``) against the reference's, at an
architecture's ``REDUCED`` config.  The ``tests/test_torch_arch_*.py``
files run them, one set of configs a file.

The reference's ``init_params(cfg, PRNGKey(0))`` is carried across with
``repro_torch.weights.from_jax_tree``; the reference runs its Pallas
kernels in interpret mode.  Every config with attention runs a 128-token
sliding window with ``use_kernels=True`` (GQA layers take the attention
kernel's wrapper, whose plain version runs on the CPU; MLA never does).
Held in fp32 at ``tests/test_torch_lm_serve.py``'s rtol = atol = 1e-4:
forward hidden states and logits at S = 200 (past the window), prefill's
last logits and states, 40 decode steps' logits and the final state, and
greedy tokens wherever the reference's top-2 gap exceeds 1e-3.  In the
port alone, prefill equals decode.  In bf16 the two frameworks round at
other places, so bf16 logits are held by relative L2 (as
``test_torch_lm_serve.py`` holds them).  A vision config's batch carries
``frontend_embeds`` (B, n_frontend_tokens, d_frontend) before its tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
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
from repro_torch.models.transformer import CACHE_KEYS, load_prefill
from repro_torch.weights import from_jax_tree

TOL = dict(rtol=1e-4, atol=1e-4)
WINDOW = 128
# std of N(0, 1) cut at +-2: the reference's dense init is this times fan_in^-1/2
TRUNC_STD = 0.8796


def cfgs(arch, fp32=True, **over):
    """(reference config, port config) of ``arch``'s REDUCED, with the test
    window wherever there is attention and the kernel path on."""
    jc, tc = jget(arch), tget(arch)
    over = {"use_kernels": True, **over}
    if "attn" in jc.block_pattern:
        over.setdefault("window", WINDOW)
    jc, tc = dataclasses.replace(jc, **over), dataclasses.replace(tc, **over)
    if fp32:
        jc = dataclasses.replace(jc, param_dtype=jnp.float32)
        tc = dataclasses.replace(tc, param_dtype=torch.float32)
    return jc, tc


def model(arch, **over):
    """(reference config, port config, reference params, port params), fp32."""
    jc, tc = cfgs(arch, **over)
    jp = jinit(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, from_jax_tree(jax.tree.map(np.asarray, jp))


def tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def batches(cfg, B, S, seed, n_patches=None):
    """The same batch for both packages: (reference's, port's)."""
    rng = np.random.default_rng(seed)
    nb = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        P = cfg.n_frontend_tokens if n_patches is None else n_patches
        nb["frontend_embeds"] = rng.standard_normal((B, P, cfg.d_frontend)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def leaves(tree, prefix=""):
    """{key path: leaf} of nested dicts and lists."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in leaves(sub, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, sub in enumerate(tree) for p, v in leaves(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


def close_trees(got, want, **tol):
    g, w = leaves(got), leaves(want)
    assert sorted(g) == sorted(w)
    for path, wv in w.items():
        np.testing.assert_allclose(g[path].double().numpy(), np.asarray(wv, np.float64),
                                   err_msg=path, **tol)


def check_forward_and_logits(m, S=200):
    jc, tc, jp, tp = m
    jb, tb = batches(jc, 2, S, S)
    xj, auxj, _ = jforward(jc, jp, jb)
    xt, auxt, _ = forward(tc, tp, tb)
    S_all = S + (tc.n_frontend_tokens if tc.frontend == "vision" else 0)
    assert xt.shape == (2, S_all, tc.d_model)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **TOL)
    np.testing.assert_allclose(float(auxt), float(auxj), **TOL)
    lj = jserve.make_logits_fn(jc)(jp, jb)
    lt = tserve.make_logits_fn(tc)(tp, tb)
    assert lt.shape == (2, S_all, tc.padded_vocab)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


def check_prefill(m):
    jc, tc, jp, tp = m
    jb, tb = batches(jc, 2, 200, 1)
    lj, sj = jprefill(jc, jp, jb)
    lt, st = tserve.make_prefill_step(tc)(tp, tb)
    assert lt.shape == (2, 1, tc.vocab_size)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    close_trees(st, jax.tree.map(np.asarray, sj), **TOL)


def check_decode_steps(m, steps=40):
    """``steps`` steps from an empty state: the logits of every step and
    the final state."""
    jc, tc, jp, tp = m
    B = 2
    toks = tokens(jc, B, steps, 2)
    sj = jinit_state(jc, B, steps + 1)
    st = init_decode_state(tc, B, steps + 1, "cpu")
    jstep = jax.jit(jserve.make_decode_step(jc))
    tstep = tserve.make_decode_step(tc)
    for t in range(steps):
        pos = np.full((B,), t, np.int32)
        lj, sj = jstep(jp, sj, jnp.asarray(toks[:, t]), jnp.asarray(pos))
        lt, st = tstep(tp, st, torch.from_numpy(toks[:, t]), torch.from_numpy(pos))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), err_msg=f"step {t}", **TOL)
    close_trees(st, jax.tree.map(np.asarray, sj), **TOL)


def check_greedy(m):
    """Greedy tokens after a 12-token prompt equal the reference's wherever
    its top-2 logit gap exceeds 1e-3 (up to the first near tie, after which
    the two continuations may part)."""
    jc, tc, jp, tp = m
    B, P, n = 4, 12, 24
    prompt = tokens(jc, B, P, 3)
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


def check_prefill_equals_decode(m):
    """A 200-token prompt through ``prefill`` and token by token through
    ``decode_step`` (a 128-slot ring cache wherever there is attention) give
    the same last logits, and the same recurrent states.  A vision config
    prefills its patches and the prompt's first 199 tokens, loads those
    states into a decode state and decodes the last token: its logits
    equal a prefill of the whole.  An MoE config runs groups of one token
    here (``moe_group_size=1``), as a decode step's few tokens do: no
    routed slot is dropped, whereas a prefill's larger groups drop slots
    past an expert's capacity, in both packages."""
    jc, tc, jp, tp = m
    if tc.moe:
        tc = dataclasses.replace(tc, moe_group_size=1)
    B, S = 2, 200
    _, tb = batches(tc, B, S, 4)
    toks = tb["tokens"]
    lp, sp = prefill(tc, tp, tb)
    if tc.frontend == "vision":
        P = tb["frontend_embeds"].shape[1]
        head = dict(tb, tokens=toks[:, :-1])
        _, sh = prefill(tc, tp, head)
        st = load_prefill(init_decode_state(dataclasses.replace(tc, window=None), B,
                                            P + S, "cpu"), sh)
        ld, _ = decode_step(tc, tp, st, toks[:, -1],
                            torch.full((B,), P + S - 1, dtype=torch.int32))
        torch.testing.assert_close(ld, lp[:, 0], **TOL)
        return
    st = init_decode_state(tc, B, S + 1, "cpu")
    for t in range(S):
        ld, st = decode_step(tc, tp, st, toks[:, t], torch.full((B,), t, dtype=torch.int32))
    torch.testing.assert_close(ld, lp[:, 0], **TOL)
    rec = lambda tree: {p: v for p, v in leaves(tree).items()
                        if p.rsplit("/", 1)[-1] not in CACHE_KEYS}
    got, want = rec(st), rec(sp)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        torch.testing.assert_close(got[path], w, msg=path, **TOL)


def check_bf16(arch):
    """bf16 logits held to the reference's bf16 logits by relative L2: within
    3e-2, or within twice the reference's own bf16 distance from its fp32
    model where that is larger (two runs that far from the fp32 model can
    be twice that far apart: jamba's Mamba and MoE layers put the
    reference's bf16 run 0.071 from its fp32 run); and no further from the
    fp32 model than 1.25x the reference's own bf16 run (+ 0.01, in max
    abs)."""
    jc, tc = cfgs(arch, fp32=False)
    jp = jinit(jc, jax.random.PRNGKey(0))
    tp = from_jax_tree(jax.tree.map(np.asarray, jp))
    assert tp["embed"]["embedding"].dtype == torch.bfloat16
    jb, tb = batches(jc, 2, 200, 5)
    lj = np.asarray(jserve.make_logits_fn(jc)(jp, jb), np.float32)
    lt = tserve.make_logits_fn(tc)(tp, tb)
    assert lt.dtype == torch.bfloat16
    lt = lt.float().numpy()
    assert np.isfinite(lt).all()
    jc32 = dataclasses.replace(jc, param_dtype=jnp.float32)
    l32 = np.asarray(jserve.make_logits_fn(jc32)(
        jax.tree.map(lambda a: a.astype(jnp.float32), jp), jb))
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel(lt, lj) <= max(3e-2, 2 * rel(lj, l32))
    assert np.abs(lt - l32).max() <= 1.25 * np.abs(lj - l32).max() + 1e-2


# leaves that the reference makes constant, by name: (value, or None for
# A_log's log(1..N) rows)
CONSTANTS = {"w0": -6.0, "u": 0.0, "scale": 1.0, "ln_x_scale": 1.0, "conv_b": 0.0,
             "dt_bias": 0.0, "D": 1.0, "A_log": None}


def check_init_tree(arch):
    """The same key paths, shapes and dtypes as the reference's init (fp32
    leaves of a bf16 model too); the constant leaves exactly; the random
    leaves' spread that of the reference's distributions (embedding
    N(0, 0.02^2); Mamba's conv_w N(0, 1) cut at +-2, times 0.5; the rest
    N(0, 1) cut at +-2, times fan_in^-1/2)."""
    jc, tc = cfgs(arch, fp32=False)
    jp = leaves(jax.tree.map(np.asarray, jinit(jc, jax.random.PRNGKey(0))))
    tp = leaves(init_params(tc, torch.Generator().manual_seed(0)))
    assert sorted(tp) == sorted(jp)
    for path, w in jp.items():
        t = tp[path]
        assert tuple(t.shape) == w.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(w.dtype), path
        leaf = path.rsplit("/", 1)[-1]
        tf = t.float().numpy()
        if leaf in CONSTANTS or leaf.startswith("mu_") or leaf.startswith("b_"):
            want = CONSTANTS.get(leaf, 0.0)
            if want is None:
                np.testing.assert_allclose(tf, np.asarray(w, np.float32), rtol=1e-6,
                                           err_msg=path)
            else:
                assert np.all(tf == want), path
            continue
        scale = 0.5 if leaf == "conv_w" else t.shape[-2] ** -0.5
        want = 0.02 if leaf == "embedding" else TRUNC_STD * scale
        for arr in (tf, np.asarray(w, np.float32)):
            assert abs(arr.std() / want - 1) < 0.1, (path, arr.std(), want)
        if leaf != "embedding":
            assert np.abs(tf).max() <= 2.0 * scale * 1.01, path


def check_kernel_wrappers(m):
    """On the CPU the path calls the kernels' wrappers (which run the plain
    versions and count no launch); with ``use_kernels`` off it takes the
    plain functions directly, with the same result."""
    jc, tc, jp, tp = m
    _, tb = batches(tc, 1, 130, 6)
    before = dict(LAUNCHES)
    x_k, _, _ = forward(tc, tp, tb)
    x_p, _, _ = forward(dataclasses.replace(tc, use_kernels=False), tp, tb)
    assert dict(LAUNCHES) == before
    torch.testing.assert_close(x_k, x_p, **TOL)
