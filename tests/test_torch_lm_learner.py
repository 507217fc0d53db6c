"""The federated LM learner in the port (``repro_torch.learners.lm``,
``repro_torch.models.moe``, ``transformer.lm_loss``, the flat layout over
parameter trees) held against the JAX package on the CPU, at the small
size of ``tests/test_model_zoo.py`` (``TINY_LM``: one layer, d_model 4,
one head, d_ff 8; vocab 1024 and S = 64 are the token benchmark's).

Tolerances (fp32; XLA and torch sum in other orders):
  - the flat layout, the initial rows and the unflattened trees: exact;
  - losses, per-sequence losses and NLL: rtol 1e-5, atol 1e-6; next-token
    accuracy within one token of the (N * S) scored;
  - gradients: atol 2e-5 of the largest reference element, rtol 1e-4;
  - one cohort's deltas (two local steps): atol 2e-4 of the largest
    reference element, rtol 1e-4; its losses and l2 stats rtol 1e-5;
  - a round, from the reference's params: host records ``==``, params
    rtol 1e-4 / atol 2e-5 of the largest reference param; the port's own
    l2 stats rtol 1e-4 of the reference's;
  - inside the port, fused == flat == K = 2 and batched == serial: bit for
    bit.

The two-step and whole-round gaps are of fp32 conditioning, not of a
formula: at d_model 4 a 1e-7 relative perturbation of the initial row
moves the port's own two-step deltas by more than a 1e-5 share of the
largest delta (``test_cohort_deltas_match_reference`` measures it), and
the port and the reference differ by no more.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.learners import MODEL_TABLE as J_MODELS
from repro.learners import DataMeta as JMeta
from repro.learners import build_model as j_build_model
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.sim import SimConfig as JConfig
from repro.sim import Simulator as JSimulator
from repro.sim import learner as jln
from repro_torch.core import aggregation as tagg
from repro_torch.learners import MODEL_TABLE, DataMeta, build_model
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.sim import SimConfig, Simulator, Substrate
from repro_torch.sim import learner as tln
from repro_torch.sim.pipeline import RoundPipeline
from repro_torch.sweeps import SweepRunner
from repro_torch.sweeps.grid import Cell
from repro_torch.weights import from_flat, from_jax_params, from_jax_tree

torch.set_num_threads(1)

TINY_LM = (("d_ff", 8), ("d_model", 4), ("n_heads", 1), ("n_layers", 1))
LM_BASE = dict(benchmark="tokens", model="transformer", model_params=TINY_LM,
               n_learners=16, rounds=4, eval_every=2, n_target=4,
               local_steps=1, local_batch=4, saa=True,
               dynamic_availability=False, seed=0)
MODELS = {"transformer": (), "transformer window 8": (("window", 8),),
          "rwkv6": (), "moe": ()}
HOST = ("round_idx", "sim_time", "n_selected", "n_fresh", "n_stale",
        "resource_used", "resource_wasted", "unique_participants")
VOCAB, SEQ = 1024, 64


def _model(name):
    return name.split()[0]


def _pair(name):
    """(reference ModelFns, port ModelFns) of one LM at TINY_LM."""
    knobs = tuple(sorted(TINY_LM + MODELS[name]))
    jm = j_build_model(_model(name), J_MODELS.normalize_params(
        _model(name), knobs), JMeta(kind="tokens", vocab=VOCAB, seq_len=SEQ))
    tm = build_model(_model(name), MODEL_TABLE.normalize_params(
        _model(name), knobs), DataMeta(kind="tokens", vocab=VOCAB,
                                       seq_len=SEQ))
    return jm, tm


def _ref_params(jm, seed=0):
    """The reference's initial tree (numpy leaves) and flat row."""
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    return jp, np.asarray(jagg.flatten_update(jp)[0])


def _path_name(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _tokens(seed, *shape):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, VOCAB, shape).astype(np.int32),
            rng.integers(0, VOCAB, shape).astype(np.int32))


# ---------------------------------------------------------------------------
# The flat layout over trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["transformer", "rwkv6", "moe"])
def test_flat_layout_matches_reference(name):
    """Names, shapes and offsets of the port's spec map onto the
    reference's leaves (``jax.tree.flatten`` order), for the port's own
    initial tree and for the reference's carried across; the unflattened
    reference row equals the reference tree leaf by leaf, and comes back
    batched under a leading axis."""
    jm, tm = _pair(name)
    jp, flat0 = _ref_params(jm)
    _, j_shapes, _, j_offsets = jagg.make_flat_spec(jp)
    j_names = tuple(_path_name(p) for p, _ in
                    jax.tree_util.tree_flatten_with_path(jp)[0])
    own = tagg.make_flat_spec(tm.init(torch.Generator().manual_seed(0)))
    carried = tagg.make_flat_spec(from_jax_tree(jp))
    for spec in (own, carried):
        assert spec.names == j_names
        assert spec.shapes == tuple(tuple(s) for s in j_shapes)
        assert spec.offsets == j_offsets
    assert own == carried and hash(own) == hash(carried)
    assert tagg.flat_dim(own) == flat0.shape[0]
    np.testing.assert_array_equal(from_jax_params(jp), flat0)
    tree = tagg.unflatten_update(torch.from_numpy(flat0.copy()), own)
    assert tree.keys() == jp.keys() and tree["prefix"] == [] == jp["prefix"]
    leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in leaves:
        got = tree
        for k in path:
            got = got[getattr(k, "key", getattr(k, "idx", None))]
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), leaf)
    rows = torch.from_numpy(np.stack([flat0, 2 * flat0, np.zeros_like(flat0)]))
    batched = tagg.unflatten_update(torch.nn.functional.pad(rows, (0, 5)), own)
    w = batched["stack"]["sub0"]["norm1"]["scale"]
    assert w.shape == (3, 1, 4)
    np.testing.assert_array_equal(w[1].numpy(),
                                  2 * jp["stack"]["sub0"]["norm1"]["scale"])


def test_mlp_layout_is_a_flat_dict():
    """The MLP's spec keeps its names and offsets: its flat rows, and
    every checkpoint of them, are laid out as before."""
    params = tln.mlp_init(torch.Generator().manual_seed(0), 64, 35)
    spec = tagg.make_flat_spec(params)
    assert spec.names == ("b1", "b2", "w1", "w2")
    assert spec.offsets == (0, 128, 163, 8355, 12835)
    back = tagg.unflatten_update(tagg.flatten_update(params)[0], spec)
    assert back.keys() == params.keys()
    assert all(torch.equal(back[k], params[k]) for k in params)


# ---------------------------------------------------------------------------
# Losses, gradients and the evaluation on the reference's weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(MODELS))
def test_loss_grad_eval_match_reference(name):
    """Two learners' rows in one batched call (the port's contract) against
    the reference's one-learner loss, gradient and evaluation."""
    jm, tm = _pair(name)
    jp, flat0 = _ref_params(jm)
    spec = tagg.make_flat_spec(from_jax_tree(jp))
    x, y = _tokens(1, 2, 4, SEQ)
    step = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))
    p = torch.from_numpy(np.stack([flat0, flat0 * 1.01]))
    p.requires_grad_(True)
    mean, per = tm.loss(tagg.unflatten_update(p, spec),
                        torch.from_numpy(x), torch.from_numpy(y).long())
    (g,) = torch.autograd.grad(mean.sum(), p)
    assert mean.shape == (2,) and per.shape == (2, 4)
    for i, scale in enumerate((1.0, 1.01)):
        jpi = jax.tree.map(lambda a: a * np.float32(scale), jp)
        (l_ref, per_ref), g_ref = step(jpi, x[i], y[i])
        g_ref = np.asarray(jagg.flatten_update(g_ref)[0])
        np.testing.assert_allclose(mean[i].item(), float(l_ref),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(per[i].detach().numpy(),
                                   np.asarray(per_ref), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g[i].numpy(), g_ref, rtol=1e-4,
                                   atol=2e-5 * np.abs(g_ref).max())
    xe, ye = _tokens(2, 3, SEQ)
    acc, nll = tm.evaluate(
        tagg.unflatten_update(p.detach()[:1], spec),
        torch.from_numpy(xe)[None], torch.from_numpy(ye).long()[None])
    acc_ref, nll_ref = jax.jit(jm.evaluate)(jp, xe, ye)
    assert abs(acc.item() - float(acc_ref)) <= 1.0 / (3 * SEQ)
    np.testing.assert_allclose(nll.item(), float(nll_ref), rtol=1e-5)


@pytest.mark.parametrize("over", [
    dict(moe=True, n_experts=4, top_k=2, moe_d_ff=8),
    dict(loss_chunk=16, window=8),
])
def test_lm_loss_matches_reference(over):
    """``transformer.lm_loss`` (the MoE balance term, the chunked loss)
    against the reference's on the reference's weights."""
    common = dict(n_layers=1, d_model=8, n_heads=2, n_kv_heads=2, d_ff=8,
                  vocab_size=64)
    common.update(over)
    jc = jtf.ModelConfig(param_dtype=jnp.float32, **common)
    tc = ttf.ModelConfig(param_dtype=torch.float32, **common)
    jp = jax.tree.map(np.asarray, jtf.init_params(jc, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 64, (2, 32)).astype(np.int32)
    labels = rng.integers(0, 64, (2, 32)).astype(np.int32)
    want = jax.jit(lambda p: jtf.lm_loss(jc, p, {"tokens": toks,
                                                 "labels": labels}))(jp)
    got = ttf.lm_loss(tc, from_jax_tree(jp), {
        "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    if over.get("moe"):
        aux_ref = jax.jit(lambda p: jtf.forward(jc, p, {"tokens": toks})[1])(jp)
        _, aux, _ = ttf.forward(tc, from_jax_tree(jp),
                                {"tokens": torch.from_numpy(toks)})
        assert float(aux_ref) > 0
        np.testing.assert_allclose(aux.item(), float(aux_ref), rtol=1e-5)


def test_router_topk_breaks_ties_as_reference():
    """Equal gates keep the lower expert index first (``jax.lax.top_k``),
    and the renormalized gates match."""
    logits = np.array([[1.0, 1.0, 0.5, 1.0], [0.0, 2.0, 2.0, -1.0],
                       [3.0, 3.0, 3.0, 3.0], [0.1, 0.7, 0.3, 0.5]],
                      np.float32)
    for k in (1, 2, 3):
        v_ref, i_ref = jmoe.router_topk(jnp.asarray(logits), k)
        v, i = tmoe.router_topk(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
        np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-6)


@pytest.mark.parametrize("name", ["transformer", "rwkv6", "moe"])
def test_backward_has_no_indexed_accumulation(name):
    """The training step's autograd graph holds no op whose backward adds
    many terms into one element by index (an embedding or indexing
    backward, index_add, scatter_add, index_put): token lookups and the
    gold logit are one-hot products, so on the card no float atomics
    decide a gradient's bits.  The MoE's gathers read each real position
    once (checked here: every index in them is distinct, bar the pad)."""
    _, tm = _pair(name)
    params = tm.init(torch.Generator().manual_seed(0))
    flat, spec = tagg.flatten_update(params)
    p = flat.repeat(2, 1).requires_grad_(True)
    x, y = _tokens(5, 2, 4, SEQ)
    mean, _ = tm.loss(tagg.unflatten_update(p, spec), torch.from_numpy(x),
                      torch.from_numpy(y).long())
    seen, stack = set(), [mean.sum().grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        stack.extend(f for f, _ in fn.next_functions)
    names = {type(fn).__name__ for fn in seen}
    bad = {n for n in names if n.startswith((
        "Embedding", "Index", "ScatterAdd", "IndexAdd", "IndexPut"))}
    assert not bad, bad
    assert ("GatherBackward0" in names) == (name == "moe")
    if name == "moe":
        g, n, e, k = 1, 4 * SEQ, 4, 2
        cap = int(max(k, n * k * 1.25 / e))
        logits = torch.randn((g, n, e), generator=torch.Generator()
                             .manual_seed(1))
        _, idx = tmoe.router_topk(logits, k)
        oh = tmoe._one_hot(idx.reshape(g, n * k), e, torch.int32)
        pos = ((torch.cumsum(oh, 1) - 1) * oh).sum(-1)
        place = torch.where(pos < cap, idx.reshape(g, n * k) * cap + pos,
                            e * cap)
        real = place[place < e * cap]
        assert real.unique().numel() == real.numel()


# ---------------------------------------------------------------------------
# One cohort's local training against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["transformer", "moe"])
def test_cohort_deltas_match_reference(name):
    """Three learners, two local steps each, from one global row: the
    port's batched ``local_train_cohort`` against the reference's
    ``local_train_flat`` learner by learner."""
    jm, tm = _pair(name)
    jp, flat0 = _ref_params(jm)
    spec_t = tagg.make_flat_spec(from_jax_tree(jp))
    spec_j = jagg.make_flat_spec(jp)
    x, y = _tokens(6, 3, 2, 4, SEQ)
    deltas, losses, l2s = tln.local_train_cohort(
        torch.from_numpy(flat0.copy()), torch.from_numpy(x),
        torch.from_numpy(y).long(), spec=spec_t, lr=0.05, prox_mu=0.01,
        loss=tm.loss, out_dim=flat0.shape[0] + 7)
    assert deltas.shape == (3, flat0.shape[0] + 7)
    assert not deltas[:, flat0.shape[0]:].any()
    step = jax.jit(lambda f, xs, ys: jln.local_train_flat(
        f, xs, ys, spec=spec_j, lr=0.05, prox_mu=0.01, loss=jm.loss))
    # the conditioning behind the tolerance: the port's own deltas from the
    # initial row perturbed by 1e-7 (relative) part by more than 1e-5 of
    # the largest delta
    noise = np.random.default_rng(7).standard_normal(flat0.shape)
    bumped = (flat0 * (1 + 1e-7 * noise)).astype(np.float32)
    moved = tln.local_train_cohort(
        torch.from_numpy(bumped), torch.from_numpy(x),
        torch.from_numpy(y).long(), spec=spec_t, lr=0.05, prox_mu=0.01,
        loss=tm.loss)[0]
    spread = (moved - deltas[:, :flat0.shape[0]]).abs().max().item()
    assert spread > 1e-5 * deltas.abs().max().item()
    for i in range(3):
        d_ref, l_ref, l2_ref = step(jnp.asarray(flat0), x[i], y[i])
        d_ref = np.asarray(d_ref)
        np.testing.assert_allclose(deltas[i, :flat0.shape[0]].numpy(), d_ref,
                                   rtol=1e-4, atol=2e-4 * np.abs(d_ref).max())
        np.testing.assert_allclose(losses[i].item(), float(l_ref), rtol=1e-5)
        np.testing.assert_allclose(l2s[i].item(), float(l2_ref), rtol=1e-5)


# ---------------------------------------------------------------------------
# Whole runs against the reference, round by round
# ---------------------------------------------------------------------------


def _host(rec):
    return tuple(getattr(rec, f) for f in HOST)


@pytest.mark.parametrize("model,extra", [
    ("transformer", {}), ("rwkv6", {}), ("moe", {}),
    ("transformer", dict(selector="oort", benchmark="tokens_skew")),
])
def test_rounds_match_reference_per_stage(model, extra):
    """LM_BASE from the reference's ``flat_params0``: each round starts
    from the reference's params, the port's fused round (``pipe.step``)
    against the reference's per-stage flat path driven stage by stage.  An
    Oort run is fed the reference's l2 stats (its decisions then compare
    exactly), and its own are held to them."""
    kw = {**LM_BASE, "model": model, **extra}
    ref = JSimulator(JConfig(**{**kw, "fused_rounds": False}))
    cfg = SimConfig(**kw)
    sim = Simulator(cfg, Substrate.build(cfg, flat_params0=from_flat(
        ref.substrate.flat_params0)), device="cpu")
    pipe = RoundPipeline(sim)
    d = pipe.d
    inject, own, device_round = {}, {}, pipe._device_round

    def run_round(r, work):
        l2 = device_round(r, work)
        if l2 is None:
            return l2
        surv = sim.survivors(work.plans[0])[0]
        own[r] = (l2.numpy().copy(), inject[r][surv])
        return torch.from_numpy(inject[r][surv])
    pipe._device_round = run_round
    recorded = 0
    for r in range(kw["rounds"]):
        pipe.params[0, :d] = torch.from_numpy(np.array(ref.flat_params))
        plan = ref._begin_round(r)
        if plan is not None:
            deltas, losses, l2s = ref._train(plan)
            inject[r] = np.asarray(l2s, np.float32)
        rec, = pipe.step(r)
        assert (plan is None) == (rec is None)
        if plan is None:
            continue
        t_end, fresh, stale, taus, lids = ref._collect_updates(
            r, plan, deltas, losses, l2s)
        if fresh or stale:
            ref._apply_update(ref._aggregate(r, lids, fresh, stale, taus))
        ref_rec = ref._record_round(r, plan.t_now, t_end, len(plan.chosen),
                                    len(fresh), len(stale))
        assert _host(rec) == _host(ref_rec)
        want = np.asarray(ref.flat_params)
        np.testing.assert_allclose(pipe.params[0, :d].numpy(), want,
                                   rtol=1e-4, atol=2e-5 * np.abs(want).max())
        recorded += 1
    pipe.finalize()
    assert recorded == kw["rounds"]
    assert ref.rng.bit_generator.state == sim.rng.bit_generator.state
    for mine, theirs in own.values():
        np.testing.assert_allclose(mine, theirs, rtol=1e-4)


# the example's cell (``repro_torch.federated_lm`` / ``examples/federated_lm.py``)
# with rwkv6 at its default knobs; the plain server path on both sides
RWKV6_CELL = dict(benchmark="tokens_skew", model="rwkv6", model_params=(),
                  n_learners=32, eval_every=7, n_target=6, local_steps=2,
                  local_batch=4, saa=True, dynamic_availability=False, seed=0)


def test_rwkv6_default_knobs_part_under_a_1e7_perturbation():
    """rwkv6 at its default knobs is chaotic in fp32, in both packages: on
    the CPU, runs from the reference's initial row and from that row
    perturbed by 1e-7 (relative, seeded) keep equal host records, the port
    agrees with the reference within the card's params tolerance (rtol
    1e-3, atol 1e-4) after one round, and after four rounds each package's
    perturbed run parts from its own past that tolerance."""
    runs = {}
    for rounds, row in ((1, "row"), (4, "row"), (4, "bumped")):
        ref_cfg = JConfig(**RWKV6_CELL, rounds=rounds)
        ref_sub = JSimulator(ref_cfg).substrate
        p0 = np.asarray(ref_sub.flat_params0)
        if row == "bumped":
            noise = np.random.default_rng(0).standard_normal(p0.shape)
            p0 = (p0 * (1 + 1e-7 * noise)).astype(np.float32)
        ref = JSimulator(ref_cfg, dataclasses.replace(ref_sub, flat_params0=p0))
        cfg = SimConfig(**RWKV6_CELL, rounds=rounds)
        port = Simulator(cfg, Substrate.build(cfg, flat_params0=from_flat(p0)),
                         device="cpu")
        recs = [[_host(r) for r in sim.run().records] for sim in (ref, port)]
        assert recs[0] == recs[1]
        runs[rounds, row] = (recs[0], np.asarray(ref.flat_params),
                             port.flat_params.numpy())
    assert runs[4, "row"][0] == runs[4, "bumped"][0]
    np.testing.assert_allclose(runs[1, "row"][2], runs[1, "row"][1],
                               rtol=1e-3, atol=1e-4)
    for pkg in (1, 2):
        a, b = runs[4, "row"][pkg], runs[4, "bumped"][pkg]
        assert not np.allclose(b, a, rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# Inside the port: bit for bit
# ---------------------------------------------------------------------------


def _bits(acct, sim):
    return ([tuple(repr(v) for v in dataclasses.astuple(r))
             for r in acct.records], sim.flat_params.view(torch.int32).clone())


def _same(a, b):
    return a[0] == b[0] and torch.equal(a[1], b[1])


@pytest.mark.parametrize("model", ["transformer", "rwkv6", "moe"])
def test_fused_equals_flat_equals_chunked_bitwise(model):
    """The kernel route (d_pad rows, pad columns zero) fused at K = 1 ==
    the per-stage flat path == K = 2 chunks, records and params."""
    kw = dict(LM_BASE, model=model, use_agg_kernel=True, setting="DL",
              deadline=40.0)
    runs = {}
    for label, over in (("fused", {}), ("flat", dict(fused_rounds=False)),
                        ("K=2", dict(rounds_per_dispatch=2))):
        sim = Simulator(SimConfig(**kw, **over), device="cpu")
        if label == "fused":
            pipe = RoundPipeline(sim)
            acct, = pipe.run()
            assert pipe.d_pad % 2048 == 0 and pipe.d_pad > pipe.d
            assert not pipe.params[:, pipe.d:].any()
        else:
            acct = sim.run()
        runs[label] = _bits(acct, sim)
    assert _same(runs["fused"], runs["flat"])
    assert _same(runs["fused"], runs["K=2"])


def test_lm_sweep_batched_equals_serial_bitwise():
    """A 2-cell LM sweep batch (two seeds, so two substrates share the
    batch's training rows) == each cell run alone."""
    cells = [Cell(f"seed{s}", (("seed", s),),
                  SimConfig(**dict(LM_BASE, seed=s, rounds=3)))
             for s in (0, 1)]
    runner = SweepRunner(cells, device="cpu")
    res = runner.run()
    assert len(runner.batches()) == 1
    for i, c in enumerate(cells):
        sim = Simulator(c.config, device="cpu")
        acct = sim.run()
        assert _same(_bits(res[i].acct, runner.sims[i]), _bits(acct, sim))
