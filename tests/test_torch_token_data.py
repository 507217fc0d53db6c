"""Token data in the port (``repro_torch.data.synthetic``, the token half
of ``repro_torch.sim.partition``, the token branch of ``Substrate.build``,
FLIPS's token adapter, the sweep CLI's ``--benchmark`` / ``--model`` /
``--list-models``) held against the JAX package on the CPU.

All of it is numpy with the reference's draw order, so it is held with
``np.array_equal`` (dtypes too) and equal generator states: no tolerance.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro.learners import describe_models as j_describe_models
from repro.selection import flips as jflips
from repro.sim import SimConfig as JConfig
from repro.sim import partition as jpart
from repro.sim.engine import Substrate as JSubstrate
from repro_torch.data import synthetic as tsyn
from repro_torch.learners import describe_models
from repro_torch.selection import build_selector, flips
from repro_torch.sim import SimConfig, Substrate
from repro_torch.sim import partition as tpart
from repro_torch.sim.engine import SharedData
from repro_torch.weights import from_flat

torch.set_num_threads(1)

TINY_LM = (("d_ff", 8), ("d_model", 4), ("n_heads", 1), ("n_layers", 1))


def _arrays_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("vocab,batch,seq_len,seed", [
    (1024, 4, 64, 0), (50, 3, 9, 7), (7, 2, 1, 1)])
def test_token_batches_match_reference(vocab, batch, seq_len, seed):
    ref = jsyn.token_batches(vocab, batch, seq_len, seed=seed)
    port = tsyn.token_batches(vocab, batch, seq_len, seed=seed)
    for _ in range(3):
        a, b = next(port), next(ref)
        assert a.keys() == b.keys()
        for k in a:
            _arrays_equal(a[k], b[k])


@pytest.mark.parametrize("skew", [0.0, 0.5, 2.0])
@pytest.mark.parametrize("vocab,n_learners,spl,seq_len,seed", [
    (1024, 5, 48, 64, 0), (64, 3, 7, 11, 9)])
def test_federated_token_shards_match_reference(vocab, n_learners, spl,
                                                seq_len, seed, skew):
    ref = jsyn.federated_token_shards(vocab, n_learners, spl, seq_len,
                                      seed=seed, skew=skew)
    port = tsyn.federated_token_shards(vocab, n_learners, spl, seq_len,
                                       seed=seed, skew=skew)
    assert len(port) == len(ref) == n_learners
    for a, b in zip(port, ref):
        assert a.keys() == b.keys()
        for k in a:
            _arrays_equal(a[k], b[k])


@pytest.mark.parametrize("name", ["tokens", "tokens_skew"])
@pytest.mark.parametrize("n_learners,seed", [(16, 0), (5, 3)])
def test_make_token_dataset_matches_reference(name, n_learners, seed):
    assert tpart.TOKEN_BENCHMARKS == jpart.TOKEN_BENCHMARKS
    ref = jpart.make_token_dataset(name, n_learners, seed)
    port = tpart.make_token_dataset(name, n_learners, seed)
    for f in ("x_train", "y_train", "x_test", "y_test"):
        _arrays_equal(getattr(port, f), getattr(ref, f))
    assert len(port.shards) == len(ref.shards) == n_learners
    for a, b in zip(port.shards, ref.shards):
        _arrays_equal(a, b)
    assert (port.name, port.kind, port.vocab, port.n_classes) == \
        (ref.name, ref.kind, ref.vocab, ref.n_classes) == \
        (name, "tokens", 1024, 1024)


@pytest.mark.parametrize("name", ["speech", "cifar10", "openimage", "tokens",
                                  "tokens_skew"])
def test_benchmark_kind_matches_reference(name):
    assert tpart.benchmark_kind(name) == jpart.benchmark_kind(name)


def test_unknown_benchmark_raises_as_reference():
    for kind in (tpart.benchmark_kind, jpart.benchmark_kind):
        with pytest.raises(ValueError, match="unknown benchmark 'text'"):
            kind("text")


@pytest.mark.parametrize("name,model,n_learners,seed,dynamic", [
    ("tokens", "transformer", 16, 0, False),
    ("tokens_skew", "rwkv6", 12, 5, True),
    ("tokens", "moe", 9, 2, True),
])
def test_substrate_build_matches_reference(name, model, n_learners, seed,
                                           dynamic):
    """The token branch draws no data from the substrate's generator:
    profiles and traces take its first draws, as in the reference; the
    rest of the substrate, and the flat initial row carried across, equal
    the reference's."""
    kw = dict(benchmark=name, model=model, model_params=TINY_LM,
              n_learners=n_learners, seed=seed, dynamic_availability=dynamic)
    ref = JSubstrate.build(JConfig(**kw))
    port = Substrate.build(SimConfig(**kw),
                           flat_params0=from_flat(ref.flat_params0))
    assert port.key == ref.key
    for f in ("x_train", "y_train", "x_test", "y_test"):
        _arrays_equal(getattr(port.data, f), getattr(ref.data, f))
    assert all(np.array_equal(a, b)
               for a, b in zip(port.data.shards, ref.data.shards))
    assert [dataclasses.astuple(p) for p in port.base_profiles] == \
        [dataclasses.astuple(p) for p in ref.base_profiles]
    for f in ("lens", "offsets", "boundaries", "states", "_packed"):
        assert np.array_equal(getattr(port.trace_bank, f),
                              getattr(ref.trace_bank, f))
    assert port.rng_state == ref.rng_state
    assert dataclasses.asdict(port.meta) == dataclasses.asdict(ref.meta) == \
        dict(kind="tokens", feature_dim=0, n_classes=0, vocab=1024, seq_len=64)
    _arrays_equal(port.flat_params0, np.asarray(ref.flat_params0))


@pytest.mark.parametrize("top_k", [64, 16, 2000])
@pytest.mark.parametrize("name,seed", [("tokens", 0), ("tokens_skew", 4)])
def test_token_histograms_match_reference(name, seed, top_k):
    j_data = jpart.make_token_dataset(name, 20, seed)
    t_data = tpart.make_token_dataset(name, 20, seed)
    _arrays_equal(flips.token_histograms(t_data, top_k=top_k),
                  jflips.token_histograms(j_data, top_k=top_k))
    _arrays_equal(flips.learner_histograms(t_data, top_k=top_k),
                  jflips.learner_histograms(j_data, top_k=top_k))


@pytest.mark.parametrize("seed,n_clusters", [(0, 4), (3, 6)])
def test_flips_clusters_match_reference_on_tokens_skew(seed, n_clusters):
    """FLIPS on ``tokens_skew``: the substrate's histograms, the k-means
    assignment and the built selector's clusters equal the reference's."""
    kw = dict(benchmark="tokens_skew", model="transformer",
              model_params=TINY_LM, n_learners=24, seed=seed,
              selector="flips", selector_params=(("n_clusters", n_clusters),))
    j_sub = JSubstrate.build(JConfig(**kw))
    t_sub = Substrate.build(SimConfig(**kw),
                            flat_params0=from_flat(j_sub.flat_params0))
    h = flips.learner_histograms(t_sub.data)
    _arrays_equal(h, jflips.learner_histograms(j_sub.data))
    _arrays_equal(flips.kmeans_labels(h, n_clusters, seed),
                  jflips.kmeans_labels(h, n_clusters, seed))
    from repro.selection import build_selector as j_build_selector
    port = build_selector(SimConfig(**kw), substrate=t_sub)
    ref = j_build_selector(JConfig(**kw), substrate=j_sub)
    _arrays_equal(port.cluster_of, ref.cluster_of)
    assert len(set(port.cluster_of.tolist())) > 1


def test_shared_data_batches_keep_token_rows():
    """The device copy keeps tokens integer, and a round's batches carry a
    sequence a sample and a label row a sample: (R, steps, batch, S)."""
    cfg = SimConfig(benchmark="tokens", model="transformer",
                    model_params=TINY_LM, n_learners=6, seed=1)
    sub = Substrate.build(cfg)
    x_tr, y_tr, x_te, y_te = sub.device_data("cpu")
    assert (x_tr.dtype, y_tr.dtype, x_te.dtype, y_te.dtype) == \
        (torch.int32, torch.int64, torch.int32, torch.int64)

    class Sim:
        substrate = sub
    data = SharedData([Sim()], torch.device("cpu"))
    bidx = torch.tensor([[0, 5, 47, 3, 9, 1], [48, 49, 50, 51, 52, 53]])
    bx, by = data.batches(bidx, 2, 3)
    assert bx.shape == by.shape == (2, 2, 3, 64)
    assert torch.equal(bx[1, 0, 2], torch.from_numpy(sub.data.x_train[50]))
    assert torch.equal(by[0, 1, 0], torch.from_numpy(
        sub.data.y_train[3]).long())


def test_describe_models_lists_the_reference_zoo():
    """The table's models, families, data kinds and knobs are the
    reference's (the kernel column names the port's kernels)."""
    def rows(text):
        lines = text.split("\n\n")[0].splitlines()[1:]
        return [line.split()[:3] for line in lines]
    port, ref = describe_models(), j_describe_models()
    assert rows(port) == rows(ref)
    assert [r[0] for r in rows(port)] == ["mlp", "transformer", "moe", "rwkv6"]
    for knob in ("window=0", "n_experts=4", "moe_d_ff=64", "hidden=128"):
        assert knob in port
    assert port.split("\n\n")[1] == ref.split("\n\n")[1]


def test_sweep_cli_runs_an_lm_grid(capsys):
    """``--benchmark tokens --model ...`` adds the model axis to the smoke
    grid, drops its classifier mapping and runs batched == serial; the
    grid's cells carry the token benchmark."""
    from repro_torch.sweeps import __main__ as cli
    cli.main(["--list-models"])
    assert "transformer" in capsys.readouterr().out
    spec = cli.demo_spec(True)
    spec.base = dict(spec.base, n_learners=10, rounds=2, eval_every=1,
                     n_target=3, local_steps=1, local_batch=2)
    spec.axes = {"policy": ["random"]}
    orig = cli.demo_spec
    cli.demo_spec = lambda smoke: spec
    try:
        cli.main(["--smoke", "--device", "cpu", "--benchmark", "tokens",
                  "--model", "transformer,rwkv6"])
    finally:
        cli.demo_spec = orig
    out = capsys.readouterr().out
    assert "2 cells" in out and "model=rwkv6" in out
    assert "per-cell metrics equal" in out
