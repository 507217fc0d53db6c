"""The port stands alone: it imports neither ``jax`` nor ``repro``, runs on
the CPU only when asked to, refuses configurations it has not ported, and
makes, runs and serves every architecture of the zoo."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.sim import SimConfig, Simulator

torch.set_num_threads(1)

PKG = Path(repro_torch.__file__).parent
ROOT = PKG.parent.parent


def test_package_imports_with_jax_and_reference_blocked():
    """Every module of the package (and chip_smoke.py's imports) load in a
    fresh interpreter where ``jax`` and ``repro`` cannot be imported."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print(len(names))\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                                         str(ROOT)])}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_no_source_mentions_jax_or_reference_imports():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [str(f) for f in files if pat.search(f.read_text())]
    assert not bad, bad
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    for name in ("kernels.staleness_agg.ops", "kernels.trimmed_agg.ops",
                 "faults.attacks", "faults.plan", "robust.aggregators",
                 "kernels.swa_attention.ops", "kernels.wkv6.ops",
                 "models.transformer", "models.attention", "models.rwkv6",
                 "configs.internlm2_1_8b", "configs.rwkv6_1_6b",
                 "launch.serve", "serve_model", "selection.safa",
                 "selection.oort", "selection.ucb", "selection.contribution",
                 "selection.flips", "selector_zoo", "sweeps", "sweeps.grid",
                 "checkpoint.state", "checkpoint.checkpoint", "chaos_round",
                 "sweeps.results", "sweeps.report", "sweeps.runner",
                 "sweeps.__main__", "telemetry", "telemetry.schema",
                 "telemetry.registry", "telemetry.export", "telemetry.trace",
                 "telemetry.session", "learners.lm", "models.moe",
                 "data.synthetic", "federated_lm", "device", "optim",
                 "optim.sgd", "optim.schedules", "launch.train",
                 "sim.participant_sharding", "sweeps.sharding",
                 "models.shard_hints"):
        assert f"repro_torch.{name}" in names


def test_package_imports_without_a_cycle():
    """The models, the learners and the engine import in either order in a
    fresh interpreter: ``resolve_device`` lives in ``repro_torch.device``,
    and ``repro_torch.sim.engine`` re-exports it."""
    for first in ("repro_torch.models.transformer", "repro_torch.learners",
                  "repro_torch.learners.lm", "repro_torch.sim.engine"):
        code = (f"import {first}\n"
                "from repro_torch.sim.engine import resolve_device\n"
                "from repro_torch.device import resolve_device as r2\n"
                "assert resolve_device is r2\n")
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, (first, out.stderr)


def test_simulator_needs_a_gpu_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SimConfig(n_learners=10, rounds=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulator(cfg)
    assert Simulator(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("override,item", [
    (dict(fast_path=False), 15),
    (dict(shard_participants=2), 14),
])
def test_out_of_slice_configs_name_their_roadmap_item(override, item):
    """Item 15's legacy engine still raises, naming its item; item 14's
    participant sharding is ported: the config is accepted and runs (in a
    plain process, on one shard, as the reference clamps to its one
    device)."""
    if item == 14:
        cfg = SimConfig(n_learners=10, rounds=2, eval_every=1, n_target=3,
                        dynamic_availability=False, **override)
        assert Simulator(cfg, device="cpu").run().summary()["rounds"] == 2
        return
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP\.md queue 1 item {item}\)"):
        SimConfig(**override)


TINY_LM = (("d_ff", 8), ("d_model", 4), ("n_heads", 1), ("n_layers", 1))


@pytest.mark.parametrize("override", [
    dict(benchmark="tokens", model="transformer"),
    dict(benchmark="tokens_skew", model="transformer", selector="flips"),
    dict(benchmark="tokens", model="moe", fused_rounds=False),
    dict(benchmark="tokens", model="rwkv6", use_agg_kernel=True),
])
def test_token_configs_are_accepted_and_run(override):
    """Token data (queue 1 item 2) and the LM learners (item 13's learner),
    ported: the configs that raised before are accepted and run on both
    substrates, FLIPS on token data included."""
    cfg = SimConfig(n_learners=8, rounds=2, eval_every=1, n_target=3,
                    local_steps=1, local_batch=2, dynamic_availability=False,
                    **{"model_params": TINY_LM, **override})
    sim = Simulator(cfg, device="cpu")
    s = sim.run().summary()
    assert s["rounds"] == 2 and 0.0 <= s["final_accuracy"] <= 1.0
    assert torch.isfinite(sim.flat_params).all()


@pytest.mark.parametrize("model", ["transformer", "rwkv6"])
def test_lm_use_kernels_names_its_roadmap_item(model):
    """Training through the forward-only attention / WKV6 kernels is not
    ported: the learner raises where it is built."""
    cfg = SimConfig(benchmark="tokens", model=model,
                    model_params=TINY_LM + (("use_kernels", 1),))
    with pytest.raises(NotImplementedError,
                       match=r"use_kernels=1 .*ROADMAP\.md queue 1 item 13\)"):
        Simulator(cfg, device="cpu")


@pytest.mark.parametrize("override,kind", [
    (dict(model="transformer"), "classifier"),
    (dict(benchmark="tokens", model="mlp"), "tokens"),
])
def test_model_on_the_wrong_data_kind_raises(override, kind):
    """A model meets a benchmark of another sample layout: ValueError
    naming the layout, where the substrate is built (as the reference)."""
    with pytest.raises(ValueError, match=f"provides '{kind}' samples"):
        Simulator(SimConfig(**override), device="cpu")


@pytest.mark.parametrize("override,events", [
    (dict(telemetry=2), 2), (dict(fused_rounds=False, telemetry=1), 0)])
def test_telemetry_configs_are_accepted_and_run(override, events):
    """Telemetry (queue 1 item 12, ported) on both substrates: level 2 on
    the fused pipeline logs a round event a round, level 1 on the flat
    path spans only."""
    cfg = SimConfig(n_learners=10, rounds=2, eval_every=1,
                    dynamic_availability=False, **override)
    acct = Simulator(cfg, device="cpu").run()
    assert acct.summary()["rounds"] == 2
    assert len(acct.round_events) == events


@pytest.mark.parametrize("override", [dict(guard=True),
                                      dict(fused_rounds=False, guard=True)])
def test_guard_configs_are_accepted_and_run(override):
    """The guard (queue 1 item 10, ported) on both substrates: the configs
    that raised before are accepted and run."""
    cfg = SimConfig(n_learners=10, rounds=2, eval_every=1,
                    dynamic_availability=False, **override)
    s = Simulator(cfg, device="cpu").run().summary()
    assert s["rounds"] == 2 and s["quorum_skips"] == 0


def test_fault_plan_with_specs_runs():
    """A fault plan's corruption, drops, replays and crash (queue 1 item
    10, ported) run: the NaN rows of an unguarded run poison its model."""
    from repro_torch.faults import FaultPlan, FaultSpec
    cfg = SimConfig(n_learners=10, rounds=2, eval_every=1,
                    dynamic_availability=False)
    plan = FaultPlan(10, 2, specs=(FaultSpec("nan", prob=0.5),), seed=0)
    sim = Simulator(cfg, device="cpu", fault_plan=plan)
    assert sim.run().summary()["rounds"] == 2
    assert not torch.isfinite(sim.flat_params).all()


@pytest.mark.parametrize("override,server_opt,aggregator,attack", [
    (dict(fused_rounds=False), "fedavg", "saa", "none"),
    (dict(server_opt="yogi"), "yogi", "saa", "none"),
    (dict(aggregator="yogi"), "yogi", "saa", "none"),
    (dict(aggregator="trimmed_mean"), "fedavg", "trimmed_mean", "none"),
    (dict(attack="alie"), "fedavg", "saa", "alie"),
    (dict(fused_rounds=False, attack="alie"), "fedavg", "saa", "alie"),
    (dict(fused_rounds=False, aggregator="krum"), "fedavg", "krum", "none"),
])
def test_slice_configs_accepted(override, server_opt, aggregator, attack):
    """The per-stage flat path, the YoGi server step (also under its old
    name ``aggregator="yogi"``), the robust aggregators and the coordinated
    attacks are in the slice, on both substrates."""
    cfg = SimConfig(**override)
    assert (cfg.server_opt, cfg.aggregator, cfg.attack) == \
        (server_opt, aggregator, attack)


def test_slice_configs_are_accepted():
    SimConfig(selector="priority", saa=True, apt=True, use_agg_kernel=True,
              setting="DL", staleness_threshold=2, prox_mu=0.01,
              selector_params=(("holdoff", 3),), model_params=(("hidden", 64),))
    with pytest.raises(ValueError, match="unknown knob"):
        SimConfig(selector="priority", selector_params=(("hold", 3),))


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "rwkv6-1.6b", "internvl2-76b",
                                  "minicpm-2b", "internlm2-1.8b", "jamba-v0.1-52b",
                                  "qwen2.5-3b", "deepseek-v2-lite-16b",
                                  "kimi-k2-1t-a32b", "musicgen-medium"])
def test_every_architecture_is_made_run_and_served(arch):
    """``get_config`` and ``get_reduced`` load each of the zoo's ten
    architectures, and its reduced config (bf16) is made, run, prefilled,
    scored and served on the CPU: finite values of the expected shapes."""
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models import (decode_step, forward, init_decode_state,
                                    init_params, lm_loss, prefill)
    from repro_torch.serve_model import serve
    full, cfg = get_config(arch), get_reduced(arch)
    assert full.arch_id == arch and cfg.family == full.family
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=gen, dtype=torch.int32)
    batch = {"tokens": toks[:, :8], "labels": toks[:, 1:]}
    n_front = 0
    if cfg.frontend == "vision":
        n_front = cfg.n_frontend_tokens
        batch["frontend_embeds"] = torch.randn((2, n_front, cfg.d_frontend), generator=gen)
    x, aux, _ = forward(cfg, params, batch)
    assert x.shape == (2, n_front + 8, cfg.d_model) and torch.isfinite(x).all()
    logits, states = prefill(cfg, params, batch)
    assert logits.shape == (2, 1, cfg.vocab_size) and torch.isfinite(logits).all()
    loss = lm_loss(cfg, params, batch)
    assert loss.shape == () and torch.isfinite(loss)
    state = init_decode_state(cfg, 2, 9, "cpu")
    step, state = decode_step(cfg, params, state, toks[:, 0],
                              torch.zeros((2,), dtype=torch.int32))
    assert step.shape == (2, cfg.vocab_size) and torch.isfinite(step).all()
    out, last, _ = serve(cfg, params, toks[:, :4], 3)
    assert out.shape == (2, 4) and torch.isfinite(last).all()
    assert ((out >= 0) & (out < cfg.vocab_size)).all()


def test_unknown_architecture_raises_key_error():
    from repro_torch.configs import get_config, get_reduced
    for get in (get_config, get_reduced):
        with pytest.raises(KeyError, match="unknown architecture"):
            get("llama-7b")


def test_moe_ffn_is_accepted_and_runs():
    """The MoE ffn (queue 1 item 13, ported) is made, run and served."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.models import forward, init_decode_state, init_params
    cfg = dataclasses.replace(get_reduced("internlm2-1.8b"), moe=True,
                              n_experts=4, top_k=2, moe_d_ff=64,
                              param_dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    assert params["stack"]["sub0"]["ffn"]["w_gate"].shape[1:] == (
        4, cfg.d_model, 64)
    x, aux, _ = forward(cfg, params,
                        {"tokens": torch.zeros((1, 4), dtype=torch.int64)})
    assert x.shape == (1, 4, cfg.d_model) and float(aux) > 0.0
    assert init_decode_state(cfg, 1, 8, "cpu")["stack"]["sub0"]["k"].shape[0] \
        == cfg.n_layers


def test_serve_path_needs_a_gpu_or_an_explicit_cpu(monkeypatch):
    """The serve entry points default to the GPU and raise without one."""
    from repro_torch import serve_model
    from repro_torch.configs import get_reduced
    from repro_torch.models import init_decode_state
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced("rwkv6-1.6b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_decode_state(cfg, 1, 8)
    monkeypatch.setattr(sys, "argv", ["serve_model", "--arch", "rwkv6-1.6b"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_model.main()
    assert init_decode_state(cfg, 1, 8, "cpu")["stack"]["sub0"]["wkv"].device.type == "cpu"
