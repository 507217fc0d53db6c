"""The port stands alone: it imports neither ``jax`` nor ``repro``, runs on
the CPU only when asked to, and refuses configurations it has not ported."""
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
                 "telemetry.session"):
        assert f"repro_torch.{name}" in names


def test_simulator_needs_a_gpu_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SimConfig(n_learners=10, rounds=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulator(cfg)
    assert Simulator(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("override,item", [
    (dict(fast_path=False), 15),
    (dict(shard_participants=2), 14),
    (dict(benchmark="tokens", model="transformer"), 2),
    (dict(model="transformer"), 13),
    (dict(benchmark="tokens", selector="flips"), 2),
])
def test_out_of_slice_configs_name_their_roadmap_item(override, item):
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP\.md queue 1 item {item}\)"):
        SimConfig(**override)


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


@pytest.mark.parametrize("override,part", [
    (dict(block_pattern=("mamba",)), "mixer 'mamba'"),
    (dict(attn_type="mla"), "attention 'mla'"),
    (dict(moe=True, n_experts=4, top_k=2, moe_d_ff=64), "ffn 'moe'"),
    (dict(frontend="vision"), "frontend 'vision'"),
])
def test_unported_model_parts_name_their_roadmap_item(override, part):
    """The model zoo's mixers, ffns and frontend that are not ported raise
    where a model is made, run or served."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.models import forward, init_decode_state, init_params
    cfg = dataclasses.replace(get_reduced("internlm2-1.8b"), **override)
    pat = rf"{part} is not ported .*ROADMAP\.md queue 1 item 13\)"
    with pytest.raises(NotImplementedError, match=pat):
        init_params(cfg, torch.Generator())
    with pytest.raises(NotImplementedError, match=pat):
        forward(cfg, {}, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    with pytest.raises(NotImplementedError, match=pat):
        init_decode_state(cfg, 1, 8, "cpu")


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "deepseek-v2-lite-16b",
                                  "jamba-v0.1-52b", "musicgen-medium"])
def test_unported_architectures_name_their_roadmap_item(arch):
    from repro_torch.configs import get_config, get_reduced
    for get in (get_config, get_reduced):
        with pytest.raises(NotImplementedError,
                           match=r"ROADMAP\.md queue 1 item 13\)"):
            get(arch)


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
