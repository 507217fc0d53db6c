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
    assert "repro_torch.kernels.staleness_agg.ops" in names


def test_simulator_needs_a_gpu_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SimConfig(n_learners=10, rounds=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulator(cfg)
    assert Simulator(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("override,item", [
    (dict(fast_path=False), 15),
    (dict(aggregator="trimmed_mean"), 11),
    (dict(attack="alie"), 10),
    (dict(guard=True), 10),
    (dict(telemetry=2), 12),
    (dict(rounds_per_dispatch=4), 8),
    (dict(shard_participants=2), 14),
    (dict(benchmark="tokens", model="transformer"), 2),
    (dict(model="transformer"), 13),
    (dict(selector="oort"), 6),
    (dict(selector="safa"), 6),
    (dict(fused_rounds=False, guard=True), 10),
    (dict(fused_rounds=False, attack="alie"), 10),
    (dict(fused_rounds=False, aggregator="krum"), 11),
    (dict(fused_rounds=False, telemetry=1), 12),
])
def test_out_of_slice_configs_name_their_roadmap_item(override, item):
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP\.md queue 1 item {item}\)"):
        SimConfig(**override)


@pytest.mark.parametrize("override,server_opt", [
    (dict(fused_rounds=False), "fedavg"),
    (dict(server_opt="yogi"), "yogi"),
    (dict(aggregator="yogi"), "yogi"),
])
def test_slice_configs_accepted(override, server_opt):
    """The per-stage flat path and the YoGi server step (also under its old
    name ``aggregator="yogi"``) are in the slice."""
    cfg = SimConfig(**override)
    assert cfg.server_opt == server_opt and cfg.aggregator == "saa"


def test_slice_configs_are_accepted():
    SimConfig(selector="priority", saa=True, apt=True, use_agg_kernel=True,
              setting="DL", staleness_threshold=2, prox_mu=0.01,
              selector_params=(("holdoff", 3),), model_params=(("hidden", 64),))
    with pytest.raises(ValueError, match="unknown knob"):
        SimConfig(selector="priority", selector_params=(("hold", 3),))
