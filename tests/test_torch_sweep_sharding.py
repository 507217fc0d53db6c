"""Sweep-axis sharding and the 2-D ``("s", "p")`` round mesh
(``repro_torch.sweeps.sharding``, ``SweepRunner(shard=, mesh=,
shard_participants=)``), a sharded snapshot resumed, and the port's 4-rank
run against the reference's 4-device run.

- Gloo ranks on the CPU (``run_ranks``), 4 of them: a 2 x 2 mesh and a
  4 x 1 one over a sweep whose early stops repack cells across s-shards,
  a participant-only sweep (1 x 4), and a YoGi kernel-route sweep at
  telemetry level 2 on 2 x 2: every rank's every cell bit for bit the
  unsharded sweep's (summary, records, params), one ``all_reduce`` a
  round that aggregates on a rank's s-block.
- A 2-rank sharded run snapshotted, crashed after round 5 and resumed
  from the snapshot on both ranks: bit for bit the uninterrupted
  unsharded run.
- The reference run in a subprocess on 4 forced CPU devices
  (``XLA_FLAGS=--xla_force_host_platform_device_count=4``,
  ``shard_participants=True``) and the port on 4 gloo ranks from its
  initial weights: host records and ``cross_shard_landings`` ``==``,
  params within the pipeline tests' atol 1e-5.
"""
import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _shard_cases as C
from repro_torch.sim import SimConfig, Simulator
from repro_torch.sim.participant_sharding import run_ranks
from repro_torch.sweeps import SweepRunner, SweepSpec
from repro_torch.weights import from_flat

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
EARLY = dict(axes={"selector": ["random", "priority", "safa"],
                   "saa": [False, True]},
             base=dict(n_learners=30, rounds=12, eval_every=3, n_target=4,
                       mapping="label_uniform", target_accuracy=0.12),
             seeds=(0, 1))
EARLY_ONE_BATCH = dict(axes={"saa": [False, True],
                             "hardware": ["HS1", "HS2", "HS3", "HS4"]},
                       base=dict(EARLY["base"], selector="priority",
                                 target_accuracy=0.2),
                       seeds=(0, 1))
KERNEL = dict(axes={"saa": [True], "hardware": ["HS1", "HS3"]},
              base=dict(C.BASE, use_agg_kernel=True, server_opt="yogi",
                        telemetry=2, target_accuracy=0.12),
              seeds=(0, 1))
PART_ONLY = dict(axes={"selector": ["random", "priority"], "saa": [True]},
                 base=C.BASE, seeds=(0,))
SWEEPS = {"2x2 early stop": (EARLY, dict(shard=True, shard_participants=2)),
          "4x1 early stop": (EARLY_ONE_BATCH, dict(shard=True)),
          "1x4 participants": (PART_ONLY, dict(shard_participants=True)),
          "2x2 kernel yogi lane": (KERNEL, dict(mesh={"s": 2, "p": 2}))}
STRAGGLER = dict(n_learners=60, rounds=16, eval_every=4, n_target=8,
                 mapping="label_uniform", selector="priority", saa=True)
RESUME = dict(C.BASE, selector="priority", saa=True, rounds=12,
              server_opt="yogi", use_agg_kernel=True)

REFERENCE = """
import dataclasses, pickle, sys
import numpy as np
from repro.sim import SimConfig, Simulator
from repro.sim.pipeline import RoundPipeline
cfg = SimConfig(**pickle.loads(bytes.fromhex(sys.argv[1])),
                shard_participants=True)
sim = Simulator(cfg)
pipe = RoundPipeline([sim])
acct = pipe.run()[0]
sys.stdout.buffer.write(pickle.dumps({
    "records": [dataclasses.astuple(r) for r in acct.records],
    "cross": int(pipe.stats.cross_shard_landings),
    "n_pshards": pipe.stats.n_pshards,
    "params": np.asarray(sim.flat_params),
    "flat0": np.asarray(sim.substrate.flat_params0)}))
"""


@functools.lru_cache(maxsize=None)
def reference_4dev():
    """The reference's straggler run on 4 forced CPU devices."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    out = subprocess.run(
        [sys.executable, "-c", REFERENCE, pickle.dumps(STRAGGLER).hex()],
        env=env, cwd=ROOT, capture_output=True, timeout=300)
    assert out.returncode == 0, out.stderr.decode()[-3000:]
    return pickle.loads(out.stdout)


@functools.lru_cache(maxsize=None)
def four_ranks():
    """The sweeps of ``SWEEPS`` and the reference's straggler config from
    its initial weights, on 4 gloo ranks (one spawn)."""
    sweeps = run_ranks(C.run_sweeps, 4, list(SWEEPS.values()), timeout=60)
    flat0 = from_flat(reference_4dev()["flat0"])
    sims = run_ranks(C.run_sims, 4, [(STRAGGLER, True, flat0)], timeout=60)
    return ({name: [rank[k] for rank in sweeps]
             for k, name in enumerate(SWEEPS)}, [rank[0] for rank in sims])


@functools.lru_cache(maxsize=None)
def unsharded_sweep(name):
    spec, _ = SWEEPS[name]
    runner = SweepRunner(SweepSpec(**spec).expand(), device="cpu")
    res = runner.run()
    return [{"summary": dict(r.summary), "records": C.records(r.acct),
             "params": sim.flat_params.numpy().copy()}
            for r, sim in zip(res, runner.sims)]


@pytest.mark.parametrize("name", list(SWEEPS))
def test_sharded_sweep_equals_unsharded(name):
    want = unsharded_sweep(name)
    for got in four_ranks()[0][name]:
        assert len(got["cells"]) == len(want)
        for a, b in zip(got["cells"], want):
            assert a["summary"] == b["summary"]
            assert C.same_records(a["records"], b["records"])
            assert np.array_equal(C.bits(a["params"]), C.bits(b["params"]))


def test_early_stop_repacks_across_s_shards():
    """The early-stop sweeps shrink their placement: on the 2 x 2 and the
    4 x 1 mesh some batch repacks (rows moved between s-ranks by
    all-gathers of kind ``repack``), on every rank alike."""
    for name in ("2x2 early stop", "4x1 early stop"):
        ranks = four_ranks()[0][name]
        repacks = [sum(b["dispatches"]["repack"] for b in r["stats"])
                   for r in ranks]
        assert len(set(repacks)) == 1 and repacks[0] >= 1, (name, repacks)
        assert all(sum(b["collectives"].get("repack", 0)
                       for b in r["stats"]) > 0 for r in ranks)
    assert any(r["summary"]["stopped_early"] for r in
               unsharded_sweep("2x2 early stop"))


@pytest.mark.parametrize("name", list(SWEEPS))
def test_sweep_all_reduces_are_its_aggregating_rounds(name):
    """A rank's ``all_reduce`` calls equal its batches' counted round
    reductions; the eval, lane, repack and finalize gathers are the only
    other kinds."""
    for got in four_ranks()[0][name]:
        counted = sum(b["collectives"].get("all_reduce", 0)
                      for b in got["stats"])
        assert got["all_reduce_calls"] == counted > 0
        kinds = set().union(*(b["collectives"] for b in got["stats"]))
        assert kinds <= {"all_reduce", "eval", "lane", "repack", "finalize"}
        assert ("lane" in kinds) == (name == "2x2 kernel yogi lane")


def test_four_ranks_match_the_reference_four_devices():
    ref = reference_4dev()
    assert ref["n_pshards"] == 4 and ref["cross"] >= 1
    for got in four_ranks()[1]:
        assert [r[:8] for r in got["records"]] == \
            [tuple(r[:8]) for r in ref["records"]]
        assert got["stats"]["cross_shard_landings"] == ref["cross"]
        np.testing.assert_allclose(got["params"], ref["params"], atol=1e-5)
        assert got["all_reduce_calls"] == got["aggregated"]


def test_sharded_snapshot_resumes_bit_for_bit(tmp_path):
    path = str(tmp_path / "snap.pkl")
    ranks = run_ranks(C.run_crash_resume, 2, RESUME, True, path, 5,
                      timeout=60)
    sim = Simulator(SimConfig(**RESUME), device="cpu")
    acct = sim.run()
    for got in ranks:
        assert got["summary"] == dict(acct.summary())
        assert C.same_records(got["records"], C.records(acct))
        assert np.array_equal(C.bits(got["params"]),
                              C.bits(sim.flat_params.numpy()))
        for k in ("m", "v"):
            assert np.array_equal(C.bits(got["opt"][k]),
                                  C.bits(sim.flat_opt_state[k].numpy()))
        assert got["all_reduce_calls"] == got["stats"]["collectives"][
            "all_reduce"] > 0
