"""The layouts the pod dry run places, run on real shards: placed steps
against plain ones (``tests/_dryrun_cases.placed_vs_plain``).

- one rank (a gloo (1, 1) mesh in this process), bit for bit: the REDUCED
  fp32 qwen2.5-32b (uneven kv groups at full width), deepseek-v2-lite-16b
  (MLA; its decode naive and absorbed) and jamba-v0.1-52b (Mamba, MoE)
  prefill, decode step and train step in both cohorts, and the vmap
  cohort of internlm2-1.8b: the same local ops in the same order;
- two spawned gloo ranks: on a (1, 2) mesh the REDUCED qwen2.5-32b prefill
  bit for bit the plain prefill with its row-parallel sums split over the
  two model ranks as the placed step's all-reduce adds them
  (``_dryrun_cases.row_split``; against the unsplit plain prefill the
  split alone moves logits of scale 3 by ~3e-6 in fp32), and its vmap
  train step within rtol 1e-5 / atol 1e-6 of the plain step; on a (2, 1)
  mesh internlm2-1.8b's vmap train step, its participants split over the
  two data ranks, likewise.
"""
import socket

import pytest
import torch
import torch.distributed as dist

from _dryrun_cases import placed_rank, placed_vs_plain
from repro_torch.sim.participant_sharding import run_ranks

torch.set_num_threads(1)

KINDS = ("prefill", "decode", "stream", "vmap")


@pytest.fixture(scope="module")
def one_rank():
    assert not dist.is_initialized()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ["qwen2.5-32b", "deepseek-v2-lite-16b",
                                  "jamba-v0.1-52b"])
def test_placed_equals_plain_on_one_rank(one_rank, arch, kind):
    got = placed_vs_plain(arch, (1, 1), (kind,))[kind]
    assert got["bitwise"], got


def test_placed_absorbed_mla_decode_and_vmap_cohort_on_one_rank(one_rank):
    got = placed_vs_plain("deepseek-v2-lite-16b", (1, 1), ("decode",),
                          overrides={"mla_absorb": True})["decode"]
    assert got["bitwise"], got
    got = placed_vs_plain("internlm2-1.8b", (1, 1), ("vmap",))["vmap"]
    assert got["bitwise"], got


def test_placed_steps_on_two_ranks():
    cases = [("qwen2.5-32b", (1, 2), ("prefill", "vmap")),
             ("internlm2-1.8b", (2, 1), ("vmap",))]
    ranks = run_ranks(placed_rank, 2, cases, timeout=120)
    assert ranks[0] == ranks[1]           # every rank holds the whole result
    (qwen, intern) = ranks[0]
    assert qwen["prefill"]["bitwise"], qwen["prefill"]
    assert 0 < qwen["prefill"]["unsplit_max_abs"] < 1e-5
    for got in (qwen["vmap"], intern["vmap"]):
        assert got["max_rel_excess"] <= 1e-6, got
