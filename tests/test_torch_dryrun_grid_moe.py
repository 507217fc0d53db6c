"""The pod dry run's whole grid on the REDUCED MoE and hybrid configs
(deepseek-v2-lite-16b's MLA, kimi-k2's experts, jamba's Mamba): every
(arch, shape) counted on a fake (2, 4) mesh (``_dryrun_cases.check_record``,
as in ``tests/test_torch_dryrun_grid_dense.py``)."""
import pytest
import torch

from _dryrun_cases import SHAPES, check_record, reduced_record

torch.set_num_threads(1)

ARCHS = ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b", "jamba-v0.1-52b"]


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_grid_counted(monkeypatch, arch, shape):
    check_record(reduced_record(monkeypatch, arch, shape), shape)
