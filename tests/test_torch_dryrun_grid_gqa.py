"""The pod dry run's whole grid on the REDUCED qwen2.5-32b and internvl2-76b
configs, whose 2 kv groups split unevenly over the fake mesh's model axis
of 4, as the full configs' 8 split over 16 (internvl2's vision frontend
too): every (arch, shape) counted on a fake (2, 4) mesh
(``_dryrun_cases.check_record``, as in
``tests/test_torch_dryrun_grid_dense.py``)."""
import pytest
import torch

from _dryrun_cases import SHAPES, check_record, reduced_record

torch.set_num_threads(1)

ARCHS = ["qwen2.5-32b", "internvl2-76b"]


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_grid_counted(monkeypatch, arch, shape):
    check_record(reduced_record(monkeypatch, arch, shape), shape)
