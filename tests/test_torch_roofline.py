"""``repro_torch.roofline``: the model-FLOP formulas against the JAX
package's ``repro.roofline.analysis`` on all ten configs, the roofline
terms on the H100's constants, and the dispatch counter's FLOPs, bytes and
collective bytes against closed forms."""
import math

import jax
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.roofline import analysis as janalysis
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.transformer import shape_params
from repro_torch.roofline import (H100, CostCounter, active_params,
                                  model_flops, roofline_terms, swa_cost,
                                  wkv_cost)
from repro_torch.roofline.analysis import live_pairs

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_params_and_model_flops_match_reference(arch):
    jcfg = jget_config(arch)
    jshapes = jax.eval_shape(lambda k: jinit_params(jcfg, k),
                             jax.random.PRNGKey(0))
    n = active_params(get_config(arch), shape_params(get_config(arch)))
    assert n == janalysis.active_params(jcfg, jshapes)
    for kind in ("train", "infer"):
        assert model_flops(n, 4096, kind) == janalysis.model_flops(n, 4096,
                                                                   kind)


def test_roofline_terms_on_the_h100():
    r = roofline_terms(arch="a", shape="s", mesh_name="16x16", chips=256,
                       cost={"flops": 989e12, "bytes accessed": 6.7e12},
                       coll_bytes=45e9, model_flops_val=989e12 * 128)
    assert H100["name"] == "NVIDIA H100 80GB HBM3"
    assert (r.t_compute, r.t_memory, r.t_collective) == (1.0, 2.0, 0.1)
    assert r.bottleneck == "memory" and r.useful_ratio == 0.5
    f = roofline_terms(arch="a", shape="s", mesh_name="m", chips=4,
                       cost={"flops": 4 * 989e12}, coll_bytes=0.0,
                       model_flops_val=0.0, flops_are_per_chip=False)
    assert f.t_compute == 1.0 and f.bottleneck == "compute"
    assert r.row().count(",") == r.HEADER.count(",")


def test_counter_matmul_and_attention_closed_forms():
    m, k, n = 64, 48, 40
    a, b = torch.randn(m, k), torch.randn(k, n)
    with CostCounter() as c:
        a @ b
    assert c.flops == 2 * m * k * n
    assert c.bytes == 4 * (m * k + k * n + m * n)
    B, H, S, D = 2, 3, 32, 16
    q, kk, v = (torch.randn(B, H, S, D) for _ in range(3))
    with CostCounter() as c:
        p = torch.softmax(q @ kk.transpose(-1, -2) / math.sqrt(D), dim=-1)
        p @ v
    assert c.flops == 4 * B * H * S * S * D
    c.add(10.0, 20.0, "kernel")
    assert c.by_op["kernel"] == [10.0, 20.0]
    t = c.totals()
    assert t["coll_total"] == 0.0 and set(t) >= {"coll_all-reduce",
                                                 "coll_all-gather"}


def test_kernel_cost_functions():
    assert live_pairs(10, 4) == 4 * 5 // 2 + 6 * 4
    assert live_pairs(3, 8) == 6
    nbytes, flops = swa_cost(1, 256, 4, 2, 64, 128, 2)
    assert nbytes == 2 * 256 * 64 * (8 + 4)
    assert flops == 4 * 64 * 4 * live_pairs(256, 128)
    nbytes, flops = wkv_cost(2, 16, 4, 8, 2, True)
    seq = 2 * 16 * 4 * 8
    assert nbytes == seq * 12 + 4 * 8 * 4 + 2 * 4 * 64 * 4 * 2
    assert flops == 5 * 64 * 2 * 4 * 16
