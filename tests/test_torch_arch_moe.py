"""The zoo's mixture-of-experts architectures (kimi-k2-1t-a32b: GQA with a
dense first layer and routed + shared experts; deepseek-v2-lite-16b: MLA
with its compressed cache, naive and absorbed decode) at their REDUCED
configs against the reference's, as ``tests/_zoo_parity.py`` sets out.
deepseek's absorbed decode (its published ``mla_absorb=True``) runs the
same checks in ``tests/test_torch_mla.py``."""
import pytest
import torch

import _zoo_parity as zoo

torch.set_num_threads(1)

ARCHS = ("kimi-k2-1t-a32b", "deepseek-v2-lite-16b")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return zoo.model(request.param)


def test_forward_and_logits_match_reference(model):
    zoo.check_forward_and_logits(model)


def test_prefill_matches_reference(model):
    zoo.check_prefill(model)


def test_decode_steps_match_reference(model):
    zoo.check_decode_steps(model)


def test_greedy_generate_matches_reference(model):
    zoo.check_greedy(model)


def test_prefill_equals_decode_in_port(model):
    zoo.check_prefill_equals_decode(model)


def test_kernel_wrappers_on_the_path(model):
    zoo.check_kernel_wrappers(model)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_match_reference(arch):
    zoo.check_bf16(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference_tree(arch):
    zoo.check_init_tree(arch)
