"""The four plain-GQA architectures of the zoo (qwen2.5-3b, qwen2.5-32b
with QKV bias, minicpm-2b with tied embeddings, musicgen-medium over codec
tokens) at their REDUCED configs against the reference's, as
``tests/_zoo_parity.py`` sets out: a 128-token window through the
attention kernel's wrapper, fp32 at rtol = atol = 1e-4, bf16 by relative
L2; and a GQA model at kimi-k2's head dim 112 (d_model 224 over 2 heads)
through the same wrapper."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _zoo_parity as zoo
from repro.models import ModelConfig as JConfig
from repro.models import forward as jforward
from repro.models import init_params as jinit
from repro_torch.models import ModelConfig as TConfig
from repro_torch.models import forward
from repro_torch.weights import from_jax_tree

torch.set_num_threads(1)

ARCHS = ("qwen2.5-3b", "qwen2.5-32b", "minicpm-2b", "musicgen-medium")


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


def test_head_dim_112_model_matches_reference():
    """kimi-k2's head dim (7168 / 64 = 112) inside a model: 2 layers of
    d_model 224 over 2 query heads and 1 kv head, window 128, the kernel
    path on (the Pallas kernel in interpret mode, the port's wrapper on its
    plain version), forward over 200 tokens."""
    dims = dict(n_layers=2, d_model=224, n_heads=2, n_kv_heads=1, d_ff=256,
                vocab_size=256, window=128, use_kernels=True)
    jc = JConfig(param_dtype=jnp.float32, **dims)
    tc = TConfig(param_dtype=torch.float32, **dims)
    assert tc.head_dim == 112
    jp = jinit(jc, jax.random.PRNGKey(0))
    tp = from_jax_tree(jax.tree.map(np.asarray, jp))
    toks = zoo.tokens(jc, 2, 200, 9)
    xj, _, _ = jforward(jc, jp, {"tokens": jnp.asarray(toks)})
    xt, _, _ = forward(tc, tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **zoo.TOL)
    xp, _, _ = forward(dataclasses.replace(tc, use_kernels=False), tp,
                       {"tokens": torch.from_numpy(toks)})
    torch.testing.assert_close(xt, xp, **zoo.TOL)
