"""The zoo's hybrid and vision architectures (jamba-v0.1-52b: Mamba and
attention layers with MoE every other layer; internvl2-76b: projected patch
embeddings before the tokens) at their REDUCED configs against the
reference's, as ``tests/_zoo_parity.py`` sets out; and internvl2's
``lm_loss``, which scores the text positions only."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _zoo_parity as zoo
from repro.models.transformer import lm_loss as jloss
from repro_torch.models import lm_loss

torch.set_num_threads(1)

ARCHS = ("jamba-v0.1-52b", "internvl2-76b")


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


@pytest.mark.parametrize("n_patches", [8, 3])
def test_vision_lm_loss_matches_reference(n_patches):
    """internvl2's loss with ``frontend_embeds``: the patches run through the
    model, and only the 64 text positions are scored."""
    jc, tc, jp, tp = zoo.model("internvl2-76b")
    jb, tb = zoo.batches(jc, 2, 64, 11, n_patches=n_patches)
    labels = zoo.tokens(jc, 2, 64, 12)
    jb["labels"], tb["labels"] = jnp.asarray(labels), torch.from_numpy(labels)
    want = float(jloss(jc, jp, jb))
    got = lm_loss(tc, tp, tb)
    assert got.shape == () and np.isfinite(float(got))
    np.testing.assert_allclose(float(got), want, **zoo.TOL)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "internvl2-76b", "deepseek-v2-lite-16b"])
def test_from_jax_tree_carries_mixed_dtypes(arch):
    """``weights.from_jax_tree`` carries a bf16 model's tree whole: Mamba's
    fp32 ``A_log`` / ``dt_bias`` / ``D`` beside its bf16 leaves, the MoE
    router's fp32, the vision projector and MLA's latent projections, each
    with its key path, shape, dtype and bits."""
    from repro.models import init_params as jinit
    from repro_torch.weights import from_jax_tree
    jc, _ = zoo.cfgs(arch, fp32=False)
    tree = jax.tree.map(np.asarray, jinit(jc, jax.random.PRNGKey(0)))
    jp, tp = zoo.leaves(tree), zoo.leaves(from_jax_tree(tree))
    assert sorted(tp) == sorted(jp)
    for path, w in jp.items():
        t = tp[path]
        assert tuple(t.shape) == w.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(w.dtype), path
        bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        want = w.view(np.int16) if w.dtype.name == "bfloat16" else w
        np.testing.assert_array_equal(bits.numpy(), want, err_msg=path)
    by_leaf = {}
    for path, t in tp.items():
        by_leaf.setdefault(path.rsplit("/", 1)[-1], set()).add(t.dtype)
    fp32, bf16 = {torch.float32}, {torch.bfloat16}
    want = {"jamba-v0.1-52b": dict(A_log=fp32, dt_bias=fp32, D=fp32, router=fp32,
                                   conv_w=bf16, w_in=bf16, w_dt=bf16),
            "internvl2-76b": dict(proj=bf16, scale=fp32),
            "deepseek-v2-lite-16b": dict(w_dkv=bf16, w_kr=bf16, w_uk=bf16, w_uv=bf16,
                                         router=fp32)}[arch]
    for leaf, dts in want.items():
        assert by_leaf[leaf] == dts, (leaf, by_leaf.get(leaf))
