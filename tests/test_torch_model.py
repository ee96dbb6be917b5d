"""Port parity: VOLO in autoprog_tpu_torch against the Flax model.

volo_h2_l4 (dims 32/64, head_dim 32) at 64 px, f32, with the Flax init
converted by `autoprog_tpu_torch.convert`. Both packages see the same numpy
images; the train-mode check hands torch the MixToken box JAX drew. The CPU
takes the unfused attention path in both packages.

Tolerance: rtol 1e-4 / atol 1e-4 on logits of magnitude ~1. Both run the
same f32 formulas; they differ only in summation order (conv, matmul,
einsum and reductions run in other kernels), which leaves ~1e-6 relative
per op and grows through the 4 blocks and 2 class-attention blocks.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoprog_tpu.registry import create_model as jax_create_model
from autoprog_tpu_torch import create_model
from autoprog_tpu_torch.convert import flax_to_torch

RTOL = ATOL = 1e-4
IMG = 64


def japply(model, variables, x, **kw):
    """Jitted Flax apply (one compile instead of an op-by-op first run)."""
    rngs = kw.pop("rngs", None)
    return jax.jit(functools.partial(model.apply, **kw))(variables, x, rngs=rngs)


@pytest.fixture(scope="module")
def pair():
    model = jax_create_model("volo_h2_l4").make(num_classes=10, img_size=IMG,
                                                dtype=jnp.float32)
    variables = jax.jit(lambda: model.init({"params": jax.random.PRNGKey(0)},
                                           jnp.zeros((1, IMG, IMG, 3)),
                                           train=False))()
    tmodel = create_model("volo_h2_l4").make(num_classes=10, img_size=IMG,
                                             dtype=torch.float32)
    sd = flax_to_torch(variables["params"], variables["batch_stats"])
    tmodel.load_state_dict(sd, strict=True)
    images = np.random.default_rng(0).normal(size=(4, IMG, IMG, 3)).astype(np.float32)
    return model, variables, tmodel, images


def test_state_dict_covers_every_flax_leaf(pair):
    _, variables, tmodel, _ = pair
    n_flax = len(jax.tree.leaves(variables["params"])) + \
        len(jax.tree.leaves(variables["batch_stats"]))
    assert n_flax == len(tmodel.state_dict())
    w = tmodel.state_dict()["s1b0.attn.qkv.weight"]
    k = np.asarray(variables["params"]["s1b0"]["attn"]["qkv"]["kernel"])
    np.testing.assert_array_equal(w.numpy(), k.T)


def test_eval_forward_matches_flax(pair):
    model, variables, tmodel, images = pair
    ref = japply(model, variables, jnp.asarray(images), train=False)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_eval_forward_with_keep_mask_matches_flax(pair):
    model, variables, tmodel, images = pair
    keep = ((True, False), (False, True))
    ref = japply(model, variables, jnp.asarray(images), train=False, keep=keep)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images), train=False, keep=keep)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_train_forward_and_batch_stats_match_flax(pair):
    model, variables, tmodel, images = pair
    tmodel = copy.deepcopy(tmodel)
    (x_cls, x_aux, bbox), mutated = japply(
        model, variables, jnp.asarray(images), train=True, mutable=["batch_stats"],
        rngs={"mixtoken": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)})
    bbox_np = np.asarray(bbox)
    t_cls, t_aux, t_bbox = tmodel(torch.from_numpy(images), train=True,
                                  bbox=torch.tensor(bbox_np))
    assert t_bbox.tolist() == bbox_np.tolist()
    np.testing.assert_allclose(t_cls.detach().numpy(), np.asarray(x_cls),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_aux.detach().numpy(), np.asarray(x_aux),
                               rtol=RTOL, atol=ATOL)
    want = flax_to_torch({}, mutated["batch_stats"])
    sd = tmodel.state_dict()
    for name, v in want.items():
        np.testing.assert_allclose(sd[name].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("r", [32, 96])
def test_resized_pos_embed_forward_matches_flax(pair, r):
    """Another resolution than the init one: bicubic pos-embed resize."""
    model, variables, tmodel, _ = pair
    images = np.random.default_rng(r).normal(size=(2, r, r, 3)).astype(np.float32)
    ref = japply(model, variables, jnp.asarray(images), train=False)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_deit_is_not_ported():
    """The DeiT names build a VisionTransformer; its parity with the Flax
    model is held in test_torch_vit.py."""
    from autoprog_tpu_torch.models.vit import VisionTransformer
    assert create_model("deit_h2_l2").arch.embed_dim == 128
    mdef = create_model("deit_tiny_patch16_224")
    assert (mdef.arch.embed_dim, mdef.arch.depth, mdef.arch.num_heads) == (192, 12, 3)
    assert isinstance(mdef.make(num_classes=10, img_size=32), VisionTransformer)
