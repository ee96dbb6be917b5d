"""The port's finetune module against `autoprog_tpu/finetune.py`.

The pos-embed resizes (VOLO's [1, H, W, C] grid, DeiT's tokens with one or
two prefix tokens) agree within 1e-5 (the same Keys cubic, a = -0.5, summed
in another order); `adapt_state_dict` drops the same heads and keeps the
same leaves as the JAX one, with equal values; `load_pretrained_weights`
reads either package's file.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from flax.traverse_util import flatten_dict

from autoprog_tpu import finetune as jax_finetune
from autoprog_tpu.registry import create_model as jax_create_model
from autoprog_tpu.train.checkpoint import save_checkpoint_file as jax_save
from autoprog_tpu_torch import create_model
from autoprog_tpu_torch.convert import flax_to_torch
from autoprog_tpu_torch.finetune import (adapt_state_dict, load_pretrained_weights,
                                         resize_pos_embed_4d, resize_pos_embed_tokens)
from autoprog_tpu_torch.train.checkpoint import save_checkpoint_file


@pytest.mark.parametrize("src, dst", [(2, 3), (4, 6), (7, 14), (8, 5)])
def test_resize_pos_embed_4d_matches_jax(src, dst):
    x = np.random.default_rng(src).normal(size=(1, src, src, 16)).astype(np.float32)
    want = np.asarray(jax_finetune.resize_pos_embed_4d(jnp.asarray(x), (1, dst, dst, 16)))
    got = resize_pos_embed_4d(torch.from_numpy(x), (1, dst, dst, 16))
    assert got.shape == (1, dst, dst, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_prefix, src, dst", [(1, 2, 4), (2, 4, 3), (1, 14, 7), (2, 3, 3)])
def test_resize_pos_embed_tokens_matches_jax(n_prefix, src, dst):
    x = np.random.default_rng(dst).normal(size=(1, n_prefix + src * src, 8)).astype(np.float32)
    shape = (1, n_prefix + dst * dst, 8)
    want = np.asarray(jax_finetune.resize_pos_embed_tokens(jnp.asarray(x), shape, n_prefix))
    got = resize_pos_embed_tokens(torch.from_numpy(x), shape, n_prefix)
    assert got.shape == shape
    np.testing.assert_array_equal(got[:, :n_prefix].numpy(), x[:, :n_prefix])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_params(name, img, nc, seed):
    if name == "distilled":
        # the leaves of a distilled DeiT that finetuning treats apart (two
        # prefix tokens, two heads), without building one
        rs = np.random.default_rng(seed)
        g, C = img // 16, 16

        def a(*shape):
            return jnp.asarray(rs.normal(size=shape), jnp.float32)
        return {"cls_token": a(1, 1, C), "dist_token": a(1, 1, C),
                "pos_embed": a(1, 2 + g * g, C),
                "patch_embed": {"kernel": a(16, 16, 3, C), "bias": a(C)},
                "blocks_0": {"attn": {"qkv": {"kernel": a(C, 3 * C), "bias": a(3 * C)}}},
                "norm": {"scale": a(C), "bias": a(C)},
                "head": {"kernel": a(C, nc), "bias": a(nc)},
                "head_dist": {"kernel": a(C, nc), "bias": a(nc)}}
    model = jax_create_model(name).make(num_classes=nc, img_size=img, dtype=jnp.float32)
    v = jax.jit(lambda: model.init({"params": jax.random.PRNGKey(seed)},
                                   jnp.zeros((1, img, img, 3)), train=False))()
    return v["params"]


@pytest.mark.parametrize("name", ["volo_h2_l2", "deit_h2_l2", "distilled"])
def test_adapt_state_dict_matches_jax(name):
    """Pretrained at 32 px and 8 classes, finetuned at 64 px and 10."""
    src, dst = _jax_params(name, 32, 8, 0), _jax_params(name, 64, 10, 1)
    want = flax_to_torch(jax_finetune.adapt_state_dict(flatten_dict(src), dst,
                                                       num_classes=10))
    got = adapt_state_dict(flax_to_torch(src), flax_to_torch(dst))
    assert set(got) == set(want)
    init, pre = flax_to_torch(dst), flax_to_torch(src)
    dropped = sorted(n for n in got if torch.equal(got[n], init[n]) and n in pre
                     and pre[n].shape != init[n].shape and "pos_embed" not in n)
    heads = {"volo_h2_l2": ["aux_head.bias", "aux_head.weight", "head.bias", "head.weight"],
             "deit_h2_l2": ["head.bias", "head.weight"],
             "distilled": ["head.bias", "head.weight", "head_dist.bias",
                           "head_dist.weight"]}[name]
    assert dropped == heads
    for n in got:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=n)
        if n not in heads and "pos_embed" not in n:
            assert torch.equal(got[n], pre[n]), n


@pytest.mark.parametrize("fmt", ["jax", "port"])
def test_load_pretrained_weights_reads_either_file(fmt, tmp_path):
    src = _jax_params("volo_h2_l2", 32, 8, 0)
    ema = jax.tree.map(lambda p: p * 0.5 + 0.25, src)
    path = str(tmp_path / "pre.ckpt")
    if fmt == "jax":
        jax_save(path, {"arch": "volo_h2_l2", "epoch": 3,
                        "state_dict": serialization.to_state_dict(src),
                        "state_dict_ema_0": serialization.to_state_dict(ema)})
    else:
        save_checkpoint_file(path, {"arch": "volo_h2_l2", "epoch": 3,
                                    "state_dict": flax_to_torch(src),
                                    "state_dict_ema_0": flax_to_torch(ema)})
    torch.manual_seed(0)
    model = create_model("volo_h2_l2").make(num_classes=10, img_size=64, dtype=torch.float32)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    loaded = load_pretrained_weights(model, path, use_ema=True)
    want = adapt_state_dict(flax_to_torch(ema), init)
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), want[n]) and torch.equal(loaded[n], want[n]), n
    assert torch.equal(model.head.weight.detach(), init["head.weight"])
    assert model.pos_embed.shape == (1, 4, 4, 64)
    assert torch.equal(model.get_parameter("s1b0.attn.qkv.weight").detach(),
                       flax_to_torch(ema)["s1b0.attn.qkv.weight"])
