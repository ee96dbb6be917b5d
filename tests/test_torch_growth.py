"""Port parity: `autoprog_tpu_torch/prog/growth.py` against
`autoprog_tpu/prog/growth.py`.

Each mode grows volo_h2_l2 into volo_h4_l4 (width and depth) and into
volo_h2_l4 (depth only) twice: the JAX function on the Flax trees, converted
with `convert.flax_to_torch`, and the port's function on the converted trees.
Both run the same arithmetic in the same order on f32, so they agree to
atol 1e-6 (one rounding of the 1/scale division). clone_noise draws from
different generators: its noise-free part (the first replica on every axis,
with the 1/scale) is compared exactly and the noise by its bounds.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoprog_tpu.prog import growth as jgrowth
from autoprog_tpu.prog.depth import get_new_layer_idx
from autoprog_tpu.registry import create_model as jax_create_model
from autoprog_tpu_torch import create_model
from autoprog_tpu_torch.convert import flax_to_torch
from autoprog_tpu_torch.prog import growth as tgrowth

IMG, NC = 64, 10
SMALL = "volo_h2_l2"
TARGETS = ["volo_h4_l4", "volo_h2_l4"]
MODES = ["slice", "clone_rand", "zero", "clone", "clone_noise", "clone_ema"]


def jax_init(name, seed):
    mdef = jax_create_model(name)
    model = mdef.make(num_classes=NC, img_size=IMG, dtype=jnp.float32)
    v = model.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, IMG, IMG, 3)),
                   train=False)
    return tuple(mdef.arch.layers), v["params"], v.get("batch_stats", {})


def perturbed(tree, seed):
    """An EMA-like tree: the parameters plus seeded numpy noise, per leaf."""
    def leaf(path, x):
        key = zlib.crc32(jax.tree_util.keystr(path).encode()) + seed
        noise = np.random.RandomState(key % 2 ** 31).randn(*x.shape)
        return x + 0.01 * jnp.asarray(noise, x.dtype)
    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def trees():
    out = {SMALL: jax_init(SMALL, 0)}
    for i, name in enumerate(TARGETS):
        out[name] = jax_init(name, i + 1)
    return out


def as_numpy(tree):
    return {k: v.numpy() for k, v in tree.items()}


def assert_trees_close(got, ref, atol=1e-6):
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k], ref[k], atol=atol, rtol=0, err_msg=k)


def first_replica(name, big, small_shape):
    """The noise-free part of a clone_noise leaf `big` (torch layout): the
    first replica on every axis; for the fused qkv / kv weight, of each
    projection."""
    parts = name.split(".")
    fuse = 3 if "qkv" in parts else 2 if "kv" in parts else 0
    if big.ndim == 2 and fuse:
        s_out, s_in = small_shape
        return big.reshape(fuse, -1, big.shape[1])[:, :s_out // fuse, :s_in]
    if big.ndim == 1 and fuse:
        return big.reshape(fuse, -1)[:, :small_shape[0] // fuse]
    return big[tuple(slice(0, n) for n in small_shape)]


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("mode", MODES)
def test_grow_params_matches_jax(trees, mode, target):
    sl, sp, _ = trees[SMALL]
    bl, bp, _ = trees[target]
    jkw, tkw, src = {}, {}, sp
    if mode == "clone_ema":
        emas = [perturbed(sp, s) for s in (1, 2, 3)]
        src = perturbed(sp, 4)
        jkw = dict(ema_trees=emas)
        tkw = dict(ema_trees=[flax_to_torch(e) for e in emas])
    if mode == "clone_noise":
        jkw = dict(rng=jax.random.PRNGKey(5))
        tkw = dict(rng=torch.Generator().manual_seed(5))
    ref = as_numpy(flax_to_torch(jgrowth.grow_params(
        src, bp, src_layers=sl, dst_layers=bl, mode=mode, **jkw)))
    got = as_numpy(tgrowth.grow_params(
        flax_to_torch(src), flax_to_torch(bp), src_layers=sl, dst_layers=bl, mode=mode,
        **tkw))
    if mode != "clone_noise":
        assert_trees_close(got, ref)
        return
    # noise: equal where there is none, bounded and present where there is
    clone = as_numpy(tgrowth.grow_params(flax_to_torch(sp), flax_to_torch(bp),
                                         src_layers=sl, dst_layers=bl, mode="clone"))
    small = as_numpy(flax_to_torch(sp))
    noisy_leaves = 0
    for name, g in got.items():
        src_name = tgrowth._depth_mapped_name(name, sl, bl)
        shape = small[src_name].shape
        np.testing.assert_allclose(first_replica(name, g, shape),
                                   first_replica(name, ref[name], shape), atol=1e-6,
                                   rtol=0, err_msg=name)
        diff = np.abs(g - clone[name])
        # std .01 truncated at 2 sigma, on at most two tiled axes, over scale >= 1
        assert diff.max() <= 2 * 0.02 + 1e-6, name
        if name.endswith("weight") and g.ndim in (2, 4) and g.shape != shape:
            scale = g.shape[1] / shape[1]
            assert diff.max() <= 2 * 0.02 / scale + 1e-6, name
            assert diff.max() > 0, name
            noisy_leaves += 1
        else:       # vectors and embeddings are tiled without noise
            np.testing.assert_allclose(g, ref[name], atol=1e-6, err_msg=name)
    assert noisy_leaves > 0 or target == "volo_h2_l4"


@pytest.mark.parametrize("dst_l", [2, 3])
def test_shrink_params_matches_jax(trees, dst_l):
    """mode "super": a standalone volo_h2_l{2,3} out of the volo_h2_l4
    supernet that grew from depth 2."""
    sup_l, sup_p, _ = trees["volo_h2_l4"]
    dst_layers, dst_p, _ = jax_init(f"volo_h2_l{dst_l}", 7)
    kw = dict(base_layers=dst_layers, super_layers=sup_l, dst_layers=dst_layers,
              base_l=2, super_l=4, dst_l=dst_l, family="volo")
    ref = as_numpy(flax_to_torch(jgrowth.shrink_params(sup_p, dst_p, **kw)))
    got = as_numpy(tgrowth.shrink_params(flax_to_torch(sup_p), flax_to_torch(dst_p), **kw))
    assert_trees_close(got, ref)


@pytest.mark.parametrize("target", TARGETS)
def test_grow_batch_stats_matches_jax(trees, target):
    sl, _, ss = trees[SMALL]
    bl, _, bs = trees[target]
    ss = jax.tree.map(lambda x: x + 0.5, ss)         # not the init values
    ref = as_numpy(flax_to_torch({}, jgrowth.grow_batch_stats(
        ss, bs, src_layers=sl, dst_layers=bl)))
    got = as_numpy(tgrowth.grow_batch_stats(flax_to_torch({}, ss), flax_to_torch({}, bs),
                                            src_layers=sl, dst_layers=bl))
    assert got and set(got) == set(ref)
    assert_trees_close(got, ref)
    assert tgrowth.grow_batch_stats({}, flax_to_torch({}, bs), src_layers=sl,
                                    dst_layers=bl).keys() == got.keys()


def test_clone_growth_preserves_the_function(trees):
    """Width x2 and depth x2 by "clone", the new layers masked off: the
    grown model's logits equal the small model's (rtol / atol 5e-4, the
    tolerance of the JAX package's own test of this property)."""
    sl, sp, ss = trees[SMALL]
    bl, bp, bs = trees["volo_h4_l4"]
    small = create_model(SMALL).make(num_classes=NC, img_size=IMG, dtype=torch.float32)
    small.load_state_dict(flax_to_torch(sp, ss))
    big = create_model("volo_h4_l4").make(num_classes=NC, img_size=IMG,
                                          dtype=torch.float32)
    grown = tgrowth.grow_params(dict(small.named_parameters()),
                                dict(big.named_parameters()), src_layers=sl,
                                dst_layers=bl, mode="clone")
    stats = tgrowth.grow_batch_stats(dict(small.named_buffers()),
                                     dict(big.named_buffers()), src_layers=sl,
                                     dst_layers=bl)
    big.load_state_dict({**grown, **stats})
    keep = tuple(tuple(i not in get_new_layer_idx(sl[s], bl[s]) for i in range(bl[s]))
                 for s in range(2))
    x = torch.from_numpy(np.random.RandomState(42).randn(2, IMG, IMG, 3).astype(np.float32))
    with torch.no_grad():
        y_small = small(x, train=False)
        y_big = big(x, train=False, keep=keep)
        y_full = big(x, train=False)
    np.testing.assert_allclose(y_big.numpy(), y_small.numpy(), rtol=5e-4, atol=5e-4)
    assert not np.allclose(y_full.numpy(), y_small.numpy(), rtol=1e-3)


@pytest.mark.parametrize("mode", MODES + ["super"])
def test_grown_trees_never_alias_buffers(trees, mode):
    """Depth cloning maps several destination layers to one source: every
    grown tensor must own its storage, and none may be the source's or the
    template's."""
    sl, sp, _ = trees[SMALL]
    bl, bp, _ = trees["volo_h2_l4"]
    src, tmpl = flax_to_torch(sp), flax_to_torch(bp)
    if mode == "super":
        grown = tgrowth.shrink_params(tmpl, src, base_layers=sl, super_layers=bl,
                                      dst_layers=sl, base_l=2, super_l=4, dst_l=2)
    else:
        kw = {}
        if mode == "clone_ema":
            kw = dict(ema_trees=[src, src, src])
        if mode == "clone_noise":
            kw = dict(rng=torch.Generator().manual_seed(0))
        grown = tgrowth.grow_params(src, tmpl, src_layers=sl, dst_layers=bl, mode=mode, **kw)
    ptrs = [t.untyped_storage().data_ptr() for t in grown.values()]
    assert len(ptrs) == len(set(ptrs)), "grown tree has aliased tensors"
    taken = {t.untyped_storage().data_ptr() for t in list(src.values()) + list(tmpl.values())}
    assert not taken & set(ptrs)
    assert all(t.is_contiguous() for t in grown.values())


def test_clone_ema_needs_three_trees_and_clone_noise_a_generator(trees):
    sl, sp, _ = trees[SMALL]
    bl, bp, _ = trees["volo_h4_l4"]
    src, tmpl = flax_to_torch(sp), flax_to_torch(bp)
    with pytest.raises(ValueError, match="clone_ema needs"):
        tgrowth.grow_params(src, tmpl, src_layers=sl, dst_layers=bl, mode="clone_ema",
                            ema_trees=[src])
    with pytest.raises(ValueError, match="clone_noise needs"):
        tgrowth.grow_params(src, tmpl, src_layers=sl, dst_layers=bl, mode="clone_noise")
