"""Port parity: the plain ops of autoprog_tpu_torch against their JAX
counterparts (unfold, fold, avg_pool_ceil, both resizes, MixToken, outlook
attention), on the same numpy inputs, f32.

Tolerance: 1e-6 absolute where both sides move data without arithmetic
(unfold, masks, mixing); rtol/atol 1e-5 where they sum in f32 in another
order (fold overlaps, pooling, resizes, outlook attention).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoprog_tpu.ops import interpolate as jint
from autoprog_tpu.ops import mixtoken as jmix
from autoprog_tpu.ops import outlook as jout
from autoprog_tpu.ops import unfold as junf
from autoprog_tpu_torch.ops import interpolate as tint
from autoprog_tpu_torch.ops import mixtoken as tmix
from autoprog_tpu_torch.ops import outlook as tout
from autoprog_tpu_torch.ops import unfold as tunf

SUM_TOL = dict(rtol=1e-5, atol=1e-5)


def rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("k,s,p,H", [(3, 2, 1, 8), (3, 1, 1, 6), (3, 2, 1, 7)])
def test_unfold_matches_jax(k, s, p, H):
    x = rand(2, H, H + 2, 5)
    ref = junf.unfold_nhwc(jnp.asarray(x), k, s, p)
    got = tunf.unfold_nhwc(torch.from_numpy(x), k, s, p)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("k,s,p,H", [(3, 2, 1, 8), (3, 1, 1, 6)])
def test_fold_matches_jax(k, s, p, H):
    h = (H + 2 * p - k) // s + 1
    w = (H + 2 + 2 * p - k) // s + 1
    patches = rand(2, h, w, k, k, 5, seed=1)
    ref = junf.fold_nhwc(jnp.asarray(patches), (H, H + 2), k, s, p)
    got = tunf.fold_nhwc(torch.from_numpy(patches), (H, H + 2), k, s, p)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **SUM_TOL)


@pytest.mark.parametrize("H,W,stride", [(8, 8, 2), (7, 9, 2), (6, 6, 1)])
def test_avg_pool_ceil_matches_jax(H, W, stride):
    x = rand(2, H, W, 3, seed=2)
    ref = junf.avg_pool_ceil(jnp.asarray(x), stride)
    got = tunf.avg_pool_ceil(torch.from_numpy(x), stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **SUM_TOL)


@pytest.mark.parametrize("src,dst", [(16, 9), (14, 2), (12, 24), (32, 32)])
def test_resize_bilinear_matches_jax(src, dst):
    x = rand(2, src, src, 3, seed=3)
    ref = jint.resize_bilinear(jnp.asarray(x), dst)
    got = tint.resize_bilinear(torch.from_numpy(x), dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **SUM_TOL)


@pytest.mark.parametrize("src,dst", [(14, 8), (14, 20), (7, 12), (4, 3)])
def test_resize_bicubic_matches_jax_keys_cubic(src, dst):
    """Keys a = -0.5 with JAX's renormalised edge weights; torch's own
    bicubic (a = -0.75) does not match, which the last check pins."""
    x = rand(1, src, src, 6, seed=4)
    ref = np.asarray(jint.resize_bicubic(jnp.asarray(x), (dst, dst)))
    got = tint.resize_bicubic(torch.from_numpy(x), (dst, dst))
    np.testing.assert_allclose(got.numpy(), ref, **SUM_TOL)
    torch_a075 = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=(dst, dst), mode="bicubic",
        align_corners=False).permute(0, 2, 3, 1).numpy()
    assert np.abs(torch_a075 - ref).max() > 1e-3


def test_region_mask_and_mix_tokens_match_jax():
    x = rand(4, 8, 6, 3, seed=5)
    bbox = np.array([1, 0, 3, 2], np.int32)
    for scale in (1, 2):
        gh, gw = 8 // scale, 6 // scale
        ref = jmix.region_mask(jnp.asarray(bbox), gh, gw, scale)
        got = tmix.region_mask(torch.from_numpy(bbox), gh, gw, scale)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        ref = jmix.mix_tokens(jnp.asarray(x), jnp.asarray(bbox), scale)
        got = tmix.mix_tokens(torch.from_numpy(x), torch.from_numpy(bbox), scale)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ref = jmix.unmix_tokens(jnp.asarray(x), jnp.asarray(bbox))
    got = tmix.unmix_tokens(torch.from_numpy(x), torch.from_numpy(bbox))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert tmix.mix_lambda(torch.from_numpy(bbox), 48) == pytest.approx(
        float(jmix.mix_lambda(jnp.asarray(bbox), 48)))


def test_rand_bbox_stays_in_grid_and_follows_its_generator():
    """The bits differ from JAX's threefry by design; what must hold is the
    box's support and that the generator alone decides it."""
    g = torch.Generator().manual_seed(0)
    boxes = [tmix.rand_bbox(g, 7, 5).tolist() for _ in range(200)]
    for x1, y1, x2, y2 in boxes:
        assert 0 <= x1 <= x2 <= 5 and 0 <= y1 <= y2 <= 7
    assert len({tuple(b) for b in boxes}) > 20
    g2 = torch.Generator().manual_seed(0)
    assert [tmix.rand_bbox(g2, 7, 5).tolist() for _ in range(200)] == boxes


@pytest.mark.parametrize("H,W,heads,stride", [(8, 8, 2, 2), (6, 10, 3, 2), (6, 6, 2, 1)])
def test_outlook_attention_matches_jax(H, W, heads, stride):
    C, k, p = heads * 8, 3, 1
    h, w = -(-H // stride), -(-W // stride)
    v = rand(2, H, W, C, seed=6)
    logits = rand(2, h, w, heads * k ** 4, seed=7)
    scale = (C // heads) ** -0.5
    kw = dict(num_heads=heads, kernel_size=k, stride=stride, padding=p, scale=scale)
    ref = jout.outlook_attention(jnp.asarray(v), jnp.asarray(logits), **kw)
    got = tout.outlook_attention(torch.from_numpy(v), torch.from_numpy(logits), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **SUM_TOL)


def test_outlook_softmax_compute_dtype_bf16_matches_jax():
    """bf16 attention matrices: both round the scaled logits, subtract the
    max in bf16, exp/sum in f32 and round the probabilities; equal up to one
    bf16 ulp (2^-8 at probabilities <= 1)."""
    logits = rand(2, 4, 2, 9, 9, seed=8) * 3
    ref = jout._softmax_compute_dtype(jnp.asarray(logits), 0.3, jnp.bfloat16)
    got = tout._softmax_compute_dtype(torch.from_numpy(logits), 0.3, torch.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=2 ** -8)
