"""Port parity: the plain twins of the fused outlook attention (K2) and of
the attend hybrids (K3, K4) against the JAX package's Pallas kernels run in
interpret mode, on the same numpy inputs.

Tolerances (f32 unless stated):
  * forward rtol 2e-5 / atol 2e-6: the same f32 formula, softmax and sums
    in another order (the tolerance `tests/test_outlook_pallas.py` holds the
    Pallas kernel to);
  * gradients of sum(out^2) rtol 2e-4 / atol 2e-5, as that file has them;
  * bf16 inputs: both sides compute in f32 and round once, so they may
    differ by one rounding of the result: 1 bf16 ulp of the largest value;
  * `gradcheck` in f64 holds each Function's hand-written backward to the
    numerical derivative of its forward.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoprog_tpu.models import layers as jlayers
from autoprog_tpu.ops import outlook_pallas as jpal
from autoprog_tpu_torch.convert import flax_to_torch
from autoprog_tpu_torch.models import layers as tlayers
from autoprog_tpu_torch.ops import outlook_fused as O

SHAPES = [(2, 8, 8, 16, 4), (1, 16, 16, 192, 6)]
OPS = {
    "fused": (jpal.outlook_attention_fused, O.outlook_attention_fused),
    "hybrid": (jpal.outlook_attention_hybrid, O.outlook_attention_hybrid),
    "hybrid2": (jpal.outlook_attention_hybrid2, O.outlook_attention_hybrid2),
}


def make_inputs(B, H, W, C, heads, seed=0):
    rs = np.random.RandomState(seed)
    v = rs.randn(B, H, W, C).astype(np.float32)
    attn = rs.randn(B, H // 2, W // 2, heads * 81).astype(np.float32)
    return v, attn, (C // heads) ** -0.5


@pytest.mark.parametrize("shape", SHAPES, ids=["small", "volo_d1_r128"])
@pytest.mark.parametrize("name", list(OPS))
def test_forward_matches_the_interpreted_pallas_kernel(name, shape):
    jfn, tfn = OPS[name]
    heads = shape[-1]
    v, attn, scale = make_inputs(*shape)
    ref = jfn(jnp.asarray(v), jnp.asarray(attn), heads, scale, True)
    got = tfn(torch.from_numpy(v), torch.from_numpy(attn), heads, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("shape", SHAPES, ids=["small", "volo_d1_r128"])
@pytest.mark.parametrize("name", list(OPS))
def test_gradients_match_the_jax_custom_vjp(name, shape):
    jfn, tfn = OPS[name]
    heads = shape[-1]
    v, attn, scale = make_inputs(*shape, seed=2)
    gv_r, ga_r = jax.grad(lambda a, b: jnp.sum(jfn(a, b, heads, scale, True) ** 2),
                          argnums=(0, 1))(jnp.asarray(v), jnp.asarray(attn))
    tv = torch.from_numpy(v).requires_grad_(True)
    ta = torch.from_numpy(attn).requires_grad_(True)
    tfn(tv, ta, heads, scale).square().sum().backward()
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(gv_r), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga_r), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name", list(OPS))
def test_bf16_inputs_within_one_ulp(name):
    jfn, tfn = OPS[name]
    B, H, W, C, heads = SHAPES[0]
    v, attn, scale = make_inputs(B, H, W, C, heads, seed=3)
    ref = jfn(jnp.asarray(v, jnp.bfloat16), jnp.asarray(attn, jnp.bfloat16), heads,
              scale, True)
    got = tfn(torch.from_numpy(v).bfloat16(), torch.from_numpy(attn).bfloat16(), heads,
              scale)
    assert got.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    ulp = 2.0 ** -7 * np.abs(ref).max()       # bf16 keeps 8 significant bits
    assert np.abs(got.float().numpy() - ref).max() <= ulp


def test_backward_twin_is_the_shared_jax_bwd_in_bf16():
    """The backward's rounding points (dlogits and dpatches rounded to the
    working dtype, the fold summed there): 1 bf16 ulp of the largest value."""
    B, H, W, C, heads = SHAPES[0]
    v, attn, scale = make_inputs(B, H, W, C, heads, seed=4)
    g = np.random.RandomState(5).randn(B, H, W, C).astype(np.float32)
    jv, ja, jg = (jnp.asarray(x, jnp.bfloat16) for x in (v, attn, g))
    dv_r, da_r = jpal._bwd(heads, scale, True, (jv, ja), jg)
    dv, da = O.outlook_attention_backward_reference(
        torch.from_numpy(v).bfloat16(), torch.from_numpy(attn).bfloat16(),
        torch.from_numpy(g).bfloat16(), heads, scale)
    for got, ref in ((dv, dv_r), (da, da_r)):
        ref = np.asarray(ref.astype(jnp.float32))
        assert got.dtype == torch.bfloat16
        assert np.abs(got.float().numpy() - ref).max() <= 2.0 ** -7 * np.abs(ref).max()


@pytest.mark.parametrize("head_minor", [True, False], ids=["K3", "K4"])
def test_attend_twin_matches_the_pallas_attend_kernels(head_minor):
    """The attend twin alone, on patches and logits in the kernels' layout,
    against `_attend_kernel` / `_attend_kernel_v2` through their wrappers'
    pallas_call (the forward of the hybrids minus unfold and fold is
    covered above; here the [B, 9, n, C] output layout is held directly)."""
    B, n, C, heads = 2, 16, 16, 4
    rs = np.random.RandomState(6)
    patches = rs.randn(B, n, 9, C).astype(np.float32)
    logits = rs.randn(B, n, 9, 9, heads).astype(np.float32)
    scale = (C // heads) ** -0.5
    att = jax.nn.softmax(jnp.asarray(logits) * scale, axis=3)
    head_of = np.arange(C) % heads if head_minor else np.arange(C) // (C // heads)
    ref = jnp.einsum("bnpqc,bnqc->bpnc", att[..., head_of], jnp.asarray(patches))
    got = O.outlook_attend_reference(torch.from_numpy(patches), torch.from_numpy(logits),
                                     heads, scale, head_minor)
    assert got.shape == (B, 9, n, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("name", list(OPS))
def test_gradcheck_f64(name):
    tfn = OPS[name][1]
    g = torch.Generator().manual_seed(0)
    v = torch.randn(1, 4, 4, 8, dtype=torch.float64, generator=g, requires_grad=True)
    a = torch.randn(1, 2, 2, 2 * 81, dtype=torch.float64, generator=g, requires_grad=True)
    assert torch.autograd.gradcheck(lambda x, y: tfn(x, y, 2, 0.5), (v, a))


def test_cpu_tensors_take_the_twins_and_count_no_launch():
    before = dict(O.LAUNCHES)
    v, attn, scale = make_inputs(*SHAPES[0])
    for _, tfn in OPS.values():
        tfn(torch.from_numpy(v), torch.from_numpy(attn), 4, scale)
    assert O.LAUNCHES == before


def test_outlook_layer_routes_to_the_fused_op(monkeypatch):
    """`OutlookAttention` with AUTOPROG_FUSED_OUTLOOK=1 against the Flax layer
    under the same variable (its Pallas kernel interpreted), f32, on
    converted parameters; rtol 1e-4 / atol 1e-5 (three Dense layers around
    the op, summed in another order)."""
    monkeypatch.setenv("AUTOPROG_FUSED_OUTLOOK", "1")
    monkeypatch.setattr(jpal, "outlook_attention_fused", functools.partial(
        jpal.outlook_attention_fused, interpret=True))
    dim, heads = 32, 2
    x = np.random.RandomState(7).randn(2, 8, 8, dim).astype(np.float32)
    jlayer = jlayers.OutlookAttention(num_heads=heads, kernel_size=3, padding=1,
                                      stride=2, dtype=jnp.float32)
    variables = jlayer.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))
    ref = jlayer.apply(variables, jnp.asarray(x))
    tlayer = tlayers.OutlookAttention(dim, heads, 3, 1, 2, dtype=torch.float32)
    tlayer.load_state_dict(flax_to_torch(variables["params"]))
    calls = []
    real = O.outlook_attention_fused
    monkeypatch.setattr(O, "outlook_attention_fused",
                        lambda *a: calls.append(1) or real(*a))
    got = tlayer(torch.from_numpy(x))
    assert calls == [1]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    monkeypatch.setenv("AUTOPROG_FUSED_OUTLOOK", "0")
    tlayer(torch.from_numpy(x))
    assert calls == [1]
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert not tlayers._use_fused_outlook(3, 2, 1, 7, 8, cpu)      # odd H: unfused
    monkeypatch.delenv("AUTOPROG_FUSED_OUTLOOK")
    # unset: the reference's default on the CPU, the measured one on the card
    assert not tlayers._use_fused_outlook(3, 2, 1, 8, 8, cpu)
    assert tlayers._use_fused_outlook(3, 2, 1, 8, 8, cuda)
    assert not tlayers._use_fused_outlook(3, 1, 1, 8, 8, cuda)
