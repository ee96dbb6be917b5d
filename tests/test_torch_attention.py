"""K1 (fused MHSA on the raw qkv projection) in autoprog_tpu_torch against
the Pallas kernel `autoprog_tpu.ops.attention_pallas.mhsa_fused_qkv`, run in
interpret mode as tests/test_attention_pallas.py runs it.

On the CPU the port's wrapper runs its plain twins (forward and the
kernel's backward formula), which round at exactly the Pallas kernel's
points. Tolerance: f32 rtol/atol 1e-5 (summation order only); bf16 2 ulp of
the largest |value| (2^-6 relative), since another summation order can flip
one rounding to bf16. The CUDA kernel itself is checked against the twins
on the card (tests/test_torch_cuda.py, and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoprog_tpu.ops import attention_pallas as ap
from autoprog_tpu_torch.ops import attention as A

HEADS, D = 2, 32          # VOLO head_dim
SCALE = D ** -0.5


def inputs(B, n, seed, dtype):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, n, 3 * HEADS * D).astype(np.float32)
    g = rs.randn(B, n, HEADS * D).astype(np.float32)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    return (jnp.asarray(x, jdt), jnp.asarray(g, jdt),
            torch.from_numpy(x).to(dtype), torch.from_numpy(g).to(dtype))


def assert_close(got: torch.Tensor, ref, dtype):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = got.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - ref).max() <= 2.0 ** -6 * max(1.0, np.abs(ref).max())


CASES = [(torch.float32, False), (torch.bfloat16, False), (torch.bfloat16, True)]


@pytest.mark.parametrize("dtype,scores_f32", CASES)
@pytest.mark.parametrize("n", [64, 196])
def test_twin_forward_matches_pallas(dtype, scores_f32, n):
    jx, _, tx, _ = inputs(2, n, seed=n, dtype=dtype)
    ref = ap._qkv_fwd_raw(jx, HEADS, SCALE, True, scores_f32=scores_f32)
    got = A.mhsa_fused_qkv(tx, HEADS, SCALE, scores_f32=scores_f32)
    assert got.shape == (2, n, HEADS * D) and got.dtype == dtype
    assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype,scores_f32", CASES)
def test_twin_grads_match_pallas(dtype, scores_f32, monkeypatch):
    """The autograd Function's CPU backward against the Pallas custom_vjp
    (both recompute p at the forward's score dtype)."""
    monkeypatch.setenv("AUTOPROG_ATTN_SCORES_F32", "1" if scores_f32 else "0")
    jx, jg, tx, tg = inputs(2, 64, seed=5, dtype=dtype)
    _, vjp = jax.vjp(lambda x: ap.mhsa_fused_qkv(x, HEADS, SCALE, True), jx)
    (ref,) = vjp(jg)
    tx.requires_grad_(True)
    A.mhsa_fused_qkv(tx, HEADS, SCALE).backward(tg)
    assert tx.grad.dtype == dtype
    assert_close(tx.grad, ref, dtype)
    ref_direct = ap._qkv_bwd_raw(jx, jg, HEADS, SCALE, True, scores_f32=scores_f32)
    assert_close(A.mhsa_fused_qkv_backward_reference(tx.detach(), tg, HEADS, SCALE,
                                                     scores_f32), ref_direct, dtype)


def test_cpu_twin_counts_no_launches():
    before = dict(A.LAUNCHES)
    _, _, tx, tg = inputs(1, 16, seed=1, dtype=torch.float32)
    tx.requires_grad_(True)
    A.mhsa_fused_qkv(tx, HEADS, SCALE).backward(tg)
    assert A.LAUNCHES == before


@pytest.mark.parametrize("shape,heads,dtype,match", [
    ((2, 16, 3 * 64), 2, torch.float16, "dtype"),
    ((2, 16, 3 * 64 + 1), 2, torch.float32, r"\[B, n, 3C\]"),
    ((2, 16, 3 * 64), 3, torch.float32, "divisible"),
    ((2, 1025, 3 * 64), 2, torch.float32, "limits"),
    ((2, 16, 3 * 2 * 256), 2, torch.float32, "limits"),
])
def test_launch_checks_refuse_what_the_kernel_does_not_take(shape, heads, dtype, match):
    with pytest.raises(ValueError, match=match):
        A._check_cuda(torch.zeros(shape, dtype=dtype), heads)


def test_launch_checks_refuse_non_contiguous():
    x = torch.zeros(2, 3 * 64, 16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        A._check_cuda(x, 2)


def test_wrapper_refuses_a_device_it_has_no_path_for():
    x = torch.zeros(1, 4, 3 * HEADS * D, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        A.mhsa_fused_qkv(x, HEADS, SCALE)


# ------------------------------------------ the row statistics (rowmax, z)
#
# The forward twin can return them and the backward twin can take them, as
# the kernels do. Held against the twins without statistics exactly (the same
# operations on the same values) and against the interpreted Pallas kernels
# at the tolerances above.

STAT_SHAPES = [(64, 32), (100, 32), (144, 32), (196, 32), (197, 64), (272, 32)]   # n, head_dim
STAT_TYPES = [(torch.float32, False), (torch.float32, True),
              (torch.bfloat16, False), (torch.bfloat16, True)]


def shaped_inputs(n, d, seed, dtype, B=1):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, n, 3 * HEADS * d).astype(np.float32)
    g = rs.randn(B, n, HEADS * d).astype(np.float32)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    return (jnp.asarray(x, jdt), jnp.asarray(g, jdt),
            torch.from_numpy(x).to(dtype), torch.from_numpy(g).to(dtype))


@pytest.mark.parametrize("dtype,scores_f32", STAT_TYPES)
@pytest.mark.parametrize("n,d", STAT_SHAPES)
def test_forward_twin_with_statistics(dtype, scores_f32, n, d):
    jx, _, tx, _ = shaped_inputs(n, d, seed=n + d, dtype=dtype)
    scale = d ** -0.5
    out, stats = A.mhsa_fused_qkv_reference(tx, HEADS, scale, scores_f32, return_stats=True)
    assert torch.equal(out, A.mhsa_fused_qkv_reference(tx, HEADS, scale, scores_f32))
    assert stats.shape == (1, HEADS, n, 2) and stats.dtype == torch.float32
    # they are the row maximum of the rounded scores and the sum of exp(S - max)
    q, k, _ = A._split_heads(tx, HEADS)
    s = A._scores((q.float() * scale).to(dtype), k, torch.float32 if scores_f32 else dtype)
    assert torch.equal(stats[..., 0], s.amax(-1))
    assert torch.equal(stats[..., 1], torch.exp(s - s.amax(-1, keepdim=True)).sum(-1))
    assert (stats[..., 1] >= 1).all()
    assert_close(out, ap._qkv_fwd_raw(jx, HEADS, scale, True, scores_f32=scores_f32), dtype)


@pytest.mark.parametrize("dtype,scores_f32", STAT_TYPES)
@pytest.mark.parametrize("n,d", STAT_SHAPES)
def test_backward_twin_takes_the_statistics(dtype, scores_f32, n, d):
    jx, jg, tx, tg = shaped_inputs(n, d, seed=2 * n + d, dtype=dtype)
    scale = d ** -0.5
    _, stats = A.mhsa_fused_qkv_reference(tx, HEADS, scale, scores_f32, return_stats=True)
    got = A.mhsa_fused_qkv_backward_reference(tx, tg, HEADS, scale, scores_f32, stats)
    assert torch.equal(got, A.mhsa_fused_qkv_backward_reference(tx, tg, HEADS, scale,
                                                                scores_f32))
    assert_close(got, ap._qkv_bwd_raw(jx, jg, HEADS, scale, True, scores_f32=scores_f32),
                 dtype)


@pytest.mark.parametrize("dtype,scores_f32", CASES)
def test_function_hands_the_statistics_from_forward_to_backward(dtype, scores_f32,
                                                               monkeypatch):
    """MhsaFusedQkv on the CPU: the forward keeps (rowmax, z) only when a
    backward will follow, the backward twin is given them, and the gradient
    is the Pallas custom_vjp's."""
    monkeypatch.setenv("AUTOPROG_ATTN_SCORES_F32", "1" if scores_f32 else "0")
    jx, jg, tx, tg = inputs(2, 100, seed=9, dtype=dtype)
    seen = {}
    fwd, bwd = A.mhsa_fused_qkv_reference, A.mhsa_fused_qkv_backward_reference

    def spy_fwd(qkv, heads, scale, sf=False, return_stats=False):
        seen.setdefault("return_stats", []).append(return_stats)
        return fwd(qkv, heads, scale, sf, return_stats)

    def spy_bwd(qkv, dout, heads, scale, sf=False, stats=None):
        seen["stats"] = stats
        return bwd(qkv, dout, heads, scale, sf, stats)

    monkeypatch.setattr(A, "mhsa_fused_qkv_reference", spy_fwd)
    monkeypatch.setattr(A, "mhsa_fused_qkv_backward_reference", spy_bwd)
    A.mhsa_fused_qkv(tx, HEADS, SCALE)                     # no gradient wanted
    with torch.no_grad():
        A.mhsa_fused_qkv(tx.clone().requires_grad_(True), HEADS, SCALE)
    tx.requires_grad_(True)
    A.mhsa_fused_qkv(tx, HEADS, SCALE).backward(tg)
    assert seen["return_stats"] == [False, True, True]
    assert torch.equal(seen["stats"], fwd(tx.detach(), HEADS, SCALE, scores_f32, True)[1])
    _, vjp = jax.vjp(lambda x: ap.mhsa_fused_qkv(x, HEADS, SCALE, True), jx)
    assert_close(tx.grad, vjp(jg)[0], dtype)


def test_launch_checks_refuse_statistics_of_another_shape():
    x = torch.zeros(2, 16, 3 * HEADS * D)
    good = torch.zeros(2, HEADS, 16, 2)
    assert A._check_stats("bwd", None, x, 2, HEADS, 16) is None
    assert A._check_stats("bwd", good, x, 2, HEADS, 16) == good.data_ptr()
    for bad in (torch.zeros(2, HEADS, 16, 3), good.double(), good.transpose(1, 2)):
        with pytest.raises(ValueError, match="stats"):
            A._check_stats("bwd", bad, x, 2, HEADS, 16)
