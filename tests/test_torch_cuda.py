"""GPU-only tests of autoprog_tpu_torch: the CUDA kernels (K1, the fused
MHSA; K2, K3, K4, the fused outlook attention and its attend variants; K5,
the MHSA on separate q, k, v; the schedule variants S1 and S2 of K1)
against their plain PyTorch twins, on the card. They skip without a CUDA device (a CUDA
kernel has no CPU mode); the CPU tests hold the twins against the JAX
package.

This file imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: the kernel and the twin round at the same points and differ
only in f32 summation order, which can flip one rounding to the working
dtype: 2 ulp of the largest |value| (bf16 2^-6 relative, f32 2^-20).
"""

import pytest
import torch

from autoprog_tpu_torch.ops import attention as A

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 2.0 ** -20}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def assert_close(got, ref, dtype):
    err = (got.float() - ref.float()).abs().max().item()
    assert torch.isfinite(got).all()
    assert err <= TOL[dtype] * max(1.0, ref.float().abs().max().item()), err


@pytest.mark.parametrize("scores_f32", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,n,heads,d", [
    (4, 196, 12, 32),      # volo_d1 at 224 px
    (2, 1024, 2, 128),     # the router's edge
    (3, 37, 3, 48),        # ragged n, head_dim not a power of two
    (2, 1, 2, 32),
    (2, 70, 2, 20),        # head_dim % 8 != 0: scalar loads
    (2, 129, 4, 64),
])
def test_kernel_matches_twin(cuda_device, dtype, scores_f32, B, n, heads, d):
    g = torch.Generator(cuda_device).manual_seed(0)
    x = torch.randn(B, n, 3 * heads * d, device=cuda_device, generator=g).to(dtype)
    dout = torch.randn(B, n, heads * d, device=cuda_device, generator=g).to(dtype)
    scale = d ** -0.5
    before = dict(A.LAUNCHES)
    x.requires_grad_(True)
    out = A.mhsa_fused_qkv(x, heads, scale, scores_f32=scores_f32)
    out.backward(dout)
    torch.cuda.synchronize()
    assert A.LAUNCHES == {**before, "fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}
    assert out.dtype == x.grad.dtype == dtype
    assert_close(out, A.mhsa_fused_qkv_reference(x.detach(), heads, scale, scores_f32),
                 dtype)
    assert_close(x.grad, A.mhsa_fused_qkv_backward_reference(
        x.detach(), dout, heads, scale, scores_f32), dtype)


def test_kernel_takes_an_unaligned_base(cuda_device):
    """A qkv view whose base is not 16-byte aligned takes the scalar loads."""
    B, n, heads, d = 2, 196, 12, 32
    g = torch.Generator(cuda_device).manual_seed(1)
    flat = torch.randn(B * n * 3 * heads * d + 1, device=cuda_device,
                       generator=g).bfloat16()
    x = flat[1:].view(B, n, 3 * heads * d)
    dout = torch.randn(B, n, heads * d, device=cuda_device, generator=g).bfloat16()
    scale = d ** -0.5
    out = A._launch_fwd(x, heads, scale, False)
    dx = A._launch_bwd(x, dout, heads, scale, False)
    torch.cuda.synchronize()
    assert_close(out, A.mhsa_fused_qkv_reference(x, heads, scale), torch.bfloat16)
    assert_close(dx, A.mhsa_fused_qkv_backward_reference(x, dout, heads, scale),
                 torch.bfloat16)


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    x = torch.zeros(2, 16, 3 * 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        A.mhsa_fused_qkv(x, 2, 0.125)


def test_volo_through_the_kernel_matches_the_unfused_path(cuda_device, monkeypatch):
    """volo_h2_l4 forward and backward in f32 on the card, MHSA through K1
    against the unfused PyTorch path; summation order only (rtol 1e-4)."""
    from autoprog_tpu_torch import create_model
    torch.manual_seed(0)
    model = create_model("volo_h2_l4").make(num_classes=10, img_size=64,
                                            dtype=torch.float32).to(cuda_device)
    x = torch.randn(2, 64, 64, 3, device=cuda_device)
    bbox = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    runs = {}
    for fused in ("0", "1"):
        monkeypatch.setenv("AUTOPROG_FUSED_ATTN", fused)
        model.zero_grad(set_to_none=True)
        before = A.LAUNCHES["bwd"]
        x_cls, x_aux, _ = model(x, train=True, bbox=bbox)
        (x_cls.square().mean() + x_aux.square().mean()).backward()
        torch.cuda.synchronize()
        assert (A.LAUNCHES["bwd"] > before) == (fused == "1")
        runs[fused] = (x_cls.detach(), {n: p.grad.clone() for n, p in
                                        model.named_parameters() if p.grad is not None})
    torch.testing.assert_close(runs["1"][0], runs["0"][0], rtol=1e-4, atol=1e-5)
    for name, grad in runs["0"][1].items():
        torch.testing.assert_close(runs["1"][1][name], grad, rtol=1e-4, atol=1e-5,
                                   msg=name)


# ----------------------------------------------- outlook attention (K2, K3, K4)

OUTLOOK_SHAPES = [
    (4, 28, 28, 192, 6),     # volo_d1 at 224 px
    (4, 16, 16, 192, 6),     # ... at 128 px
    (4, 20, 20, 192, 6),     # ... at 160 px
    (4, 24, 24, 192, 6),     # ... at 192 px
    (2, 28, 28, 384, 12),    # volo_d4 / d5 width
    (2, 10, 6, 96, 2),       # H != W, head_dim 48
    (1, 64, 64, 40, 2),      # several row tiles per image, head_dim 20
    (3, 2, 2, 8, 1),         # one window
]


def _outlook_inputs(device, dtype, B, H, W, C, heads, seed=0):
    from autoprog_tpu_torch.ops import outlook_fused as O
    g = torch.Generator(device).manual_seed(seed)
    v = torch.randn(B, H, W, C, device=device, generator=g).to(dtype)
    logits = (3 * torch.randn(B, H // 2, W // 2, heads * 81, device=device,
                              generator=g)).to(dtype)
    gout = torch.randn(B, H, W, C, device=device, generator=g).to(dtype)
    return O, v, logits, gout, (C // heads) ** -0.5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,heads", OUTLOOK_SHAPES)
def test_outlook_fused_matches_twin(cuda_device, dtype, B, H, W, C, heads):
    O, v, logits, gout, scale = _outlook_inputs(cuda_device, dtype, B, H, W, C, heads)
    before = dict(O.LAUNCHES)
    v.requires_grad_(True)
    logits.requires_grad_(True)
    out = O.outlook_attention_fused(v, logits, heads, scale)
    out.backward(gout)
    torch.cuda.synchronize()
    assert O.LAUNCHES == dict(before, fwd=before["fwd"] + 1, bwd=before["bwd"] + 1)
    assert out.dtype == v.grad.dtype == logits.grad.dtype == dtype
    vd, ld = v.detach(), logits.detach()
    assert_close(out, O.outlook_attention_fused_reference(vd, ld, heads, scale), dtype)
    dv, dlogits = O.outlook_attention_backward_reference(vd, ld, gout, heads, scale)
    assert_close(v.grad, dv, dtype)
    assert_close(logits.grad, dlogits, dtype)


@pytest.mark.parametrize("head_minor", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,heads", OUTLOOK_SHAPES[:1] + OUTLOOK_SHAPES[5:])
def test_outlook_attend_matches_twin(cuda_device, dtype, head_minor, B, H, W, C, heads):
    O, v, logits, _, scale = _outlook_inputs(cuda_device, dtype, B, H, W, C, heads, seed=1)
    n = (H // 2) * (W // 2)
    patches = v.new_empty(B, n, 9, C).copy_(
        O.unfold_nhwc(v, 3, 2, 1).reshape(B, n, 9, C))
    att = logits.reshape(B, n, heads, 9, 9).permute(0, 1, 3, 4, 2).contiguous()
    key = "attend_hm" if head_minor else "attend"
    before = O.LAUNCHES[key]
    out = O._launch_attend(patches, att, heads, scale, head_minor)
    torch.cuda.synchronize()
    assert O.LAUNCHES[key] == before + 1
    assert_close(out, O.outlook_attend_reference(patches, att, heads, scale, head_minor),
                 dtype)


@pytest.mark.parametrize("name", ["outlook_attention_hybrid", "outlook_attention_hybrid2"])
def test_outlook_hybrids_match_the_fused_op(cuda_device, name):
    """K3 / K4 with PyTorch's unfold and fold around them against K2, f32:
    the same sums in another order (rtol 1e-5), and the shared backward."""
    O, v, logits, gout, scale = _outlook_inputs(cuda_device, torch.float32, 2, 28, 28,
                                                192, 6, seed=2)
    v.requires_grad_(True)
    logits.requires_grad_(True)
    before = O.LAUNCHES["bwd"]
    out = getattr(O, name)(v, logits, 6, scale)
    out.backward(gout)
    torch.cuda.synchronize()
    assert O.LAUNCHES["bwd"] == before + 1
    torch.testing.assert_close(
        out, O.outlook_attention_fused_reference(v.detach(), logits.detach(), 6, scale),
        rtol=1e-5, atol=1e-5)
    dv, dlogits = O.outlook_attention_backward_reference(v.detach(), logits.detach(), gout,
                                                         6, scale)
    torch.testing.assert_close(v.grad, dv, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(logits.grad, dlogits, rtol=1e-5, atol=1e-5)


def test_outlook_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    from autoprog_tpu_torch.ops import outlook_fused as O
    v = torch.zeros(1, 5, 4, 8, device=cuda_device)
    with pytest.raises(ValueError, match="even H, W"):
        O.outlook_attention_fused(v, torch.zeros(1, 2, 2, 81, device=cuda_device), 1, 1.0)
    v = torch.zeros(1, 4, 4, 8, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        O.outlook_attention_fused(v, torch.zeros(1, 2, 2, 81, device=cuda_device,
                                                 dtype=torch.float16), 1, 1.0)


def test_volo_through_the_fused_outlook_matches_the_unfused_path(cuda_device, monkeypatch):
    """volo_h2_l4 forward and backward in f32 on the card with
    AUTOPROG_FUSED_OUTLOOK=1 against =0: in f32 both paths compute the same
    formula, summation order only (rtol 1e-4)."""
    from autoprog_tpu_torch import create_model
    from autoprog_tpu_torch.ops import outlook_fused as O
    torch.manual_seed(0)
    model = create_model("volo_h2_l4").make(num_classes=10, img_size=64,
                                            dtype=torch.float32).to(cuda_device)
    x = torch.randn(2, 64, 64, 3, device=cuda_device)
    bbox = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    runs = {}
    for fused in ("0", "1"):
        monkeypatch.setenv("AUTOPROG_FUSED_OUTLOOK", fused)
        model.zero_grad(set_to_none=True)
        before = O.LAUNCHES["bwd"]
        x_cls, x_aux, _ = model(x, train=True, bbox=bbox)
        (x_cls.square().mean() + x_aux.square().mean()).backward()
        torch.cuda.synchronize()
        assert (O.LAUNCHES["bwd"] > before) == (fused == "1")
        runs[fused] = (x_cls.detach(), {n: p.grad.clone() for n, p in
                                        model.named_parameters() if p.grad is not None})
    torch.testing.assert_close(runs["1"][0], runs["0"][0], rtol=1e-4, atol=1e-5)
    for name, grad in runs["0"][1].items():
        torch.testing.assert_close(runs["1"][1][name], grad, rtol=1e-4, atol=1e-5,
                                   msg=name)


# ------------------------------------------- K5 and the variants S1 / S2

MHSA_SHAPES = [
    (4, 196, 12, 32),      # volo_d1 at 224 px
    (2, 197, 6, 64),       # deit_small
    (3, 37, 3, 48),        # ragged n, head_dim not a power of two
    (2, 70, 2, 24),
]


def _qkv(cuda_device, B, n, heads, d, dtype, seed=0):
    g = torch.Generator(cuda_device).manual_seed(seed)
    x = torch.randn(B, n, 3 * heads * d, device=cuda_device, generator=g).to(dtype)
    dout = torch.randn(B, n, heads * d, device=cuda_device, generator=g).to(dtype)
    return x, dout


@pytest.mark.parametrize("views", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,n,heads,d", MHSA_SHAPES + [(2, 1024, 2, 128), (2, 70, 2, 20)])
def test_mhsa_fused_kernel_matches_twin_and_k1(cuda_device, dtype, views, B, n, heads, d):
    """K5 on the three views of a qkv buffer (read in place by stride) and on
    contiguous tensors, against its twin and against K1 at f32 scores."""
    x, dout = _qkv(cuda_device, B, n, heads, d, dtype)
    scale = d ** -0.5
    q, k, v = x.view(B, n, 3, heads, d).unbind(2)
    if not views:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)] if not views else None
    before = dict(A.LAUNCHES)
    if views:
        xr = x.clone().requires_grad_(True)
        out = A.mhsa_fused(*xr.view(B, n, 3, heads, d).unbind(2), scale)
        out.backward(dout.view(B, n, heads, d))
        grads = xr.grad.view(B, n, 3, heads, d).unbind(2)
    else:
        out = A.mhsa_fused(*leaves, scale)
        out.backward(dout.view(B, n, heads, d))
        grads = [t.grad for t in leaves]
    torch.cuda.synchronize()
    assert A.LAUNCHES == {**before, "fused_fwd": before["fused_fwd"] + 1,
                          "fused_bwd": before["fused_bwd"] + 1}
    assert_close(out, A.mhsa_fused_reference(q, k, v, scale), dtype)
    refs = A.mhsa_fused_backward_reference(q, k, v, dout.view(B, n, heads, d), scale)
    for got, ref in zip(grads, refs):
        assert_close(got, ref, dtype)
    k1 = A._launch_fwd(x, heads, scale, True)
    assert torch.equal(out.reshape(B, n, heads * d), k1)


def test_mhsa_fused_refuses_a_strided_last_axis(cuda_device):
    q = torch.zeros(2, 8, 2, 32, device=cuda_device).transpose(2, 3)
    with pytest.raises(ValueError, match="last axis"):
        A.mhsa_fused(q, q, q, 0.3)


@pytest.mark.parametrize("name", ["twophase", "twophase_bf16s", "pipelined"])
@pytest.mark.parametrize("B,n,heads,d", MHSA_SHAPES)
def test_schedule_variant_matches_twin_and_k1(cuda_device, name, B, n, heads, d):
    from autoprog_tpu_torch.scripts import attn_variants as V
    x, dout = _qkv(cuda_device, B, n, heads, d, torch.bfloat16, seed=2)
    scale = d ** -0.5
    before = V.LAUNCHES[name]
    xr = x.clone().requires_grad_(True)
    out = V.mhsa_variant_with_shared_bwd(name)(xr, heads, scale)
    out.backward(dout)
    torch.cuda.synchronize()
    assert V.LAUNCHES[name] == before + 1
    assert_close(out, V.mhsa_fwd_variant_reference(name, x, heads, scale), torch.bfloat16)
    assert torch.equal(out, A._launch_fwd(x, heads, scale, V.SCORES_F32[name]))
    assert_close(xr.grad, A.mhsa_fused_qkv_backward_reference(
        x, dout, heads, scale, A.scores_f32_default()), torch.bfloat16)


def test_schedule_variants_refuse_what_does_not_fit(cuda_device):
    """f32 score rows of n = 1024 do not fit a block's shared memory (parked
    at bf16 they do); `pipelined` copies 16 bytes at a time."""
    from autoprog_tpu_torch.scripts import attn_variants as V
    x, _ = _qkv(cuda_device, 2, 1024, 2, 128, torch.bfloat16)
    with pytest.raises(ValueError, match="refused"):
        V.mhsa_fwd_variant("twophase", x, 2, 0.1)
    out = V.mhsa_fwd_variant("twophase_bf16s", x, 2, 0.1)
    assert_close(out, V.mhsa_fwd_variant_reference("twophase_bf16s", x, 2, 0.1),
                 torch.bfloat16)
    x, _ = _qkv(cuda_device, 2, 33, 3, 20, torch.bfloat16)
    with pytest.raises(ValueError, match="refused"):
        V.mhsa_fwd_variant("pipelined", x, 3, 0.2)
    with pytest.raises(ValueError, match="bfloat16"):
        V.mhsa_fwd_variant("pipelined", x.float(), 3, 0.2)


@pytest.mark.parametrize("order,G", [("phase", 1), ("phase", 2), ("phase", 4),
                                     ("loop", 1), ("loop", 2), ("loop", 4)])
@pytest.mark.parametrize("B,n,heads,d", MHSA_SHAPES)
def test_group_variant_matches_twin_and_k1(cuda_device, order, G, B, n, heads, d):
    from autoprog_tpu_torch.scripts import bench_attn_x as X
    B = 4                                       # a multiple of every G
    x, dout = _qkv(cuda_device, B, n, heads, d, torch.bfloat16, seed=3)
    scale = d ** -0.5
    key = X.variant_name(order, G)
    before = (X.LAUNCHES[key + "_fwd"], X.LAUNCHES[key + "_bwd"])
    xr = x.clone().requires_grad_(True)
    out = X.make_variant(order, G, heads, scale)(xr)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (X.LAUNCHES[key + "_fwd"], X.LAUNCHES[key + "_bwd"]) == (before[0] + 1,
                                                                    before[1] + 1)
    assert_close(out, X.group_reference(x, heads, scale), torch.bfloat16)
    assert_close(xr.grad, X.group_backward_reference(x, dout, heads, scale), torch.bfloat16)
    assert torch.equal(out, A._launch_fwd(x, heads, scale, True))
    assert torch.equal(xr.grad, A._launch_bwd(x, dout, heads, scale, True))


def test_group_variant_refuses_a_g_that_does_not_fit(cuda_device):
    """The parked rows of G cells must fit one block: n = 1024 does not at
    G = 2 (order phase); order loop parks nothing and takes it."""
    from autoprog_tpu_torch.scripts import bench_attn_x as X
    x, _ = _qkv(cuda_device, 2, 1024, 2, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="refused"):
        X.make_variant("phase", 2, 2, 0.1)(x)
    out = X.make_variant("loop", 2, 2, 0.1)(x)
    assert_close(out, X.group_reference(x, 2, 0.1), torch.bfloat16)


def test_deit_small_forward_through_k1_matches_unfused(cuda_device, monkeypatch):
    """deit_small eval logits through K1 (n = 197, head_dim 64) against the
    unfused MHSA, f32: the same formula; 1e-3 on logits of magnitude ~1."""
    from autoprog_tpu_torch import create_model
    torch.manual_seed(0)
    model = create_model("deit_small_patch16_224").make(
        num_classes=100, dtype=torch.float32).to(cuda_device)
    x = torch.randn(2, 224, 224, 3, device=cuda_device)
    before = A.LAUNCHES["fwd"]
    with torch.no_grad():
        monkeypatch.setenv("AUTOPROG_FUSED_ATTN", "0")
        plain = model(x, train=False)
        monkeypatch.setenv("AUTOPROG_FUSED_ATTN", "1")
        fused = model(x, train=False)
    assert A.LAUNCHES["fwd"] - before == 12
    assert (fused - plain).abs().max().item() <= 1e-3
