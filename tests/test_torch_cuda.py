"""GPU-only tests of autoprog_tpu_torch: the CUDA kernels (K1, the fused
MHSA; K2, K3, K4, the fused outlook attention and its attend variants; K5,
the MHSA on separate q, k, v; the schedule variants S1 and S2 of K1)
against their plain PyTorch twins, on the card; and the checkpoint path
through them: the validator equals the trainer's eval row, a resume restores
the state bit for bit. They skip without a CUDA device (a CUDA
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


# bf16 with n <= 256 and head_dim <= 64 runs the resident path (K and V of a
# cell in shared memory, one backward kernel per cell); everything else streams.
EDGE_SHAPES = [
    (2, 256, 2, 32), (2, 257, 2, 32),      # both sides of the limit on n
    (2, 256, 2, 64), (2, 200, 2, 72),      # ... and on head_dim
    (2, 1, 2, 32), (3, 15, 2, 32), (3, 16, 2, 32), (3, 17, 2, 32),
    (2, 208, 3, 24), (2, 209, 3, 40),      # a step boundary; head_dim % 16 != 0
    (2, 100, 12, 32), (2, 144, 12, 32), (2, 198, 6, 64),
]


def assert_stats_close(stats, ref, dtype):
    """(rowmax, z): the maximum, and log-sum-exp = max + log z, which does not
    depend on which of two near-equal scores was the maximum, at the
    tolerance of the scores themselves."""
    assert_close(stats[..., 0], ref[..., 0], dtype)
    assert_close(stats[..., 0] + stats[..., 1].log(), ref[..., 0] + ref[..., 1].log(), dtype)


@pytest.mark.parametrize("scores_f32", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,n,heads,d", EDGE_SHAPES)
def test_kernel_statistics_on_both_paths(cuda_device, dtype, scores_f32, B, n, heads, d):
    """The forward's (rowmax, z) against the twin's, the backward fed them
    against the backward twin fed the twin's, and the results with and without
    statistics bit for bit the same."""
    x, dout = _qkv(cuda_device, B, n, heads, d, dtype, seed=4)
    scale = d ** -0.5
    out, stats = A._launch_fwd(x, heads, scale, scores_f32, want_stats=True)
    plain = A._launch_fwd(x, heads, scale, scores_f32)
    grad = A._launch_bwd(x, dout, heads, scale, scores_f32, stats)
    alone = A._launch_bwd(x, dout, heads, scale, scores_f32)
    torch.cuda.synchronize()
    ref, ref_stats = A.mhsa_fused_qkv_reference(x, heads, scale, scores_f32, True)
    assert stats.shape == (B, heads, n, 2) and stats.dtype == torch.float32
    assert_stats_close(stats, ref_stats, dtype)
    assert_close(out, ref, dtype)
    assert torch.equal(out, plain)
    assert_close(grad, A.mhsa_fused_qkv_backward_reference(x, dout, heads, scale, scores_f32,
                                                           ref_stats), dtype)
    assert torch.equal(grad, alone)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,n,heads,d", EDGE_SHAPES)
def test_mhsa_fused_kernel_statistics_on_both_paths(cuda_device, dtype, B, n, heads, d):
    x, dout = _qkv(cuda_device, B, n, heads, d, dtype, seed=5)
    scale = d ** -0.5
    q, k, v = x.view(B, n, 3, heads, d).unbind(2)
    g4 = dout.view(B, n, heads, d)
    out, stats = A._launch_fused_fwd(q, k, v, scale, want_stats=True)
    grads = A._launch_fused_bwd(q, k, v, g4, scale, stats)
    alone = A._launch_fused_bwd(q, k, v, g4, scale)
    torch.cuda.synchronize()
    ref, ref_stats = A.mhsa_fused_reference(q, k, v, scale, True)
    assert_stats_close(stats, ref_stats, dtype)
    assert_close(out, ref, dtype)
    for got, same, want in zip(grads, alone,
                               A.mhsa_fused_backward_reference(q, k, v, g4, scale, ref_stats)):
        assert_close(got, want, dtype)
        assert torch.equal(got, same)
    assert torch.equal(out.reshape(B, n, heads * d), A._launch_fwd(x, heads, scale, True))


def test_statistics_are_kept_only_for_a_backward(cuda_device, monkeypatch):
    x, dout = _qkv(cuda_device, 2, 196, 12, 32, torch.bfloat16)
    asked = []
    launch = A._launch_fwd

    def spy(qkv, heads, scale, sf, want_stats=False):
        asked.append(want_stats)
        return launch(qkv, heads, scale, sf, want_stats)

    monkeypatch.setattr(A, "_launch_fwd", spy)
    plain = A.mhsa_fused_qkv(x, 12, 32 ** -0.5)
    with torch.no_grad():
        A.mhsa_fused_qkv(x.clone().requires_grad_(True), 12, 32 ** -0.5)
    xr = x.clone().requires_grad_(True)
    out = A.mhsa_fused_qkv(xr, 12, 32 ** -0.5)
    out.backward(dout)
    assert asked == [False, True, True]
    assert torch.equal(out, plain)
    assert_close(xr.grad, A.mhsa_fused_qkv_backward_reference(x, dout, 12, 32 ** -0.5),
                 torch.bfloat16)


@pytest.mark.parametrize("B,n,heads,d", [(16, 196, 12, 32), (8, 197, 6, 64), (2, 300, 2, 64)])
def test_gradients_are_the_same_from_run_to_run(cuda_device, B, n, heads, d):
    """No atomics and no sum carried between blocks: bit for bit."""
    x, dout = _qkv(cuda_device, B, n, heads, d, torch.bfloat16, seed=6)
    scale = d ** -0.5
    _, stats = A._launch_fwd(x, heads, scale, False, want_stats=True)
    first = A._launch_bwd(x, dout, heads, scale, False, stats)
    for _ in range(3):
        assert torch.equal(A._launch_bwd(x, dout, heads, scale, False, stats), first)


def test_kernel_with_statistics_takes_an_unaligned_base(cuda_device):
    B, n, heads, d = 2, 197, 6, 64
    g = torch.Generator(cuda_device).manual_seed(7)
    flat = torch.randn(B * n * 3 * heads * d + 1, device=cuda_device, generator=g).bfloat16()
    x = flat[1:].view(B, n, 3 * heads * d)
    dout = torch.randn(B, n, heads * d, device=cuda_device, generator=g).bfloat16()
    scale = d ** -0.5
    out, stats = A._launch_fwd(x, heads, scale, False, want_stats=True)
    dx = A._launch_bwd(x, dout, heads, scale, False, stats)
    torch.cuda.synchronize()
    aligned = x.clone()
    assert torch.equal(out, A._launch_fwd(aligned, heads, scale, False))
    assert torch.equal(dx, A._launch_bwd(aligned, dout, heads, scale, False))
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
    (3, 64, 64, 192, 6),     # several runs of rows per image
    (2, 28, 28, 256, 8),     # volo_d2 / d3 width
    (2, 6, 6, 6, 2),         # head_dim 3: the general kernels in both dtypes
]
#: the volo_d1 map at the trainers' batches: phase 4's 64 (two runs of 7 rows
#: an image) and the bench's 128 (one run of 14 rows, the ring reused 4 times)
TRAINER_SHAPES = [(64, 28, 28, 192, 6), (128, 28, 28, 192, 6)]


def _outlook_inputs(device, dtype, B, H, W, C, heads, seed=0):
    from autoprog_tpu_torch.ops import outlook_fused as O
    g = torch.Generator(device).manual_seed(seed)
    v = torch.randn(B, H, W, C, device=device, generator=g).to(dtype)
    logits = (3 * torch.randn(B, H // 2, W // 2, heads * 81, device=device,
                              generator=g)).to(dtype)
    gout = torch.randn(B, H, W, C, device=device, generator=g).to(dtype)
    return O, v, logits, gout, (C // heads) ** -0.5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,heads", OUTLOOK_SHAPES + TRAINER_SHAPES)
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


def _rows_route(C, heads, dtype):
    """K2 takes its row kernels where a head's channels are whole 16-byte
    groups (on aligned tensors), its general kernels elsewhere."""
    return (C // heads) * torch.tensor([], dtype=dtype).element_size() % 16 == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,heads", OUTLOOK_SHAPES + TRAINER_SHAPES)
def test_outlook_fused_takes_its_route_and_repeats_its_bits(cuda_device, dtype, B, H, W, C,
                                                             heads):
    """The row kernels at every shape they take (the general ones elsewhere),
    and a second launch on the same inputs gives the same bits: nothing is
    summed across blocks."""
    O, v, logits, gout, scale = _outlook_inputs(cuda_device, dtype, B, H, W, C, heads, seed=3)
    first = (O._launch_fwd(v, logits, heads, scale),
             *O._launch_bwd(v, logits, gout, heads, scale))
    assert O.PLANS["fwd"]["rows"] == O.PLANS["bwd"]["rows"] == int(_rows_route(C, heads, dtype))
    second = (O._launch_fwd(v, logits, heads, scale),
              *O._launch_bwd(v, logits, gout, heads, scale))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,heads", [
    (96, 28, 28, 384, 12),       # volo_d4 width: more items than resident blocks
])
def test_outlook_row_kernels_walk_more_items_than_blocks(cuda_device, dtype, B, H, W, C, heads):
    """Persistent blocks: where the items (image, run, head group) outnumber
    the blocks the card holds, and do not divide evenly over them, each
    block walks several and the result holds the twins' values and the same
    bits from a second launch."""
    O, v, logits, gout, scale = _outlook_inputs(cuda_device, dtype, B, H, W, C, heads, seed=4)
    first = (O._launch_fwd(v, logits, heads, scale),
             *O._launch_bwd(v, logits, gout, heads, scale))
    for side in ("fwd", "bwd"):
        plan = O.PLANS[side]
        items = B * plan["runs"] * (heads // plan["heads_per_block"])
        assert plan["rows"] == 1 and items > plan["blocks"] and items % plan["blocks"], plan
    second = (O._launch_fwd(v, logits, heads, scale),
              *O._launch_bwd(v, logits, gout, heads, scale))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert_close(first[0], O.outlook_attention_fused_reference(v, logits, heads, scale), dtype)
    dv, dlogits = O.outlook_attention_backward_reference(v, logits, gout, heads, scale)
    assert_close(first[1], dv, dtype)
    assert_close(first[2], dlogits, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_outlook_row_kernels_take_logits_at_any_alignment(cuda_device, dtype):
    """Logits whose base is only element-aligned (a contiguous view one value
    into a buffer): the row kernels stage each window's span from the 16-byte
    chunks that hold it. A v that is not 16-byte aligned goes to the general
    kernels. Both against the twins."""
    O, v, logits, gout, scale = _outlook_inputs(cuda_device, dtype, 2, 28, 28, 192, 6, seed=5)
    buf = torch.empty(logits.numel() + 1, dtype=dtype, device=cuda_device)
    shifted = buf[1:].view(logits.shape).copy_(logits)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    out = O._launch_fwd(v, shifted, 6, scale)
    dv, dlogits = O._launch_bwd(v, shifted, gout, 6, scale)
    assert O.PLANS["fwd"]["rows"] == O.PLANS["bwd"]["rows"] == 1
    vbuf = torch.empty(v.numel() + 1, dtype=dtype, device=cuda_device)
    vshift = vbuf[1:].view(v.shape).copy_(v)
    out_general = O._launch_fwd(vshift, logits, 6, scale)
    assert O.PLANS["fwd"]["rows"] == 0
    torch.cuda.synchronize()
    ref = O.outlook_attention_fused_reference(v, logits, 6, scale)
    assert_close(out, ref, dtype)
    assert_close(out_general, ref, dtype)
    rdv, rdl = O.outlook_attention_backward_reference(v, logits, gout, 6, scale)
    assert_close(dv, rdv, dtype)
    assert_close(dlogits, rdl, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_outlook_general_kernels_match_twin_at_the_volo_map(cuda_device, dtype):
    """The general kernels, which the row kernels replaced on the main path,
    still hold the twins where they are forced."""
    O, v, logits, gout, scale = _outlook_inputs(cuda_device, dtype, 4, 28, 28, 192, 6, seed=6)
    out = O._launch_fwd(v, logits, 6, scale, general=True)
    dv, dlogits = O._launch_bwd(v, logits, gout, 6, scale, general=True)
    torch.cuda.synchronize()
    assert O.PLANS["fwd"]["rows"] == O.PLANS["bwd"]["rows"] == 0
    assert_close(out, O.outlook_attention_fused_reference(v, logits, 6, scale), dtype)
    rdv, rdl = O.outlook_attention_backward_reference(v, logits, gout, 6, scale)
    assert_close(dv, rdv, dtype)
    assert_close(dlogits, rdl, dtype)


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
    before, ran = V.LAUNCHES[name], V.RAN.copy()
    xr = x.clone().requires_grad_(True)
    out = V.mhsa_variant_with_shared_bwd(name)(xr, heads, scale)
    out.backward(dout)
    torch.cuda.synchronize()
    assert V.LAUNCHES[name] == before + 1
    assert_close(out, V.mhsa_fwd_variant_reference(name, x, heads, scale), torch.bfloat16)
    # every shape here is resident: the variant runs K1's walks in another
    # schedule (the kernel the library counted) and gives K1's bits at its
    # score type
    assert V.RAN - ran == {(name, V.expected_kernels(name, True)): 1}
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
    from autoprog_tpu_torch.scripts import attn_variants as V
    from autoprog_tpu_torch.scripts import bench_attn_x as X
    B = 4                                       # a multiple of every G
    x, dout = _qkv(cuda_device, B, n, heads, d, torch.bfloat16, seed=3)
    scale = d ** -0.5
    key = X.variant_name(order, G)
    before, ran = (X.LAUNCHES[key + "_fwd"], X.LAUNCHES[key + "_bwd"]), X.RAN.copy()
    xr = x.clone().requires_grad_(True)
    out = X.make_variant(order, G, heads, scale)(xr)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (X.LAUNCHES[key + "_fwd"], X.LAUNCHES[key + "_bwd"]) == (before[0] + 1,
                                                                    before[1] + 1)
    assert_close(out, X.group_reference(x, heads, scale), torch.bfloat16)
    assert_close(xr.grad, X.group_backward_reference(x, dout, heads, scale), torch.bfloat16)
    # every shape here is resident: K1's bits at f32 scores, forward and
    # backward (K1's backward computing its own row statistics, as S1's does)
    assert X.RAN - ran == {(key + side, V.expected_kernels(key + side, True)): 1
                           for side in ("_fwd", "_bwd")}
    assert torch.equal(out, A._launch_fwd(x, heads, scale, True))
    assert torch.equal(xr.grad, A._launch_bwd(x, dout, heads, scale, True))


@pytest.mark.parametrize("B,n,heads,d", [(128, 196, 12, 32), (8, 197, 6, 64)])
def test_phase_img4_runs_at_the_bench_shapes(cuda_device, B, n, heads, d):
    """The parked rows of four cells fit a block at both bench shapes (at
    head_dim 64 with one warp a block); at B = 128 each persistent block
    walks more than one item, through the ring's reused slots."""
    from autoprog_tpu_torch.scripts import bench_attn_x as X
    x, dout = _qkv(cuda_device, B, n, heads, d, torch.bfloat16, seed=4)
    scale = d ** -0.5
    assert torch.equal(X._launch_group_fwd("phase", 4, x, heads, scale),
                       A._launch_fwd(x, heads, scale, True))
    assert torch.equal(X._launch_group_bwd("phase", 4, x, dout, heads, scale),
                       A._launch_bwd(x, dout, heads, scale, True))


@pytest.mark.parametrize("G", [1, 2, 4])
def test_loop_order_at_the_bench_shape(cuda_device, G):
    """`loop` at [128, 196, 12, 32]: more items than resident blocks, so a
    block takes the next item from the second buffer; K1's bits at f32
    scores, forward and backward."""
    from autoprog_tpu_torch.scripts import bench_attn_x as X
    B, n, heads, d = 128, 196, 12, 32
    x, dout = _qkv(cuda_device, B, n, heads, d, torch.bfloat16, seed=9)
    scale = d ** -0.5
    assert torch.equal(X._launch_group_fwd("loop", G, x, heads, scale),
                       A._launch_fwd(x, heads, scale, True))
    assert torch.equal(X._launch_group_bwd("loop", G, x, dout, heads, scale),
                       A._launch_bwd(x, dout, heads, scale, True))


def test_variants_equal_loop_img1_where_the_shape_streams(cuda_device):
    """n = 257 is past the resident path: every variant runs the streaming
    cells, K1's path there, and those with f32 scores equal `loop_img1`, which
    is that path, bit for bit; twophase_bf16s stays within 2 ulp of its twin."""
    from autoprog_tpu_torch.scripts import attn_variants as V
    from autoprog_tpu_torch.scripts import bench_attn_x as X
    B, n, heads, d = 8, 257, 4, 32
    x, dout = _qkv(cuda_device, B, n, heads, d, torch.bfloat16, seed=6)
    scale = d ** -0.5
    ran = V.RAN + X.RAN
    first_f = X._launch_group_fwd("loop", 1, x, heads, scale)
    first_b = X._launch_group_bwd("loop", 1, x, dout, heads, scale)
    assert_close(first_f, A._launch_fwd(x, heads, scale, True), torch.bfloat16)
    for name in V._KERNELS:
        out = V.mhsa_fwd_variant(name, x, heads, scale)
        assert_close(out, V.mhsa_fwd_variant_reference(name, x, heads, scale), torch.bfloat16)
        if V.SCORES_F32[name]:
            assert torch.equal(out, first_f), name
    for order in ("phase", "loop"):
        for G in (1, 2, 4):
            assert torch.equal(X._launch_group_fwd(order, G, x, heads, scale), first_f)
            assert torch.equal(X._launch_group_bwd(order, G, x, dout, heads, scale), first_b)
    new = V.RAN + X.RAN - ran
    assert sum(new.values()) == len(V._KERNELS) + 2 + 2 * 6
    assert all(kernels == V.expected_kernels(key, False) for key, kernels in new), new


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


CARD_RUN = ["synthetic://", "--model", "volo_h2_l4", "--num-classes", "8", "--img-size", "64",
            "-b", "16", "--epochs", "1", "--warmup-epochs", "0", "--cooldown-epochs", "0",
            "--lr", "1e-3", "--workers", "0", "--fake-data-size", "32", "--token-label",
            "--token-label-data", "synthetic", "--model-ema", "--model-ema-decay", "0.9",
            "0.99"]


@pytest.fixture
def card_run(cuda_device, tmp_path, monkeypatch):
    """A one-epoch volo_h2_l4 run of the port's trainer on the card (bf16,
    K1 and K2 on): its run directory."""
    import glob
    from autoprog_tpu_torch.main import main
    monkeypatch.delenv("AUTOPROG_TORCH_DEVICE", raising=False)
    monkeypatch.delenv("AUTOPROG_FUSED_ATTN", raising=False)
    monkeypatch.delenv("AUTOPROG_FUSED_OUTLOOK", raising=False)
    main(CARD_RUN + ["--output", str(tmp_path)])
    return glob.glob(str(tmp_path / "train" / "*"))[0]


@pytest.mark.parametrize("ema", [None, 1])
def test_validate_equals_the_trainer_on_the_card(card_run, ema):
    """The validator's metrics on the trainer's checkpoint equal the
    trainer's eval row (the same eval_step, batches and order), and its
    forward went through K1 and K2."""
    import csv
    import os
    from autoprog_tpu_torch import validate
    from autoprog_tpu_torch.ops import outlook_fused as O
    with open(os.path.join(card_run, "summary.csv")) as f:
        row = list(csv.DictReader(f))[-1]
    before = (A.LAUNCHES["fwd"], O.LAUNCHES["fwd"])
    flags = [] if ema is None else ["--use-ema", "--ema-idx", str(ema)]
    got = validate.main(["synthetic://", "--checkpoint", os.path.join(card_run, "last.ckpt"),
                         "--num-classes", "8", "--img-size", "64", "-b", "16", "--workers", "0",
                         "--fake-data-size", "64"] + flags)[0]
    suffix = "" if ema is None else "_EMA_0.99"
    for key in ("top1", "top5", "loss"):
        assert got[key] == float(row[f"eval_{key}{suffix}"]), key
    # 4 batches x 2 transformer layers (K1) and 2 outlookers (K2)
    assert (A.LAUNCHES["fwd"] - before[0], O.LAUNCHES["fwd"] - before[1]) == (8, 8)


def test_resume_restores_the_state_bit_for_bit_on_the_card(card_run):
    import os
    from autoprog_tpu_torch import engine
    from autoprog_tpu_torch.config import parse_args
    from autoprog_tpu_torch.train.checkpoint import load_checkpoint_file
    ckpt = load_checkpoint_file(os.path.join(card_run, "last.ckpt"))
    args, text = parse_args(CARD_RUN, prog=False)
    args.token_label_size = 4
    ctx = engine.setup(args, text)
    assert engine.resume_from(ctx, ckpt) == 1
    state = ctx.state
    assert state.step == ckpt["step"] == 2
    for n, p in state.params.items():
        assert p.is_cuda and torch.equal(p.detach().cpu(), ckpt["state_dict"][n]), n
        for i in range(2):
            assert torch.equal(state.ema_params[i][n].cpu(), ckpt[f"state_dict_ema_{i}"][n])
    saved = ckpt["optimizer"]["state"]
    got = state.optimizer.state_dict()["state"]
    assert set(got) == set(saved)
    for i in saved:
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(got[i][key].cpu(), saved[i][key]), (i, key)
        assert float(got[i]["step"]) == float(saved[i]["step"]) == 2.0


# ------------------------------------------- the train step's options on the card


@pytest.mark.parametrize("n", [14, 8])
def test_sparse_target_on_the_card_matches_the_cpu(cuda_device, n):
    """The sparse token-label target on the card against the plain CPU
    result: the cls row is a scatter-add of floats whose order CUDA's
    atomics leave open, so within f32 rounding (1e-6 relative)."""
    from autoprog_tpu_torch.data.token_label import sparse_token_label_target
    g = torch.Generator().manual_seed(n)
    scores = torch.rand(8, 5, 14, 14, generator=g)
    inds = torch.randint(0, 20, (8, 5, 14, 14), generator=g, dtype=torch.int32)
    labels = torch.randint(0, 20, (8,), generator=g)
    kw = dict(num_classes=20, smoothing=0.1, label_size=n)
    want = sparse_token_label_target(labels, scores, inds, **kw)
    got = sparse_token_label_target(labels.cuda(), scores.cuda(), inds.cuda(), **kw)
    assert torch.equal(got["inds"].cpu(), want["inds"])
    for key in ("gt", "cls", "vals", "u"):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-6, atol=1e-7)


def test_sr_cast_on_the_card_is_the_cpu_s_bit_for_bit(cuda_device):
    from autoprog_tpu_torch.ops.rounding import cast_bf16_sr, sr_bf16_with_dither
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1 << 16, generator=g) * torch.exp(torch.empty(1 << 16).uniform_(
        -20, 20, generator=g))
    x[:4] = torch.tensor([float("inf"), float("-inf"), float("nan"), 1.9999999])
    dither = torch.randint(0, 1 << 16, x.shape, generator=g, dtype=torch.int32)
    want = sr_bf16_with_dither(x, dither)
    got = sr_bf16_with_dither(x.cuda(), dither.cuda())
    assert torch.equal(got.view(torch.int16).cpu(), want.view(torch.int16))
    gen = torch.Generator(cuda_device).manual_seed(1)
    a, b = cast_bf16_sr([x.cuda(), x[:100].cuda()], gen)
    assert a.is_cuda and torch.equal(a[:100].view(torch.int16), b.view(torch.int16))


def test_uint8_normalise_and_erase_on_the_card_match_the_cpu(cuda_device):
    """normalize_uint8 exactly, and the erase applied to the same draws
    exactly; the draws themselves come from the card's generator without a
    host sync (one box an image at prob 1)."""
    from autoprog_tpu_torch.ops.erase import apply_erase, erase_draws, normalize_uint8
    g = torch.Generator().manual_seed(0)
    img = torch.randint(0, 256, (16, 24, 20, 3), generator=g, dtype=torch.uint8)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    x = normalize_uint8(img, mean, std, torch.float32)
    assert torch.equal(normalize_uint8(img.cuda(), mean, std, torch.float32).cpu(), x)
    draws = erase_draws(torch.Generator(cuda_device).manual_seed(0), x.shape, prob=1.0,
                        count=2)
    got = apply_erase(x.cuda(), draws)
    want = apply_erase(x, [tuple(t.cpu() for t in d) for d in draws])
    assert torch.equal(got.cpu(), want)
    assert bool(((got != x.cuda()).flatten(1).any(1)).all())


@pytest.mark.parametrize("mode", ["full", "dots"])
def test_remat_on_the_card_matches_the_plain_step(cuda_device, mode):
    """volo_h2_l4 (bf16, K1 and K2 on, drop-path 0.2): the loss and every
    gradient with the blocks recomputed against the plain backward within
    2 ulp of bf16; the recompute launches K1's and K2's forwards again."""
    from autoprog_tpu_torch import create_model
    from autoprog_tpu_torch.ops import outlook_fused as O
    torch.manual_seed(0)
    base = create_model("volo_h2_l4").make(num_classes=8, img_size=64).state_dict()
    x = torch.randn(8, 64, 64, 3, device=cuda_device)
    out = {}
    for m in ("", mode):
        model = create_model("volo_h2_l4").make(num_classes=8, img_size=64,
                                                drop_path_rate=0.2, remat=m).to(cuda_device)
        model.load_state_dict(base)
        gen = torch.Generator(cuda_device).manual_seed(3)
        before = (A.LAUNCHES["fwd"], O.LAUNCHES["fwd"])
        x_cls, x_aux, _ = model(x, train=True, drop_gen=gen,
                                bbox=torch.tensor([1, 1, 3, 3], dtype=torch.int32))
        loss = x_cls.float().logsumexp(-1).mean() + x_aux.float().square().mean()
        loss.backward()
        torch.cuda.synchronize()
        out[m] = (loss.detach(), {n: p.grad for n, p in model.named_parameters()},
                  (A.LAUNCHES["fwd"] - before[0], O.LAUNCHES["fwd"] - before[1]))
    assert out[""][2] == (2, 2) and out[mode][2] == (4, 4)
    assert_close(out[mode][0], out[""][0], torch.bfloat16)
    for n, g in out[""][1].items():
        assert_close(out[mode][1][n], g, torch.bfloat16)


# ------------------------------------------ tensor parallelism: local heads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,n,heads,d", [
    (8, 196, 6, 32),       # volo_d1 at M = 2: 6 of 12 heads
    (64, 196, 6, 32),      # the same at phase 12's batch
    (4, 196, 8, 48),       # volo_d4 at M = 2: 8 of 16 heads, head_dim 48
    (4, 197, 3, 64),       # deit_small at M = 2
])
def test_k1_on_a_tensor_parallel_rank_s_heads(cuda_device, dtype, B, n, heads, d):
    """K1 on the qkv a rank of `--model-parallel 2` holds ([B, n, 3 C / 2]
    in (3, heads / 2, head_dim) order) against its twin, counted by shape
    and heads."""
    g = torch.Generator(cuda_device).manual_seed(2)
    x = torch.randn(B, n, 3 * heads * d, device=cuda_device, generator=g).to(dtype)
    dout = torch.randn(B, n, heads * d, device=cuda_device, generator=g).to(dtype)
    scale = d ** -0.5
    before = dict(A.SHAPE_LAUNCHES)
    x.requires_grad_(True)
    out = A.mhsa_fused_qkv(x, heads, scale)
    out.backward(dout)
    torch.cuda.synchronize()
    for side in ("fwd", "bwd"):
        key = (side, n, heads, d)
        assert A.SHAPE_LAUNCHES[key] == before.get(key, 0) + 1
    assert_close(out, A.mhsa_fused_qkv_reference(x.detach(), heads, scale), dtype)
    assert_close(x.grad, A.mhsa_fused_qkv_backward_reference(x.detach(), dout, heads, scale),
                 dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,heads", [
    (8, 28, 28, 96, 3),      # volo_d1's outlookers at M = 2: 3 of 6 heads
    (64, 28, 28, 96, 3),     # the same at phase 12's batch
    (4, 28, 28, 192, 6),     # volo_d4's at M = 2: 6 of 12 heads
])
def test_k2_row_kernels_on_a_tensor_parallel_rank_s_heads(cuda_device, dtype, B, H, W, C,
                                                          heads):
    """K2 on a rank's v [B, H, W, C / 2] and logits [B, H/2, W/2, heads / 2 x
    81]: its row kernels plan a head group that divides the local heads, and
    the result is the twin's."""
    O, v, logits, gout, scale = _outlook_inputs(cuda_device, dtype, B, H, W, C, heads)
    before = dict(O.LAUNCHES)
    v.requires_grad_(True)
    logits.requires_grad_(True)
    out = O.outlook_attention_fused(v, logits, heads, scale)
    out.backward(gout)
    torch.cuda.synchronize()
    for side in ("fwd", "bwd"):
        plan = O.PLANS[side]
        assert plan["rows"] == 1 and plan["heads"] == heads, plan
        assert heads % plan["heads_per_block"] == 0, plan
        assert O.LAUNCHES[side] == before[side] + 1
    vd, ld = v.detach(), logits.detach()
    assert_close(out, O.outlook_attention_fused_reference(vd, ld, heads, scale), dtype)
    dv, dlogits = O.outlook_attention_backward_reference(vd, ld, gout, heads, scale)
    assert_close(v.grad, dv, dtype)
    assert_close(logits.grad, dlogits, dtype)
