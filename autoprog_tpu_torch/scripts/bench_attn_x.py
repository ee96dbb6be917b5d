"""G-images-per-block variants of the fused MHSA against K1, counterpart of
the JAX package's `scripts/bench_attn_x.py` (`make_variant` and its table).

    python -m autoprog_tpu_torch.scripts.bench_attn_x [B]

The variants ask, without changing the math, how much independent work a
block should carry and in which order: a work item is G cells of one head
(images b .. b + G - 1), in two orders:

  loop   one image after the other, K1's body each time, the next image's
         tiles in flight in a second buffer;
  phase  the q k^T of all G cells with the scores parked in shared memory,
         then all softmaxes, then all T(e) . V; the backward computes the row
         statistics of all G cells first, then dS, dQ, dK and dV of each.

`make_variant(order, G, heads, scale)` returns an attention function on the
raw qkv projection [B, n, 3C] -> [B, n, C] with its own backward; the kernels
are in `csrc/mhsa_variants.cu` (bf16, f32 scores). At the resident shapes
(n <= 256, head_dim <= 64) they are built from K1's resident walks and equal
K1 at f32 scores bit for bit, forward and backward, as the JAX script's
variants equal its shipped kernel; above them they run K1's streaming cells
in 64-row tiles (`loop` with G = 1 is that path exactly, and every variant
equals it bit for bit). In the JAX script both orders share the
phase-ordered backward; here the order applies to the backward as well. A G
whose parked rows do not fit a block's shared memory is refused with
ValueError, not shrunk.

The table: K1 at its default score type and at f32 scores, then
`phase_img{1,2,4}` and `loop_img{2,4}`, forward and forward + backward
(CUDA events after a warm-up), and each variant's largest difference from K1
at f32 scores and whether it is bit for bit. Without a CUDA device the script
raises unless AUTOPROG_TORCH_DEVICE=cpu, where it runs the plain twins at
B = 4.
"""

from __future__ import annotations

import collections
import sys
from typing import Callable, Dict, List, Optional

import torch

from autoprog_tpu_torch.ops import attention as A
from autoprog_tpu_torch.platform import default_device
from autoprog_tpu_torch.scripts.attn_variants import check_bf16_qkv, kernel_launches, launched
from autoprog_tpu_torch.scripts.timing import card_name, time_call

ORDERS = ("phase", "loop")
#: kernel launches per "<order>_img<G>_fwd" / "..._bwd" (twins are not counted)
LAUNCHES: "collections.Counter[str]" = collections.Counter()
#: the same per ("<order>_img<G>_fwd" / "..._bwd", the kernels the call
#: launched), as `attn_variants.RAN`
RAN: "collections.Counter[tuple]" = collections.Counter()


def variant_name(order: str, G: int) -> str:
    return f"{order}_img{G}"


def group_reference(qkv: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """Plain twin of every (order, G) forward: K1's twin with f32 scores."""
    return A.mhsa_fused_qkv_reference(qkv, heads, scale, True)


def group_backward_reference(qkv: torch.Tensor, dout: torch.Tensor, heads: int,
                             scale: float) -> torch.Tensor:
    """Plain twin of every (order, G) backward."""
    return A.mhsa_fused_qkv_backward_reference(qkv, dout, heads, scale, True)


def _check(order: str, G: int, qkv: torch.Tensor, heads: int) -> None:
    if order not in ORDERS:
        raise ValueError(f"order {order!r}: one of {ORDERS}")
    if G < 1 or qkv.shape[0] % G:
        raise ValueError(f"batch {qkv.shape[0]} is not a multiple of G={G}")
    if qkv.device.type == "cuda":
        check_bf16_qkv(variant_name(order, G), qkv, heads)


def _launch_group_fwd(order: str, G: int, qkv: torch.Tensor, heads: int,
                      scale: float) -> torch.Tensor:
    from autoprog_tpu_torch import _build
    _check(order, G, qkv, heads)
    B, n, C3 = qkv.shape
    out = torch.empty(B, n, C3 // 3, dtype=qkv.dtype, device=qkv.device)
    lib = _build.load()
    before = kernel_launches(lib)
    with torch.cuda.device(qkv.device):
        rc = lib.mhsa_group_fwd(
            qkv.data_ptr(), out.data_ptr(), B, n, C3 // 3, heads, float(scale), G,
            int(order == "phase"), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"mhsa_group_fwd({variant_name(order, G)})")
    LAUNCHES[variant_name(order, G) + "_fwd"] += 1
    RAN[variant_name(order, G) + "_fwd", launched(lib, before)] += 1
    return out


def _launch_group_bwd(order: str, G: int, qkv: torch.Tensor, dout: torch.Tensor,
                      heads: int, scale: float) -> torch.Tensor:
    from autoprog_tpu_torch import _build
    _check(order, G, qkv, heads)
    B, n, C3 = qkv.shape
    dout = dout.contiguous()
    if dout.dtype != qkv.dtype or dout.device != qkv.device or \
            tuple(dout.shape) != (B, n, C3 // 3):
        raise ValueError(f"{variant_name(order, G)} backward: dout {tuple(dout.shape)} "
                         f"{dout.dtype} does not match qkv {tuple(qkv.shape)} {qkv.dtype}")
    dqkv = torch.empty_like(qkv)
    lib = _build.load()
    before = kernel_launches(lib)
    with torch.cuda.device(qkv.device):
        # the streaming kernels' two passes share row statistics through it
        stats = A._scratch(lib, qkv, B, heads, n, C3 // 3 // heads)
        rc = lib.mhsa_group_bwd(
            qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
            None if stats is None else stats.data_ptr(), B, n, C3 // 3, heads, float(scale), G,
            int(order == "phase"), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"mhsa_group_bwd({variant_name(order, G)})")
    LAUNCHES[variant_name(order, G) + "_bwd"] += 1
    RAN[variant_name(order, G) + "_bwd", launched(lib, before)] += 1
    return dqkv


def make_variant(order: str, G: int, heads: int, scale: float) -> Callable:
    """A qkv attention [B, n, 3C] -> [B, n, C] that runs `G` images per block
    in `order`, with its own backward. On CPU tensors it runs the twins."""
    if order not in ORDERS:
        raise ValueError(f"order {order!r}: one of {ORDERS}")

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, qkv):
            ctx.save_for_backward(qkv)
            if A._on(qkv) == "cpu":
                _check(order, G, qkv, heads)
                return group_reference(qkv, heads, scale)
            return _launch_group_fwd(order, G, qkv, heads, scale)

        @staticmethod
        def backward(ctx, dout):
            (qkv,) = ctx.saved_tensors
            if A._on(qkv) == "cpu":
                return group_backward_reference(qkv, dout, heads, scale)
            return _launch_group_bwd(order, G, qkv, dout, heads, scale)

    return Fn.apply


def table_variants(B: int, heads: int, scale: float) -> Dict[str, Callable]:
    """The rows of the table: base, phase_img{1,2,4}, loop_img{2,4}."""
    variants: Dict[str, Callable] = {
        "base (mhsa_fused_qkv)": lambda x: A.mhsa_fused_qkv(x, heads, scale),
        "base, f32 scores": lambda x: A.mhsa_fused_qkv(x, heads, scale, True),
    }
    for G in (1, 2, 4):
        if B % G:
            continue
        variants[variant_name("phase", G)] = make_variant("phase", G, heads, scale)
        if G > 1:
            variants[variant_name("loop", G)] = make_variant("loop", G, heads, scale)
    return variants


def main(argv: Optional[List[str]] = None) -> List[dict]:
    argv = sys.argv[1:] if argv is None else argv
    device = default_device()
    on_card = device.type == "cuda"
    B = int(argv[0]) if argv else (128 if on_card else 4)
    n, heads, d = 196, 12, 32
    C = heads * d
    iters, warmup = (30, 3) if on_card else (1, 0)
    scale = d ** -0.5
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(B, n, 3 * C, generator=gen).to(device, torch.bfloat16)
    dout = torch.randn(B, n, C, generator=gen).to(device, torch.bfloat16)
    leaf = qkv.clone().requires_grad_(True)

    def fwd_bwd(fn):
        return torch.autograd.grad(fn(leaf), leaf, dout)[0]

    variants = table_variants(B, heads, scale)
    ref_f = variants["base, f32 scores"](qkv)
    ref_g = fwd_bwd(variants["base, f32 scores"])
    print(f"B={B} n={n} heads={heads} d={d} bf16 ({iters} iters) on {card_name(device)}",
          flush=True)
    rows = []
    for name, fn in variants.items():
        with torch.no_grad():
            out = fn(qkv)
            t_f = time_call(lambda: fn(qkv), iters, warmup, device)
        grad = fwd_bwd(fn)
        t_b = time_call(lambda: fwd_bwd(fn), iters, warmup, device)
        row = {"name": name, "fwd_ms": t_f, "fwd_bwd_ms": t_b,
               "fwd_diff": (out.float() - ref_f.float()).abs().max().item(),
               "bwd_diff": (grad.float() - ref_g.float()).abs().max().item(),
               "fwd_equal": bool(torch.equal(out, ref_f)),
               "bwd_equal": bool(torch.equal(grad, ref_g))}
        rows.append(row)
        print(f"{name:<24s} fwd {t_f:7.3f} ms   fwd+bwd {t_b:7.3f} ms   vs base at f32 "
              f"scores: fwd max diff {row['fwd_diff']:.3e} (equal={row['fwd_equal']}) "
              f"bwd max diff {row['bwd_diff']:.3e} (equal={row['bwd_equal']})", flush=True)
    return rows


if __name__ == "__main__":
    main()
