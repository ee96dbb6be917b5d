"""Microbench: MHSA formulations at the volo_d1 transformer shape,
counterpart of the JAX package's `scripts/bench_attn.py`.

    python -m autoprog_tpu_torch.scripts.bench_attn [B]

[B, n=196 tokens, C=384, 12 heads, head_dim 32], bf16: the shape of all 14
transformer layers. Two tables, forward and forward + backward, timed with
CUDA events after a warm-up:

  on separate q, k, v [B, n, heads, d]:
    * the unfused path of `models/layers.py` with f32 logits in device memory;
    * the same with the logits stored at bf16 (its N >= 128 branch);
    * K5, `mhsa_fused`.
  on the raw qkv projection [B, n, 3C] -> [B, n, C], the cost the model pays:
    * unfused, bf16 logits, behind the head split;
    * K5 behind the split. The JAX kernel paid two relayouts at this
      boundary; K5 reads the three views of the [B, n, 3, heads, d] buffer in
      place, so the split costs nothing here;
    * K1, `mhsa_fused_qkv`;
    * each schedule variant of `scripts/attn_variants.py`, with K1's backward.

The JAX script also times the TPU flash-attention kernel of
`jax.experimental.pallas.ops.tpu`; it has no counterpart in this repository
and the row is dropped. Without a CUDA device the script raises unless
AUTOPROG_TORCH_DEVICE=cpu, where it runs the plain twins at B = 4.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, List, Optional

import torch

from autoprog_tpu_torch.ops.attention import mhsa_fused, mhsa_fused_qkv
from autoprog_tpu_torch.platform import default_device
from autoprog_tpu_torch.scripts.attn_variants import _KERNELS, mhsa_variant_with_shared_bwd
from autoprog_tpu_torch.scripts.timing import card_name, time_call


def attn_unfused_f32(q, k, v, scale: float):
    """f32 logits materialised in device memory, softmax in f32."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    p = torch.softmax(s * scale, dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", p.float(), v.float()).to(q.dtype)


def attn_unfused_bf16(q, k, v, scale: float):
    """Logits stored in the working type, exp and sum in f32."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    s = (s * scale).to(q.dtype)
    s = s - s.amax(-1, keepdim=True)
    e = torch.exp(s.float())
    p = (e / e.sum(-1, keepdim=True)).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", p.float(), v.float()).to(q.dtype)


def split_qkv(qkv: torch.Tensor, heads: int):
    """[B, n, 3C] -> q, k, v as [B, n, heads, d] views (no copy)."""
    B, n, C3 = qkv.shape
    return qkv.view(B, n, 3, heads, C3 // 3 // heads).unbind(2)


def qkv_table(heads: int, scale: float) -> Dict[str, Callable]:
    def merged(attn):
        def fn(qkv):
            B, n, C3 = qkv.shape
            return attn(*split_qkv(qkv, heads), scale).reshape(B, n, C3 // 3)
        return fn

    table = {
        "qkv: unfused bf16 logits": merged(attn_unfused_bf16),
        "qkv: mhsa_fused (boundary)": merged(mhsa_fused),
        "qkv: mhsa_fused_qkv": lambda qkv: mhsa_fused_qkv(qkv, heads, scale),
    }
    for vname in _KERNELS:
        vfn = mhsa_variant_with_shared_bwd(vname)
        table[f"qkv: variant {vname}"] = lambda x, f=vfn: f(x, heads, scale)
    return table


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

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(device, torch.bfloat16)

    rows: List[dict] = []

    def run(name: str, fn: Callable, inputs, dout):
        leaves = [x.clone().requires_grad_(True) for x in inputs]
        with torch.no_grad():
            t_f = time_call(lambda: fn(*inputs), iters, warmup, device)
        t_b = time_call(lambda: torch.autograd.grad(fn(*leaves), leaves, dout), iters,
                        warmup, device)
        rows.append({"name": name, "fwd_ms": t_f, "fwd_bwd_ms": t_b})
        print(f"{name:<30s} fwd {t_f:7.3f} ms   fwd+bwd {t_b:7.3f} ms", flush=True)

    print(f"B={B} n={n} heads={heads} d={d} bf16 ({iters} iters) on {card_name(device)}",
          flush=True)
    q, k, v, dout4 = rand(B, n, heads, d), rand(B, n, heads, d), rand(B, n, heads, d), \
        rand(B, n, heads, d)
    for name, fn in (("unfused f32 logits", attn_unfused_f32),
                     ("unfused bf16 logits", attn_unfused_bf16),
                     ("mhsa_fused", mhsa_fused)):
        run(name, lambda a, b, c, f=fn: f(a, b, c, scale), (q, k, v), dout4)

    # qkv-level comparison: the input is the raw fused-qkv Dense output
    # [B, n, 3C], the output the [B, n, C] the out-projection consumes
    qkv, dout3 = rand(B, n, 3 * C), rand(B, n, C)
    for name, fn in qkv_table(heads, scale).items():
        run(name, fn, (qkv,), dout3)
    return rows


if __name__ == "__main__":
    main()
