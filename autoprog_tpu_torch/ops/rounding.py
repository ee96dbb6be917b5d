"""Stochastic rounding f32 -> bf16 for low-precision EMA state, counterpart
of `autoprog_tpu/ops/rounding.py` (`--model-ema-bf16`).

A bf16 EMA tree halves the EMA sweeps' memory traffic, but a round-to-
nearest store freezes it: at decay d ~ 0.9999 the per-step increment
(1 - d) * (p - e) is far below bf16's relative ulp of 2^-8. Stochastic
rounding keeps the store unbiased (E[sr(x)] = x), so the EMA still tracks
its target.

The dither: one sweep of uniform 16-bit integers per (tree, step), the size
of the tree's largest leaf; every leaf reads a prefix of it, as in the JAX
module. The rounding noise is correlated across the leaves of one step and
unbiased per element, which is all SR needs. torch has no uint32 random, so
the dither is int32 in [0, 2^16) and the bit arithmetic runs on the f32
bits viewed as int32, where addition carries out of the mantissa into the
exponent exactly as JAX's uint32 addition does.

Under tensor parallelism a rank holds shards of the tree's leaves. The
sweep is then drawn at the largest FULL leaf's size (the same draw on every
rank of a model group), each sharded leaf views its prefix at the full
shape and takes its rank's shard of it by `parallel/tp.py`'s indexing, so
that every element reads the dither bits it reads in one process and the
gathered rounding is the one-process rounding bit for bit; the JAX package
gets the same by slicing the sweep at the full shapes before GSPMD shards
the result. The caller passes the specs and its shard index: this module
holds no process-group state.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from autoprog_tpu_torch.parallel.tp import Spec, shard


def _truncate_into(out: Sequence[torch.Tensor], bits: Sequence[torch.Tensor]) -> None:
    """Each bf16 `out` <- the high 16 bits of the int32 `bits` (the f32 it
    holds, truncated): JAX's mask with 0xFFFF0000 and exact cast, and a NaN
    keeps JAX's bits, which a float cast may not. The high half of a
    little-endian int32 is its second int16. One foreach copy for all."""
    torch._foreach_copy_([o.view(-1).view(torch.int16) for o in out],
                         [b.view(-1).view(torch.int16)[1::2] for b in bits])


def sr_bf16_with_dither(x32: torch.Tensor, dither16: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16, rounding up with probability equal to the truncated
    fraction: add the 16-bit dither below the bf16 mantissa, truncate. A
    carry out of the mantissa goes into the exponent; NaN and inf pass
    through."""
    out = torch.empty(x32.shape, dtype=torch.bfloat16, device=x32.device)
    _truncate_into([out], [x32.contiguous().view(torch.int32) + dither16])
    return out


def _full_shape(shape, spec: Spec, count: int) -> torch.Size:
    """The shape of the full tensor whose shard has `shape`."""
    if spec is None:
        return torch.Size(shape)
    full = list(shape)
    full[spec[0]] *= count
    return torch.Size(full)


def cast_bf16_sr(tensors: Sequence[torch.Tensor], generator: torch.Generator,
                 out: Optional[Sequence[torch.Tensor]] = None, *,
                 specs: Optional[Sequence[Spec]] = None, m: int = 0,
                 count: int = 1) -> List[torch.Tensor]:
    """Every f32 tensor rounded stochastically to bf16 (into `out` where
    given: contiguous bf16 tensors of the same shapes), from one dither sweep
    drawn from `generator` (on the tensors' device). Where `specs` is given
    (`tp.param_spec` of each tensor, None for a whole one), each tensor is
    shard `m` of `count` of its full tensor and reads that full tensor's
    dither at its own elements (see the module docstring). A fixed number of
    foreach calls, plus one indexing copy per sharded tensor."""
    if specs is None or count == 1:
        specs = [None] * len(tensors)
    full = [_full_shape(t.shape, sp, count) for t, sp in zip(tensors, specs)]
    n = max(f.numel() for f in full)
    sweep = torch.randint(0, 1 << 16, (n,), dtype=torch.int32, generator=generator,
                          device=generator.device)
    dither = [shard(sweep[:f.numel()].view(f), sp, m, count) for f, sp in zip(full, specs)]
    bits = torch._foreach_add([t.contiguous().view(torch.int32) for t in tensors], dither)
    if out is None:
        out = [torch.empty(t.shape, dtype=torch.bfloat16, device=t.device) for t in tensors]
    _truncate_into(out, bits)
    return list(out)
