"""VOLO layer library, counterpart of `autoprog_tpu/models/layers.py`.

Parameter names follow the Flax modules (`convert.py` maps a Flax tree onto
them): Dense -> `weight` [out, in] + `bias`; Conv -> `weight` OIHW;
LayerNorm and BatchNorm `scale` -> `weight`; BatchNorm `mean`/`var` ->
`running_mean`/`running_var` buffers.

Dtype policy (Flax `nn.Dense(dtype=..., param_dtype=float32)`): parameters
are f32 and every layer casts its input and its weights to the compute
dtype; softmax and LayerNorm statistics are f32. There is no autocast.

Departures from the original PyTorch VOLO that the JAX package made, and
this port keeps because the JAX package is the reference:
  * GELU is the tanh approximation (`nn.gelu` default), not the exact one;
  * LayerNorm eps is 1e-6 (Flax), not torch's 1e-5;
  * BatchNorm in train mode normalises with the BIASED batch variance
    (E[x^2] - E[x]^2 in f32) and updates its running stats as
    ra = 0.9 * ra + 0.1 * batch with that biased variance, where
    `torch.nn.BatchNorm2d` would feed the unbiased one. Under a process
    group of more than one rank the statistics are the global batch's, as
    the JAX package's sharded batch gives them ("sync-BN by construction"):
    one all-reduce of (sum x, sum x^2, count) per call, differentiable
    (`parallel/mesh.py:sum_over_ranks`), so every rank's running stats agree;
  * the pos-embed bicubic uses Keys a = -0.5 (ops/interpolate.py).

Randomness: DropPath and dropout take an explicit `torch.Generator` (`gen`)
and follow Flax: keep mask ~ Bernoulli(1 - rate), x / keep where kept.

`remat_call` runs an outlooker or transformer block under
`torch.utils.checkpoint` for `--remat full | dots`.

Tensor parallelism (`model_parallel` M > 1, `parallel/tp.py`): `Mlp`,
`Attention`, `OutlookAttention` and `ClassAttention` hold this rank's shard of
their column-parallel layers (output features / M; `qkv` and `kv` by heads)
and of their row-parallel `proj` / `fc2` (input features / M), and
`heads / M` heads. The input goes through `tp.copy_to_model` and the output
through `tp.row_parallel`; K1 and K2 run on the local heads.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from autoprog_tpu_torch.ops.layernorm import layer_norm
from autoprog_tpu_torch.ops.outlook import outlook_attention
from autoprog_tpu_torch.parallel import mesh, tp
from autoprog_tpu_torch.ops.unfold import avg_pool_ceil

_TRUNC = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def trunc_init_(t: torch.Tensor, stddev: float = 0.02) -> torch.Tensor:
    """Flax `truncated_normal(stddev)`: N(0, s) truncated to +-2s with
    s = stddev / 0.8796 (so the truncated std is `stddev`)."""
    s = stddev / _TRUNC
    return nn.init.trunc_normal_(t, 0.0, s, -2.0 * s, 2.0 * s)


def lecun_init_(t: torch.Tensor, fan_in: int) -> torch.Tensor:
    """Flax's default kernel init (lecun_normal, truncated)."""
    return trunc_init_(t, math.sqrt(1.0 / fan_in))


def _use_fused_attn(n_lead: int, attn_drop: float, n_tokens: int,
                    head_dim: int, device: torch.device) -> bool:
    """Route MHSA through the K1 kernel (ops/attention.py), as
    `autoprog_tpu/models/layers.py:_use_fused_attn` does: AUTOPROG_FUSED_ATTN
    (default 1), no attention dropout, one leading dim, n <= 1024,
    head_dim <= 128, and not on the CPU."""
    if os.environ.get("AUTOPROG_FUSED_ATTN", "1") != "1":
        return False
    if attn_drop or n_lead != 1:
        return False
    if n_tokens > 1024 or head_dim > 128:
        return False
    return device.type != "cpu"


def dropout(x: torch.Tensor, rate: float, train: bool,
            gen: Optional[torch.Generator], shape=None,
            shard_dim: Optional[int] = None) -> torch.Tensor:
    """Flax dropout: keep ~ Bernoulli(1 - rate); where(keep, x / keep, 0).
    `shape` broadcasts one draw (DropPath draws one per sample).

    `shard_dim`: `x` is this rank's block, along that axis, of a tensor split
    contiguously over the model group. The mask is drawn at the full shape,
    as one process draws it, and this rank's block of it kept: `gen` is the
    same on every rank of the group, so a mask of the shard's shape would
    drop the same units on every rank."""
    if rate == 0.0 or not train:
        return x
    keep = 1.0 - rate
    shape = list(shape or x.shape)
    if shard_dim is not None:
        n = shape[shard_dim]
        shape[shard_dim] = n * mesh.model_count()
    mask = torch.empty(shape, device=x.device).bernoulli_(keep, generator=gen).bool()
    if shard_dim is not None:
        mask = mask.narrow(shard_dim, mesh.model_index() * n, n)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def drop_path(x: torch.Tensor, rate: float, train: bool,
              gen: Optional[torch.Generator]) -> torch.Tensor:
    """Per-sample stochastic depth on a residual branch."""
    return dropout(x, rate, train, gen, (x.shape[0],) + (1,) * (x.ndim - 1))


def _save_linear_outputs(ctx, op, *args, **kwargs):
    """`--remat dots`: keep the outputs of the matmuls without batch dims
    (the linear layers' aten.mm / aten.addmm) and recompute the rest, the
    policy of JAX's `dots_with_no_batch_dims_saveable`."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(block: nn.Module, x: torch.Tensor, train: bool,
               gen: Optional[torch.Generator], mode) -> torch.Tensor:
    """`block(x, train, gen)`, rematerialised in the backward as
    `autoprog_tpu/models/layers.py:remat_wrap` does: mode "" runs it plainly,
    "full" (or True) keeps only the block's input, "dots" also keeps the
    linear layers' outputs. Only where autograd records the call.

    `torch.utils.checkpoint` restores the default generators for the
    recompute, not `gen`, from which DropPath and dropout draw: the
    recompute sets `gen` back to its state at the forward call, so that it
    draws the same masks, and then puts it back where it was, so that the
    next step's draws are not repeated."""
    if not mode or not torch.is_grad_enabled():
        return block(x, train, gen)
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts
    if mode == "dots":
        kw = {"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                              _save_linear_outputs)}
    elif mode in (True, "full"):
        kw = {}
    else:
        raise ValueError(f"unknown remat mode {mode!r}")
    at_call = None if gen is None else gen.get_state()
    forwards = []

    def run(inp):
        if not forwards or at_call is None:
            forwards.append(True)
            return block(inp, train, gen)
        now = gen.get_state()
        gen.set_state(at_call)
        try:
            return block(inp, train, gen)
        finally:
            gen.set_state(now)
    return checkpoint(run, x, use_reentrant=False, **kw)


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(trunc_init_(torch.empty(out_features, in_features)))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class Conv(nn.Module):
    """Flax nn.Conv on NCHW tensors (the stem keeps NCHW inside)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 padding: int, bias: bool, dtype: torch.dtype):
        super().__init__()
        self.dtype, self.stride, self.padding = dtype, stride, padding
        self.weight = nn.Parameter(lecun_init_(
            torch.empty(out_ch, in_ch, kernel, kernel), in_ch * kernel * kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x):
        dt = self.dtype
        return F.conv2d(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt),
                        self.stride, self.padding)


class LayerNorm(nn.Module):
    """Flax nn.LayerNorm(dtype): f32 statistics, eps 1e-6, output in dtype
    (`ops/layernorm.py`: the CUDA kernel pair on the card, the plain twin
    elsewhere)."""

    def __init__(self, dim: int, dtype: torch.dtype, eps: float = 1e-6):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps, self.dtype)


class BatchNorm(nn.Module):
    """Flax nn.BatchNorm over NCHW channels (see the module docstring for
    the biased-variance running update). `momentum` is Flax's:
    ra = momentum * ra + (1 - momentum) * batch."""

    def __init__(self, num_features: int, dtype: torch.dtype,
                 momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.dtype, self.momentum, self.eps = dtype, momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x, train: bool):
        xf = x.float()
        if train and mesh.data_count() > 1:
            mean, var = self._global_stats(xf)
        elif train:
            mean = xf.mean((0, 2, 3))
            var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
        if train:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.dtype)

    @staticmethod
    def _global_stats(xf):
        """Mean and biased variance over the data group's batch: one
        all-reduce of (sum x, sum x^2, count)."""
        c = xf.shape[1]
        count = xf.new_full((1,), xf.numel() // c)
        sums = mesh.sum_over_ranks(torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                                              count]))
        mean = sums[:c] / sums[2 * c]
        return mean, (sums[c:2 * c] / sums[2 * c] - mean * mean).clamp_min(0.0)


def _local(n: int, model_parallel: int, what: str) -> int:
    """n / model_parallel, where it divides."""
    if n % model_parallel:
        raise ValueError(f"{what} {n} is not divisible by model_parallel={model_parallel}")
    return n // model_parallel


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: Optional[int] = None,
                 drop: float = 0.0, dtype: torch.dtype = torch.bfloat16,
                 model_parallel: int = 1):
        super().__init__()
        self.drop, self.tp = drop, model_parallel > 1
        hidden = _local(hidden, model_parallel, "hidden width")
        self.fc1 = Dense(dim, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, out or dim, dtype=dtype)

    def forward(self, x, train: bool = False, gen=None):
        if self.tp:
            x = tp.copy_to_model(x)
        x = F.gelu(self.fc1(x), approximate="tanh")
        x = dropout(x, self.drop, train, gen, shard_dim=-1 if self.tp else None)
        y = tp.row_parallel(self.fc2, x) if self.tp else self.fc2(x)
        return dropout(y, self.drop, train, gen)


class Attention(nn.Module):
    """Multi-head self-attention over [..., N, C] tokens."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = False,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16, model_parallel: int = 1):
        super().__init__()
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.dtype, self.tp = dtype, model_parallel > 1
        self.head_dim = dim // num_heads
        self.num_heads = _local(num_heads, model_parallel, "head count")   # this rank's
        inner = self.num_heads * self.head_dim
        self.qkv = Dense(dim, 3 * inner, bias=qkv_bias, dtype=dtype)
        self.proj = Dense(inner, dim, dtype=dtype)

    def _proj(self, out, train, gen):
        y = tp.row_parallel(self.proj, out) if self.tp else self.proj(out)
        return dropout(y, self.proj_drop, train, gen)

    def forward(self, x, train: bool = False, gen=None):
        if self.tp:
            x = tp.copy_to_model(x)
        *lead, N, _ = x.shape
        heads, head_dim = self.num_heads, self.head_dim
        C = heads * head_dim
        scale = head_dim ** -0.5
        qkv = self.qkv(x)
        if _use_fused_attn(len(lead), self.attn_drop, N, head_dim, x.device):
            from autoprog_tpu_torch.ops.attention import mhsa_fused_qkv
            out = mhsa_fused_qkv(qkv.contiguous(), heads, scale)
            return self._proj(out, train, gen)
        # the JAX package's unfused (XLA) path, both branches
        q, k, v = qkv.reshape(*lead, N, 3, heads, head_dim).unbind(-3)
        attn = torch.einsum("...nhd,...mhd->...hnm", q.float(), k.float())
        if N >= 128:
            # logits stored in the compute dtype, exp/sum in f32
            attn = (attn * scale).to(self.dtype)
            attn = attn - attn.amax(-1, keepdim=True)
            e = torch.exp(attn.float())
            attn = (e / e.sum(-1, keepdim=True)).to(self.dtype)
        else:
            attn = torch.softmax(attn * scale, dim=-1).to(self.dtype)
        attn = dropout(attn, self.attn_drop, train, gen, shard_dim=-3 if self.tp else None)
        out = torch.einsum("...hnm,...mhd->...nhd", attn.float(), v.float())
        out = out.to(self.dtype).reshape(*lead, N, C)
        return self._proj(out, train, gen)


def _use_fused_outlook(kernel_size: int, stride: int, padding: int,
                       H: int, W: int, device: torch.device) -> bool:
    """Route outlook attention through the fused kernel (K2,
    ops/outlook_fused.py), the counterpart of `autoprog_tpu/models/layers.py:
    _use_fused_outlook`: AUTOPROG_FUSED_OUTLOOK = 1 | 0, and kernel 3,
    stride 2, padding 1, even H and W.

    The default is 1 for CUDA tensors and 0, the reference's, for CPU
    tensors. On an NVIDIA H100 80GB HBM3 at a power limit of 700.00 W the
    full volo_d1 train step at batch 128, 224 px, bf16 took 97.89 and 98.63 ms
    with K2 against 129.48 and 130.42 ms without (`chip_smoke.py`, the order
    0, 1, 1, 0): 24.4 % faster in both repetitions. In bf16 the two paths
    round at different points by design (see ops/outlook_fused.py)."""
    default = "1" if device.type == "cuda" else "0"
    mode = os.environ.get("AUTOPROG_FUSED_OUTLOOK", default)
    supported = (kernel_size == 3 and stride == 2 and padding == 1
                 and H % 2 == 0 and W % 2 == 0)
    return mode == "1" and supported


class OutlookAttention(nn.Module):
    """Outlook attention over an NHWC feature map."""

    def __init__(self, dim: int, num_heads: int, kernel_size: int = 3,
                 padding: int = 1, stride: int = 1, qkv_bias: bool = False,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16, model_parallel: int = 1):
        super().__init__()
        self.kernel_size, self.tp = kernel_size, model_parallel > 1
        self.padding, self.stride = padding, stride
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.head_dim = dim // num_heads
        self.num_heads = _local(num_heads, model_parallel, "head count")   # this rank's
        inner = self.num_heads * self.head_dim
        self.v = Dense(dim, inner, bias=qkv_bias, dtype=dtype)
        self.attn = Dense(dim, kernel_size ** 4 * self.num_heads, dtype=dtype)
        self.proj = Dense(inner, dim, dtype=dtype)

    def forward(self, x, train: bool = False, gen=None):
        if self.tp:
            x = tp.copy_to_model(x)
        head_dim = self.head_dim
        v = self.v(x)
        logits = self.attn(avg_pool_ceil(x, self.stride))
        if self.attn_drop:
            raise NotImplementedError("attn_drop>0 unsupported in fused outlook op")
        if _use_fused_outlook(self.kernel_size, self.stride, self.padding,
                              x.shape[1], x.shape[2], x.device):
            from autoprog_tpu_torch.ops.outlook_fused import outlook_attention_fused
            out = outlook_attention_fused(v.contiguous(), logits.contiguous(),
                                          self.num_heads, head_dim ** -0.5)
        else:
            out = outlook_attention(v, logits, num_heads=self.num_heads,
                                    kernel_size=self.kernel_size, stride=self.stride,
                                    padding=self.padding, scale=head_dim ** -0.5)
        y = tp.row_parallel(self.proj, out) if self.tp else self.proj(out)
        return dropout(y, self.proj_drop, train, gen)


class ClassAttention(nn.Module):
    """CaiT-style class attention: only the cls token attends."""

    def __init__(self, dim: int, num_heads: int, head_dim: Optional[int] = None,
                 qkv_bias: bool = False, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, dtype: torch.dtype = torch.bfloat16,
                 model_parallel: int = 1):
        super().__init__()
        self.head_dim = head_dim or dim // num_heads
        self.num_heads = _local(num_heads, model_parallel, "head count")   # this rank's
        self.tp = model_parallel > 1
        inner = self.head_dim * self.num_heads
        self.attn_drop, self.proj_drop, self.dtype = attn_drop, proj_drop, dtype
        self.kv = Dense(dim, 2 * inner, bias=qkv_bias, dtype=dtype)
        self.q = Dense(dim, inner, bias=qkv_bias, dtype=dtype)
        self.proj = Dense(inner, dim, dtype=dtype)

    def forward(self, x, train: bool = False, gen=None):
        if self.tp:
            x = tp.copy_to_model(x)
        B, N, _ = x.shape
        h, hd = self.num_heads, self.head_dim
        scale = hd ** -0.5
        k, v = self.kv(x).reshape(B, N, 2, h, hd).unbind(2)
        q = self.q(x[:, :1]).reshape(B, 1, h, hd)
        attn = torch.einsum("bqhd,bnhd->bhqn", (q * scale).float(), k.float())
        attn = torch.softmax(attn, dim=-1).to(self.dtype)
        attn = dropout(attn, self.attn_drop, train, gen, shard_dim=1 if self.tp else None)
        cls = torch.einsum("bhqn,bnhd->bqhd", attn.float(), v.float())
        cls = cls.to(self.dtype).reshape(B, 1, h * hd)
        y = tp.row_parallel(self.proj, cls) if self.tp else self.proj(cls)
        return dropout(y, self.proj_drop, train, gen)


class Outlooker(nn.Module):
    """norm -> outlook attention -> residual; norm -> MLP -> residual."""

    def __init__(self, dim: int, num_heads: int, kernel_size: int = 3,
                 padding: int = 1, stride: int = 1, mlp_ratio: float = 3.0,
                 qkv_bias: bool = False, attn_drop: float = 0.0,
                 drop_path: float = 0.0, dtype: torch.dtype = torch.bfloat16,
                 model_parallel: int = 1):
        super().__init__()
        self.drop_path = drop_path
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = OutlookAttention(dim, num_heads, kernel_size, padding, stride,
                                     qkv_bias, attn_drop, dtype=dtype,
                                     model_parallel=model_parallel)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype, model_parallel=model_parallel)

    def forward(self, x, train: bool = False, gen=None):
        x = x + drop_path(self.attn(self.norm1(x), train, gen), self.drop_path, train, gen)
        return x + drop_path(self.mlp(self.norm2(x), train, gen), self.drop_path, train, gen)


class TransformerBlock(nn.Module):
    """Pre-norm transformer block over token sequences."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 3.0,
                 qkv_bias: bool = False, attn_drop: float = 0.0,
                 drop_path: float = 0.0, dtype: torch.dtype = torch.bfloat16,
                 model_parallel: int = 1):
        super().__init__()
        self.drop_path = drop_path
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = Attention(dim, num_heads, qkv_bias, attn_drop, dtype=dtype,
                              model_parallel=model_parallel)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype, model_parallel=model_parallel)

    def forward(self, x, train: bool = False, gen=None):
        x = x + drop_path(self.attn(self.norm1(x), train, gen), self.drop_path, train, gen)
        return x + drop_path(self.mlp(self.norm2(x), train, gen), self.drop_path, train, gen)


class ClassBlock(nn.Module):
    """Class-attention block: updates only the cls token."""

    def __init__(self, dim: int, num_heads: int, head_dim: Optional[int] = None,
                 mlp_ratio: float = 3.0, qkv_bias: bool = False, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16, model_parallel: int = 1):
        super().__init__()
        self.drop_path = drop_path
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = ClassAttention(dim, num_heads, head_dim, qkv_bias, attn_drop,
                                   drop, dtype=dtype, model_parallel=model_parallel)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop=drop, dtype=dtype,
                       model_parallel=model_parallel)

    def forward(self, x, train: bool = False, gen=None):
        cls = x[:, :1]
        cls = cls + drop_path(self.attn(self.norm1(x), train, gen), self.drop_path, train, gen)
        cls = cls + drop_path(self.mlp(self.norm2(cls), train, gen), self.drop_path, train, gen)
        return torch.cat([cls, x[:, 1:]], dim=1)


class ConvBnRelu(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16, bn_momentum: float = 0.9,
                 bn_eps: float = 1e-5):
        super().__init__()
        self.conv = Conv(in_ch, features, kernel, stride, kernel // 2, False, dtype)
        self.bn = BatchNorm(features, dtype, bn_momentum, bn_eps)

    def forward(self, x, train: bool = False):
        return F.relu(self.bn(self.conv(x), train))


class PatchEmbed(nn.Module):
    """VOLO conv stem (3 x conv-BN-ReLU) + patchifying projection conv.
    NHWC in and out; NCHW (channels_last in memory) inside."""

    def __init__(self, embed_dim: int, patch_size: int = 8, stem_stride: int = 2,
                 hidden_dim: int = 64, stem_conv: bool = True, in_chans: int = 3,
                 dtype: torch.dtype = torch.bfloat16, bn_momentum: float = 0.9,
                 bn_eps: float = 1e-5):
        super().__init__()
        self.stem_conv = stem_conv
        ch = in_chans
        if stem_conv:
            for i, (k, s) in enumerate(((7, stem_stride), (3, 1), (3, 1))):
                self.add_module(f"stem{i}", ConvBnRelu(ch, hidden_dim, k, s, dtype,
                                                       bn_momentum, bn_eps))
                ch = hidden_dim
        ps = patch_size // stem_stride if stem_conv else patch_size
        self.proj = Conv(ch, embed_dim, ps, ps, 0, True, dtype)

    def forward(self, x, train: bool = False):
        x = x.permute(0, 3, 1, 2)
        if self.stem_conv:
            for i in range(3):
                x = getattr(self, f"stem{i}")(x, train)
        return self.proj(x).permute(0, 2, 3, 1)


class Downsample(nn.Module):
    """2x patch-merging conv between VOLO stages (NHWC in and out)."""

    def __init__(self, in_dim: int, out_dim: int, patch_size: int = 2,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.proj = Conv(in_dim, out_dim, patch_size, patch_size, 0, True, dtype)

    def forward(self, x):
        return self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
