"""Tensor parallelism over the `model` axis of the process grid, counterpart
of `autoprog_tpu/parallel/tp.py`.

Megatron-style sharding of the blocks (`s{s}b{i}`, `post{i}`), by the JAX
package's rules (`param_spec`):

  * `qkv`, `kv`, `q`, `v`, `attn` (the outlook logits) and `fc1` are column
    parallel: their output features are sharded, and so is their bias;
  * `proj` and `fc2` are row parallel: their input features are sharded and
    their bias is replicated;
  * everything else (stem, patch and pos embeddings, cls token, norms, heads,
    downsamples) is replicated.

The JAX package annotates the shardings and lets GSPMD insert the collectives;
the port has no partitioner, so each rank of a model group holds its own
shard of every sharded leaf (in parameters, optimizer moments and EMA trees)
and `models/layers.py` runs the block's collectives by hand: the input of a
column-parallel layer goes through `copy_to_model` (identity forward,
all-reduce of the gradient backward), the row-parallel output through
`row_parallel` (the partial products all-reduced in f32, then the bias added
once and the sum rounded once to the compute dtype).

Where the layouts differ from the JAX package's: the fused `qkv` [C, 3C] and
`kv` [C, 2C] kernels. JAX's `P(None, model)` splits the 3C columns
contiguously, which does not follow the heads, and GSPMD reshuffles after
the attention's reshape. Here each rank takes its heads from each of q, k
and v (k and v), so that its `qkv` output is [B, n, 3 C / M] in the (3,
heads / M, head_dim) order that K1 reads, and attention runs on the local
heads with no gather. `v`, `q`, the outlook logits (heads x 81, head-major)
and `fc1` split contiguously, as in JAX. Saved tensors are full in both
packages (`train/checkpoint.py` gathers them), so the layout does not show
outside the process.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from autoprog_tpu_torch.parallel import mesh

COL_PARALLEL = ("qkv", "kv", "q", "fc1", "v", "attn")   # output features sharded
ROW_PARALLEL = ("proj", "fc2")                          # input features sharded
#: fused kernels whose output features hold (parts, heads, head_dim)
HEADWISE = {"qkv": 3, "kv": 2}

#: collectives made, by kind: `copies` the backward all-reduce of
#: `copy_to_model`, `reduces` the forward all-reduce of `row_parallel`,
#: `norms` the sums of squares of the gradient clip, `gathers` the gathers
#: of sharded trees for a checkpoint or a stage rebuild
COUNTS = {"copies": 0, "reduces": 0, "norms": 0, "gathers": 0}

#: (dim, parts): the sharded axis of a tensor in the port's layout and the
#: number of head-wise parts along it (1: a contiguous split)
Spec = Optional[Tuple[int, int]]


def param_spec(name: str, ndim: int) -> Spec:
    """The sharding of one leaf by its dotted name, the JAX rules on the
    port's names (Dense `weight` [out, in] for Flax's `kernel` [in, out]).
    Their quirks are kept: a leaf is in a block where any part of its name
    starts with "s" and holds a "b", or starts with "post"; only 2-D weights
    are split; a bias follows its layer only where the layer is column
    parallel."""
    parts = name.split(".")
    leaf = parts[-1]
    parent = parts[-2] if len(parts) >= 2 else ""
    in_block = any(p.startswith("s") and "b" in p for p in parts) or \
        any(p.startswith("post") for p in parts)
    if not in_block:
        return None
    if leaf == "weight" and ndim == 2:
        if parent in COL_PARALLEL:
            return 0, HEADWISE.get(parent, 1)
        if parent in ROW_PARALLEL:
            return 1, 1
    if leaf == "bias" and parent in COL_PARALLEL:
        return 0, HEADWISE.get(parent, 1)
    return None


def validate_tp(model_parallel: int, num_heads: Sequence[int]) -> None:
    """Raises where `model_parallel` does not divide every head count."""
    if model_parallel == 1:
        return
    bad = [h for h in num_heads if h % model_parallel]
    if bad:
        raise ValueError(f"model-parallel size {model_parallel} must divide every head "
                         f"count; got {tuple(num_heads)}")


# ------------------------------------------------------- shards of a tree


def shard(t: torch.Tensor, spec: Spec, m: int, count: int) -> torch.Tensor:
    """Shard `m` of `count` of the full tensor `t` (a copy; `t` itself where
    it is replicated or there is one shard)."""
    if spec is None or count == 1:
        return t
    dim, parts = spec
    shape = tuple(t.shape)
    n = shape[dim]
    x = t.reshape(*shape[:dim], parts, count, n // (parts * count), *shape[dim + 1:])
    return x.select(dim + 1, m).reshape(*shape[:dim], n // count, *shape[dim + 1:]).clone()


def unshard(shards: Sequence[torch.Tensor], spec: Spec) -> torch.Tensor:
    """The full tensor of its `count` shards, in shard order (`shard`'s
    inverse, bit for bit)."""
    if spec is None or len(shards) == 1:
        return shards[0]
    dim, parts = spec
    shape = tuple(shards[0].shape)
    n = shape[dim]
    split = [s.reshape(*shape[:dim], parts, n // parts, *shape[dim + 1:]) for s in shards]
    full = torch.stack(split, dim=dim + 1)
    return full.reshape(*shape[:dim], n * len(shards), *shape[dim + 1:])


def shard_tree(tree: Mapping[str, torch.Tensor], m: Optional[int] = None,
               count: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Shard `m` of `count` (default: this rank's of the grid's) of a tree of
    full tensors by name: parameters, moments, EMA trees or gradients."""
    m = mesh.model_index() if m is None else m
    count = mesh.model_count() if count is None else count
    return {k: shard(v, param_spec(k, v.ndim), m, count) for k, v in tree.items()}


def gather_tree(shards: Sequence[Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The full tree of every shard's tree, in shard order (`shard_tree`'s
    inverse)."""
    return {k: unshard([s[k] for s in shards], param_spec(k, v.ndim))
            for k, v in shards[0].items()}


def _all_shards(tensors: List[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Every model rank's `tensors` (same shapes on every rank), per rank: one
    all-reduce over the model group of a [M, bytes] buffer that holds each
    rank's bytes in its slot, so that the values come back bit for bit. The
    buffer lies where the backend takes it (the CPU under gloo)."""
    count, m = mesh.model_count(), mesh.model_index()
    flat = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    sizes = [f.numel() for f in flat]
    buf = torch.zeros((count, sum(sizes)), dtype=torch.uint8,
                      device=mesh._collective_device())
    buf[m] = torch.cat(flat).to(buf.device)
    dist.all_reduce(buf, group=mesh.model_group())
    COUNTS["gathers"] += 1
    out = []
    for row in buf:
        parts = row.split(sizes)
        out.append([p.to(t.device, copy=True).view(t.dtype).reshape(t.shape)
                    for p, t in zip(parts, tensors)])
    return out


def gather_local(tree: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The full tree of this rank's shards: a collective over the model group
    (every rank of it must call it, with trees of the same names); the tree
    itself without tensor parallelism."""
    if mesh.model_count() == 1:
        return dict(tree)
    names = [k for k, v in tree.items() if param_spec(k, v.ndim) is not None]
    ranks = _all_shards([tree[k] for k in names])
    full = dict(tree)
    for i, k in enumerate(names):
        full[k] = unshard([r[i] for r in ranks], param_spec(k, tree[k].ndim))
    return full


def _param_names(model: torch.nn.Module, optimizer) -> List[str]:
    """The parameters' names in the order of the optimizer's `state_dict`
    indices."""
    by_id = {id(p): n for n, p in model.named_parameters()}
    return [by_id[id(p)] for g in optimizer.param_groups for p in g["params"]]


def _map_opt_state(saved: Mapping, names: List[str], fn) -> Dict:
    """`saved` (an optimizer state: the port's `state_dict`, by index, or the
    state by name that `convert.optax_to_torch_state` makes of a JAX file)
    with `fn(name, tensor)` applied to every per-parameter tensor."""
    out = dict(saved)
    if "state" in saved and "param_groups" in saved:
        out["state"] = {i: {k: fn(names[i], v) if torch.is_tensor(v) and v.ndim else v
                            for k, v in st.items()} for i, st in saved["state"].items()}
        return out
    for key, tree in saved.items():
        if isinstance(tree, Mapping):
            out[key] = {n: fn(n, v) for n, v in tree.items()}
    return out


def gather_optimizer_state(model: torch.nn.Module, optimizer) -> Dict:
    """The optimizer's `state_dict` with every sharded moment full (a
    collective over the model group, like `gather_local`)."""
    saved = optimizer.state_dict()
    if mesh.model_count() == 1:
        return saved
    # the per-parameter dicts of `state_dict()` are the optimizer's own
    saved["state"] = {i: dict(st) for i, st in saved["state"].items()}
    names = _param_names(model, optimizer)
    keys = [(i, k) for i in sorted(saved["state"]) for k, v in saved["state"][i].items()
            if torch.is_tensor(v) and v.ndim and param_spec(names[i], v.ndim) is not None]
    ranks = _all_shards([saved["state"][i][k] for i, k in keys])
    for j, (i, k) in enumerate(keys):
        v = saved["state"][i][k]
        saved["state"][i][k] = unshard([r[j] for r in ranks], param_spec(names[i], v.ndim))
    return saved


def shard_payload(ckpt: Mapping, model: torch.nn.Module, optimizer) -> Dict:
    """A checkpoint payload of full tensors as this rank's shards: the
    parameters, every EMA tree and the optimizer state (either package's);
    the payload itself without tensor parallelism."""
    if mesh.model_count() == 1:
        return dict(ckpt)
    out = dict(ckpt)
    for key, tree in ckpt.items():
        if key == "state_dict" or key.startswith("state_dict_ema_"):
            out[key] = shard_tree(tree)
    if ckpt.get("optimizer"):
        m, count = mesh.model_index(), mesh.model_count()
        out["optimizer"] = _map_opt_state(
            ckpt["optimizer"], _param_names(model, optimizer),
            lambda n, v: shard(v, param_spec(n, v.ndim), m, count))
    return out


@torch.no_grad()
def load_shards(model: torch.nn.Module, params: Mapping[str, torch.Tensor],
                buffers: Mapping[str, torch.Tensor]) -> None:
    """This rank's shards of full `params`, and `buffers`, into `model`."""
    for n, p in model.named_parameters():
        p.copy_(shard(params[n], param_spec(n, params[n].ndim), mesh.model_index(),
                      mesh.model_count()))
    for n, b in model.named_buffers():
        b.copy_(buffers[n])


# ------------------------------------------------- the block's collectives


class _CopyToModel(torch.autograd.Function):
    """Identity forward; backward, the gradient summed over the model group
    (each rank's shard of a column-parallel layer gives its part of it), in
    f32, rounded once to the gradient's dtype."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.to(torch.float32, copy=True).contiguous()
        dist.all_reduce(g, group=mesh.model_group())
        COUNTS["copies"] += 1
        return g.to(grad.dtype)


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce sum over the model group forward; identity backward (every
    rank's partial product takes the whole output gradient)."""

    @staticmethod
    def forward(ctx, x):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=mesh.model_group())
        COUNTS["reduces"] += 1
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel layer (Megatron's f); `x` itself
    without tensor parallelism."""
    return _CopyToModel.apply(x) if mesh.model_count() > 1 else x


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of the model group's partial products (Megatron's g); `x`
    itself without tensor parallelism."""
    return _ReduceFromModel.apply(x) if mesh.model_count() > 1 else x


def row_parallel(dense, x: torch.Tensor) -> torch.Tensor:
    """A row-parallel Dense on this rank's input features: the partial
    product (in the compute dtype, as the GEMM rounds it), summed over the
    model group in f32, the bias (rounded to the compute dtype, as the
    one-device layer adds it) added once, and the sum rounded once to the
    compute dtype. Against the one-device layer, which rounds once after an
    f32 accumulation, the extra roundings are those of the M partial
    products: |y_tp - y_1| <= u (sum_m |P_m|) + u |y| with u the unit
    roundoff (2^-8 in bf16, 2^-24 in f32), and in f32 the order of the sum."""
    dt = dense.dtype
    part = F.linear(x.to(dt), dense.weight.to(dt))
    y = reduce_from_model(part.float())
    if dense.bias is not None:
        y = y + dense.bias.to(dt).float()
    return y.to(dt)


# ---------------------------------------------------------- gradient clip


def model_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` in f32 summed over the model group (a new tensor; `t` in f32
    without tensor parallelism)."""
    if mesh.model_count() == 1:
        return t.detach().float()
    out = t.detach().float().contiguous().clone()
    dist.all_reduce(out, group=mesh.model_group())
    COUNTS["norms"] += 1
    return out
