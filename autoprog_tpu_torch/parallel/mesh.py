"""Data parallelism across processes and the (data, model) process grid,
counterpart of `autoprog_tpu/parallel/mesh.py`.

The JAX package runs one SPMD program over a `data` mesh axis: the batch is
sharded, parameters, BatchNorm statistics, EMA trees and the optimizer state
are replicated, and XLA reduces the gradient of the global-batch loss. The
port runs one process per rank under `torchrun` and does the same by hand:

  * `-b` is the global batch; each rank loads `b // world`, a strided shard
    of one global permutation (`data/loader.py`);
  * BatchNorm takes its statistics over the global batch
    (`models/layers.py:BatchNorm`, through `sum_over_ranks`);
  * the train step averages the gradients with one coalesced all-reduce
    after the last micro-batch (`all_reduce_grads`), so every rank applies
    the same update to the same parameters;
  * the model is built from the same seed on every rank and `replicate`
    broadcasts rank 0's parameters and buffers after every rebuild and load;
  * MixToken pairs sample i with sample B-1-i of the global batch
    (`flip_batch`), with one box for the global batch;
  * metric sums are summed over the ranks (`all_reduce_sum`), the grow
    decision is rank 0's (`broadcast_ints`), and only rank 0 logs and writes.

The group comes from torchrun's environment (`RANK`, `WORLD_SIZE`,
`LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`); without it the port runs in one
process with no group, and the callers make no collective. The backend
is NCCL for a CUDA device and gloo for the CPU; `AUTOPROG_DIST_BACKEND`
names it (gloo on a CUDA device is how two ranks share one card: NCCL
refuses two ranks on one device). Every rank must reach every collective in
the same order.

`--model-parallel M` (`init_grid`) lays the ranks out as the JAX package's
`make_mesh` lays out its devices: rank = d * M + m, with `model` the minor
axis. The M consecutive ranks of a model group hold the shards of one model
replica (`parallel/tp.py`) and see the same rows; the ranks with equal m form
a data group. Everything above that means "over the batch" (the batch
slice, the gradient mean, the synced BatchNorm, MixToken's flip, the metric
sums and probe losses, `replicate`) works over the data group; the grow
decision (`broadcast_ints`), `min_over_ranks` and `barrier` stay world-wide.
With M = 1 the data group is the world and no group is made.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Sequence

import torch
import torch.distributed as dist

from autoprog_tpu_torch.platform import default_device

BACKEND_ENV = "AUTOPROG_DIST_BACKEND"
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

#: collectives made, by kind: `grads` once a train step, `autograd_sums` once
#: a synced BatchNorm forward, `sums` for metric sums and probe losses,
#: `broadcasts` for `replicate` and the grow decision, `flips` for MixToken's
#: batch flips across ranks
COUNTS = {"grads": 0, "autograd_sums": 0, "sums": 0, "broadcasts": 0, "flips": 0}

#: the process grid of `init_grid`: the model-parallel size and this rank's
#: data and model groups (None: the world, or no group at all)
_GRID = {"model": 1, "data_group": None, "model_group": None}


def process_group_active() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if process_group_active() else 0


def process_count() -> int:
    return dist.get_world_size() if process_group_active() else 1


def is_primary() -> bool:
    return process_index() == 0


def model_count() -> int:
    return _GRID["model"]


def model_index() -> int:
    return process_index() % _GRID["model"]


def data_count() -> int:
    return process_count() // _GRID["model"]


def data_index() -> int:
    return process_index() // _GRID["model"]


def data_group():
    """This rank's data group (None: the world)."""
    return _GRID["data_group"]


def model_group():
    """This rank's model group (None without tensor parallelism)."""
    return _GRID["model_group"]


def init_grid(model_parallel: int = 1) -> None:
    """The (data, model) grid over the ranks, `model` minor: model group d is
    ranks d*M .. d*M + M - 1, data group m the ranks r with r % M == m. Every
    rank makes every group, in the same order (`dist.new_group` is a
    collective). Raises ValueError where M does not divide the world, as
    `make_mesh` does; a single process at M > 1 is such a world. Calling it
    again with the grid's own M does nothing."""
    world = process_count()
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"{world} devices not divisible by model_parallel={model_parallel}")
    if model_parallel == _GRID["model"]:
        return
    _GRID.update(model=1, data_group=None, model_group=None)
    if model_parallel == 1:
        return
    rank, mine = process_index(), {}
    for d in range(world // model_parallel):
        ranks = list(range(d * model_parallel, (d + 1) * model_parallel))
        group = dist.new_group(ranks)
        if rank in ranks:
            mine["model_group"] = group
    for m in range(model_parallel):
        ranks = list(range(m, world, model_parallel))
        group = dist.new_group(ranks)
        if rank in ranks:
            mine["data_group"] = group
    _GRID.update(model=model_parallel, **mine)


def maybe_init_distributed() -> bool:
    """Join the process group torchrun's environment describes; returns
    whether there is one. Without `WORLD_SIZE` in the environment this is a
    no-op: one process, no group. The device (`platform.default_device`:
    `cuda:{LOCAL_RANK}` unless `AUTOPROG_TORCH_DEVICE` names one) is made
    current before an NCCL group exists. A failed `init_process_group`
    raises."""
    if process_group_active():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"WORLD_SIZE is set but {missing} are not: launch with torchrun")
    device = default_device()
    backend = os.environ.get(BACKEND_ENV) or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"{BACKEND_ENV}={backend}: only nccl and gloo are supported")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, not {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
    return True


def destroy() -> None:
    _GRID.update(model=1, data_group=None, model_group=None)
    if process_group_active():
        dist.destroy_process_group()


def process_batch_slice(global_batch: int) -> slice:
    """This rank's rows of the global batch (DistributedSampler analogue):
    its data group's share; the ranks of one model group take the same rows."""
    per = global_batch // data_count()
    i = data_index()
    return slice(i * per, (i + 1) * per)


def _collective_device() -> torch.device:
    """Where a tensor made for a collective lives: the current CUDA device
    under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _coalesced(tensors: Sequence[torch.Tensor], op) -> None:
    """`op` on one flat buffer per dtype, copied back in place."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        op(flat)
        parts = flat.split([t.numel() for t in group])
        torch._foreach_copy_(group, [p.view_as(t) for p, t in zip(parts, group)])


def all_reduce_grads(params: Iterable[torch.Tensor]) -> None:
    """Every parameter's gradient replaced by its mean over the data group:
    one all-reduce of the flattened gradients (per dtype), divided by the
    group's size. The gradient of the global-batch mean loss, as each rank's
    loss is the mean over an equal share of the batch; under tensor
    parallelism each rank averages its own shards with the ranks that hold
    the same ones. It runs on a group of one rank too (counted like any
    other), where it divides by nothing."""
    world = data_count()

    def op(flat):
        dist.all_reduce(flat, group=data_group())
        if world > 1:
            flat.div_(world)
    _coalesced([p.grad for p in params], op)
    COUNTS["grads"] += 1


def all_reduce_sum(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sums over the data group of `tensors` (device scalars of metric
    sums or probe losses), as new tensors, in one all-reduce."""
    out = [t.detach().clone() for t in tensors]
    _coalesced(out, lambda flat: dist.all_reduce(flat, group=data_group()))
    COUNTS["sums"] += 1
    return out


def mean_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """A device scalar's mean over the data group (a loss); `t` itself
    without a process group."""
    if not process_group_active():
        return t
    return all_reduce_sum([t])[0] / data_count()


class _SumOverRanks(torch.autograd.Function):
    """All-reduce sum over the data group whose backward all-reduces the
    gradient, as SyncBatchNorm's statistics do: each rank's loss reaches
    every rank's input through the summed statistics. (Over the world, the
    ranks of a model group, which hold the same rows, would count each
    sample M times.)"""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out, group=data_group())
        COUNTS["autograd_sums"] += 1
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=data_group())
        return grad


def sum_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the data group, differentiably."""
    return _SumOverRanks.apply(x)


def _mirror(x: torch.Tensor) -> torch.Tensor:
    """Data rank W-1-r's `x` on data rank r, through one all-reduce over the
    data group of a [W, ...] buffer that holds each rank's tensor in its slot
    (gloo takes CUDA tensors in all-reduce and broadcast only)."""
    w, r = data_count(), data_index()
    buf = x.new_zeros((w, *x.shape))
    buf[r] = x
    dist.all_reduce(buf, group=data_group())
    return buf[w - 1 - r]


class _FlipOverRanks(torch.autograd.Function):
    """Rows of the global batch in reverse order, this rank's share: rank r
    gets rank W-1-r's rows reversed. The map is its own adjoint, so the
    backward does the same to the gradient."""

    @staticmethod
    def forward(ctx, x):
        COUNTS["flips"] += 1
        return _mirror(x).flip(0)

    @staticmethod
    def backward(ctx, grad):
        return _mirror(grad.contiguous()).flip(0)


def flip_batch(x: torch.Tensor) -> torch.Tensor:
    """`x` with the batch reversed, over the global batch: what MixToken
    pairs a sample with (sample i with sample B-1-i, as the JAX package's
    flip of its sharded batch does). Under a data group of more than one rank
    the rows come from the mirror rank, differentiably; else `torch.flip`."""
    if data_count() == 1:
        return torch.flip(x, dims=(0,))
    return _FlipOverRanks.apply(x)


def replicate(module: torch.nn.Module, *trees: Dict[str, torch.Tensor],
              world: bool = False) -> None:
    """The parameters and buffers of `module`, and the tensors of each tree
    (EMA trees), in place on every rank of the data group as its first rank
    (global rank m) holds them: one broadcast per dtype. Under tensor
    parallelism those are this rank's shards, which only its data group
    shares; `world` broadcasts rank 0's over every rank instead (a full,
    unsharded model). A no-op without a process group."""
    if not process_group_active():
        return
    tensors = [p.data for p in module.parameters()] + list(module.buffers())
    tensors += [t for tree in trees for t in tree.values()]
    group, src = (None, 0) if world else (data_group(), model_index())
    with torch.no_grad():
        _coalesced(tensors, lambda flat: dist.broadcast(flat, src=src, group=group))
    COUNTS["broadcasts"] += 1


def broadcast_ints(values: Sequence[int]) -> List[int]:
    """Rank 0's `values` on every rank."""
    t = torch.tensor(list(values), dtype=torch.int64, device=_collective_device())
    dist.broadcast(t, src=0)
    COUNTS["broadcasts"] += 1
    return [int(v) for v in t.tolist()]


def min_over_ranks(n: int) -> int:
    """The least `n` over the ranks (the number of steps every rank can
    take in an epoch: strided shards differ by up to one sample)."""
    t = torch.tensor([n], dtype=torch.int64, device=_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def barrier(tag: str) -> None:
    """Every rank waits here (after rank 0 wrote a checkpoint, so that a
    resume on any rank reads a whole file); counterpart of the JAX package's
    `compile_barrier`. `tag` names the point in an error."""
    if not process_group_active():
        return
    try:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"barrier {tag!r} failed: {e}") from e
