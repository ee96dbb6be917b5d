"""Flax parameter trees -> the port's `state_dict` names and layouts.

A Flax tree (`params`, `batch_stats`, a gradient tree or an EMA tree, as
numpy or jax arrays) flattens to dotted names under the reference's module
names (`s{stage}b{idx}`, `qkv`/`kv`/`q`, `pos_embed`, `cls_token`, `head`,
`aux_head`, `patch_embed.stem{i}.{conv,bn}`, `ds{s}`, `post{i}`, `norm`; for
DeiT `patch_embed` is the patchify conv itself, with `dist_token` and
`head_dist` in the distilled variants):

  Dense kernel [in, out]        -> weight [out, in]
  Conv kernel HWIO              -> weight OIHW
  LayerNorm / BatchNorm scale   -> weight
  BatchNorm mean / var          -> running_mean / running_var
  bias, pos_embed, cls_token,
  dist_token                    -> unchanged

The fused `qkv` out-axis keeps its (3, heads, d) order, which K1 relies on.

`flax_to_torch_shard` takes a tree to one tensor-parallel rank's shard of it
(`parallel/tp.py`: the full conversion, then `shard_tree`).

`jax_payload_to_torch` turns a whole checkpoint of the JAX package (the
tree `autoprog_tpu/train/checkpoint.py:build_payload` writes) into the
port's payload: every tree through `flax_to_torch`, and the optax state
through `optax_to_torch_state`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

_LEAF = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
         "var": "running_var"}


def _leaf(name: str, value) -> torch.Tensor:
    a = np.asarray(value)
    if name == "kernel":
        if a.ndim == 2:
            a = a.T
        elif a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"kernel of rank {a.ndim} has no torch layout")
    floating = a.dtype.kind == "f" or a.dtype.name == "bfloat16"
    return torch.tensor(a.astype(np.float32) if floating else a)


def _flatten(tree: Mapping[str, Any], prefix: str, out: Dict[str, torch.Tensor]):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            _flatten(v, f"{prefix}{k}.", out)
        else:
            out[prefix + _LEAF.get(k, k)] = _leaf(k, v)


def flax_to_torch(params: Mapping[str, Any],
                  batch_stats: Optional[Mapping[str, Any]] = None) -> Dict[str, torch.Tensor]:
    """A Flax params tree (and optionally its batch_stats) as a state_dict.

    Gradient and EMA trees have the params' structure, so the same call
    converts them."""
    out: Dict[str, torch.Tensor] = {}
    _flatten(params, "", out)
    if batch_stats:
        _flatten(batch_stats, "", out)
    return out


def flax_to_torch_shard(params: Mapping[str, Any], m: int, count: int,
                        batch_stats: Optional[Mapping[str, Any]] = None
                        ) -> Dict[str, torch.Tensor]:
    """Shard `m` of `count` of a Flax tree under `--model-parallel count`:
    `flax_to_torch`, then `parallel/tp.py:shard_tree` (whose `gather_tree`
    of every shard gives the full conversion back bit for bit)."""
    from autoprog_tpu_torch.parallel.tp import shard_tree
    return shard_tree(flax_to_torch(params, batch_stats), m, count)


ADAM_KEYS = ("count", "mu", "nu")


def _opt_states(tree: Any, out: List[Mapping[str, Any]]) -> None:
    if not isinstance(tree, Mapping):
        return
    if all(k in tree for k in ADAM_KEYS) or set(tree) == {"trace"}:
        out.append(tree)
        return
    for v in tree.values():
        _opt_states(v, out)


def optax_to_torch_state(opt_state: Mapping[str, Any]) -> Dict[str, Any]:
    """The JAX package's optax chain state (`autoprog_tpu/train/optim.py`:
    clip -> scale_by_adam or trace -> masked add_decayed_weights, serialised
    as {"0": ..., "1": ...}) as the port's optimizer state keyed by
    parameter name: {"count": int, "exp_avg": {name: mu}, "exp_avg_sq":
    {name: nu}} for Adam, {"momentum_buffer": {name: trace}} for the
    Nesterov trace of --opt sgd / momentum. Kernels are transposed like the
    weights; every float leaf comes as f32 (a bf16 mu exactly), and
    `train/checkpoint.py` casts it to the optimizer's own state dtype. The
    chain is walked, so clip, mask and empty states anywhere in it are
    passed over; it must hold exactly one scale_by_adam or trace state."""
    found: List[Mapping[str, Any]] = []
    _opt_states(opt_state, found)
    if len(found) != 1:
        raise NotImplementedError(
            f"the optimizer state holds {len(found)} scale_by_adam / trace states; the "
            "port restores the state of --opt adamw, adam, sgd and momentum only")
    state = found[0]
    if "trace" in state:
        return {"momentum_buffer": flax_to_torch(state["trace"])}
    return {"count": int(np.asarray(state["count"])), "exp_avg": flax_to_torch(state["mu"]),
            "exp_avg_sq": flax_to_torch(state["nu"])}


def jax_payload_to_torch(payload: Mapping[str, Any]) -> Dict[str, Any]:
    """A JAX checkpoint payload as the port's: `state_dict`, `batch_stats`
    and every `state_dict_ema_{i}` as state_dicts, `optimizer` as
    `optax_to_torch_state`'s dict where the chain holds an Adam or trace state (else left
    as it is, for `restore_state` to refuse), the rest (arch, stage_info,
    step, epoch, metric, args_text, lr_schedule) as it is."""
    out = dict(payload)
    for key, tree in payload.items():
        if key == "state_dict" or key.startswith("state_dict_ema_"):
            out[key] = flax_to_torch(tree)
    out["batch_stats"] = flax_to_torch(payload.get("batch_stats") or {})
    if "optimizer" in payload:
        try:
            out["optimizer"] = optax_to_torch_state(payload["optimizer"])
        except NotImplementedError:
            pass
    return out
