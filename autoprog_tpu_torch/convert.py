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
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

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
    return torch.tensor(a.astype(np.float32) if a.dtype.kind == "f" else a)


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
