"""Growth / shrink weight remapping over the port's `state_dict`s,
counterpart of `autoprog_tpu/prog/growth.py`.

A remap is a pure function from the small model's parameters (name ->
tensor, plus optional EMA trees) to the big model's, built against the
destination model's own `state_dict` as the shape template. Every tensor it
returns owns fresh storage: depth cloning maps several destination layers to
one source, and no two parameters may share memory afterwards.

Modes:
  * "slice"       top-left block copy into the fresh init, same-name layers
                  only (no depth interpolation; deeper layers keep their init);
  * "clone_rand"  depth interpolation + top-left copy into the fresh init;
  * "zero"        depth interpolation + top-left copy into zeros;
  * "clone"       width growth by channel tiling with 1/scale input
                  compensation and per-projection qkv / kv tiling;
  * "clone_noise" the same + truncated-normal(std .01) noise on every
                  replica after the first (symmetry breaking);
  * "clone_ema"   new channels stitched from three extra EMA trees.
`shrink_params` selects a standalone sub-model out of a supernet.

Layouts: the port stores Dense weights as [out, in] and conv weights as OIHW
(`convert.py`), the transposes of Flax's [in, out] and HWIO. The tiling rules
below are written for [in, out] / HWIO, exactly as the JAX module has them,
and each weight is transposed into that layout on the way in and back on
the way out, so both packages run the same arithmetic in the same order.
The fused qkv out-axis keeps its (3, heads, d) order.

Noise: the JAX module folds a PRNG key per leaf; torch cannot reproduce
that stream. Here `rng` is a `torch.Generator` whose seed, mixed with a
crc32 of the source's name, seeds one generator per leaf, so the noise does
not depend on the order of the dictionary.
"""

from __future__ import annotations

import re
import zlib
from typing import Callable, Dict, Optional, Sequence

import torch

from autoprog_tpu_torch.prog.depth import depth_source_index, super_select_indices

_BLOCK_RE = re.compile(r"s(\d+)b(\d+)")
_DENSE_BIAS_OWNERS = ("qkv", "kv", "q", "proj", "fc1", "fc2", "head", "aux_head",
                      "head_dist", "attn", "v")
Tree = Dict[str, torch.Tensor]


def _fresh(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`t` in `dtype` in contiguous storage of its own."""
    return t.detach().to(dtype).clone(memory_format=torch.contiguous_format)


def _trunc_normal(gen: torch.Generator, like: torch.Tensor, std: float = 0.01):
    noise = torch.empty_like(like)
    torch.nn.init.trunc_normal_(noise, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return std * noise


def _crop(arr: torch.Tensor, axis: int, target: int) -> torch.Tensor:
    return arr.narrow(axis, 0, target)


def _tile_axis(arr: torch.Tensor, axis: int, target: int,
               gen: Optional[torch.Generator]) -> torch.Tensor:
    """Tile `arr` along `axis` up to `target`, optionally adding fresh
    trunc-normal noise to every replica after the first."""
    size = arr.shape[axis]
    if size >= target:
        return _crop(arr, axis, target)
    reps = -(-target // size)
    parts = [arr]
    for _ in range(reps - 1):
        parts.append(arr + _trunc_normal(gen, arr) if gen is not None else arr)
    return _crop(torch.cat(parts, dim=axis), axis, target)


def _stitch_axis(base: torch.Tensor, extra: torch.Tensor, axis: int,
                 target: int) -> torch.Tensor:
    """[base | extra] along `axis`, cropped to target (EMA stitching)."""
    if target > base.shape[axis] + extra.shape[axis]:
        raise ValueError("clone_ema supports at most 2x width growth")
    return _crop(torch.cat([base, extra], dim=axis), axis, target)


def _is_fused_proj(path: Sequence[str]) -> int:
    """3 for qkv, 2 for kv, 0 otherwise."""
    if "qkv" in path:
        return 3
    if "kv" in path:
        return 2
    return 0


def _grow_dense_kernel(src, dst_shape, fuse: int, mode: str, gen, ema):
    """`src` and the result are [in, out]."""
    s_in, s_out = src.shape
    d_in, d_out = dst_shape
    scale = d_in / s_in
    nk = gen if mode == "clone_noise" else None
    if fuse:
        srcf = src.reshape(s_in, fuse, s_out // fuse)
        if mode == "clone_ema":
            r1 = _stitch_axis(srcf, ema[0].reshape(s_in, fuse, -1), 0, d_in)
            r2 = _stitch_axis(ema[1].reshape(s_in, fuse, -1),
                              ema[2].reshape(s_in, fuse, -1), 0, d_in)
            out = _stitch_axis(r1, r2, 2, d_out // fuse)
        else:
            out = _tile_axis(srcf, 0, d_in, nk)
            out = _tile_axis(out, 2, d_out // fuse, nk)
        return (out / scale).reshape(d_in, d_out)
    if mode == "clone_ema":
        r1 = _stitch_axis(src, ema[0], 0, d_in)
        r2 = _stitch_axis(ema[1], ema[2], 0, d_in)
        out = _stitch_axis(r1, r2, 1, d_out)
    else:
        out = _tile_axis(src, 0, d_in, nk)
        out = _tile_axis(out, 1, d_out, nk)
    return out / scale


def _grow_dense_bias(src, dst_shape, fuse: int, mode: str, ema):
    (d_out,) = dst_shape
    if fuse:
        srcf = src.reshape(fuse, -1)
        if mode == "clone_ema":
            out = _stitch_axis(srcf, ema[0].reshape(fuse, -1), 1, d_out // fuse)
        else:
            out = _tile_axis(srcf, 1, d_out // fuse, None)
        return out.reshape(d_out)
    if mode == "clone_ema":
        return _stitch_axis(src, ema[0], 0, d_out)
    return _tile_axis(src, 0, d_out, None)


def _grow_conv_kernel(src, dst_shape, is_downsample: bool, mode: str, gen, ema):
    """`src` and the result are HWIO; only the inter-stage downsample conv
    is rescaled for its grown input width."""
    d_in, d_out = dst_shape[2], dst_shape[3]
    nk = gen if mode == "clone_noise" else None
    if mode == "clone_ema":
        r1 = _stitch_axis(src, ema[0], 2, d_in)
        r2 = _stitch_axis(ema[1], ema[2], 2, d_in)
        out = _stitch_axis(r1, r2, 3, d_out)
    else:
        out = _tile_axis(src, 2, d_in, nk)
        out = _tile_axis(out, 3, d_out, nk)
    if is_downsample:
        out = out / (d_in / src.shape[2])
    return out


def _grow_vector(src, dst_shape, mode: str, ema):
    """1-D affine parameters (LayerNorm / BatchNorm weight and bias)."""
    (d,) = dst_shape
    if mode == "clone_ema":
        return _stitch_axis(src, ema[0], 0, d)
    return _tile_axis(src, 0, d, None)


def _grow_embed(src, dst_shape, mode: str, ema):
    """pos_embed / cls_token / dist_token: tile the channel (last) axis."""
    if tuple(src.shape[:-1]) != tuple(dst_shape[:-1]):
        raise ValueError(
            f"embed grid mismatch {tuple(src.shape)} -> {tuple(dst_shape)}; growth "
            "does not resize pos-embed grids (resolution is handled at runtime)")
    if mode == "clone_ema":
        return _stitch_axis(src, ema[0], src.ndim - 1, dst_shape[-1])
    return _tile_axis(src, src.ndim - 1, dst_shape[-1], None)


def _to_flax_layout(t: torch.Tensor) -> torch.Tensor:
    """[out, in] -> [in, out]; OIHW -> HWIO."""
    return t.t() if t.ndim == 2 else t.permute(2, 3, 1, 0)


def _from_flax_layout(t: torch.Tensor) -> torch.Tensor:
    return t.t() if t.ndim == 2 else t.permute(3, 2, 0, 1)


def _depth_mapped_name(name: str, src_layers: Sequence[int],
                       dst_layers: Sequence[int]) -> str:
    head, _, rest = name.partition(".")
    m = _BLOCK_RE.fullmatch(head)
    if not m:
        return name
    stage, idx = int(m.group(1)), int(m.group(2))
    src_idx = depth_source_index(idx, src_layers[stage], dst_layers[stage])
    return f"s{stage}b{src_idx}.{rest}"


def _remap_tree(src: Tree, dst_template: Tree, *, name_map: Callable[[str], str],
                mode: str, ema_trees: Optional[Sequence[Tree]],
                rng: Optional[torch.Generator], keep_template_when_missing: bool) -> Tree:
    out: Tree = {}
    for name, tmpl in dst_template.items():
        sn = name_map(name)
        if sn not in src:
            if not keep_template_when_missing:
                raise KeyError(f"no source for {name} (mapped {sn})")
            out[name] = _fresh(tmpl, tmpl.dtype)
            continue
        s = src[sn].detach()
        dst_shape = tuple(tmpl.shape)
        if tuple(s.shape) == dst_shape and mode != "clone_noise":
            out[name] = _fresh(s, tmpl.dtype)
            continue
        if mode in ("slice", "clone_rand", "zero"):
            base = _fresh(torch.zeros_like(tmpl) if mode == "zero" else tmpl, tmpl.dtype)
            base[tuple(slice(0, n) for n in s.shape)] = s.to(tmpl.dtype)
            out[name] = base
            continue
        ema = [e[sn].detach() for e in ema_trees] if ema_trees else None
        gen = None
        if rng is not None:
            seed = (rng.initial_seed() * 1000003 + zlib.crc32(sn.encode())) & 0x7FFFFFFF
            gen = torch.Generator(device=s.device).manual_seed(seed)
        path = name.split(".")
        leaf = path[-1]
        if leaf == "weight" and s.ndim in (2, 4):
            s = _to_flax_layout(s)
            ema = [_to_flax_layout(e) for e in ema] if ema else None
            shape = tuple(_to_flax_layout(tmpl).shape)
            if s.ndim == 2:
                grown = _grow_dense_kernel(s, shape, _is_fused_proj(path), mode, gen, ema)
            else:
                is_ds = any(p.startswith("ds") for p in path)
                grown = _grow_conv_kernel(s, shape, is_ds, mode, gen, ema)
            grown = _from_flax_layout(grown)
        elif leaf == "bias" and s.ndim == 1 and any(p in _DENSE_BIAS_OWNERS for p in path):
            grown = _grow_dense_bias(s, dst_shape, _is_fused_proj(path), mode, ema)
        elif leaf in ("pos_embed", "cls_token", "dist_token"):
            grown = _grow_embed(s, dst_shape, mode, ema)
        elif s.ndim == 1:
            grown = _grow_vector(s, dst_shape, mode, ema)
        else:
            raise NotImplementedError(f"no growth rule for {name} "
                                      f"{tuple(s.shape)} -> {dst_shape}")
        out[name] = _fresh(grown, tmpl.dtype)    # whatever views the rules returned
    return out


def grow_params(src_params: Tree, dst_template: Tree, *, src_layers: Sequence[int],
                dst_layers: Sequence[int], mode: str = "clone",
                ema_trees: Optional[Sequence[Tree]] = None,
                rng: Optional[torch.Generator] = None) -> Tree:
    """Remap a smaller model's parameters into a larger template.

    src_params: parameters of the previous-stage model, by name.
    dst_template: parameters of the new model: the target shapes and, for
      the slice modes, the fresh init values.
    src_layers / dst_layers: per-stage block counts of the two archs.
    ema_trees: three EMA trees for mode='clone_ema' (the source is a fourth;
      pass it as `src_params`).
    rng: a `torch.Generator` for mode='clone_noise' (only its seed is used).
    """
    if mode == "clone_ema" and (ema_trees is None or len(ema_trees) < 3):
        raise ValueError("clone_ema needs >= 3 extra EMA trees")
    if mode == "clone_noise" and rng is None:
        raise ValueError("clone_noise needs an rng generator")
    if mode == "slice":
        # matched by name only: new depth layers have no source
        def name_map(n):
            return n
    else:
        def name_map(n):
            return _depth_mapped_name(n, src_layers, dst_layers)
    return _remap_tree(src_params, dst_template, name_map=name_map, mode=mode,
                       ema_trees=ema_trees, rng=rng,
                       keep_template_when_missing=(mode == "slice"))


def shrink_params(super_params: Tree, dst_template: Tree, *, base_layers: Sequence[int],
                  super_layers: Sequence[int], dst_layers: Sequence[int], base_l: int,
                  super_l: int, dst_l: int, family: str = "volo") -> Tree:
    """Select a standalone sub-model's parameters out of a supernet: per
    stage, the non-skip layer indices derived from the (base -> super)
    growth."""
    sel = super_select_indices(base_l, super_l, dst_l, family)

    def name_map(name):
        head, _, rest = name.partition(".")
        m = _BLOCK_RE.fullmatch(head)
        if not m:
            return name
        stage, idx = int(m.group(1)), int(m.group(2))
        if stage < len(sel) and len(dst_layers) > stage and \
                dst_layers[stage] < super_layers[stage]:
            src_idx = sel[stage][idx]
        else:
            src_idx = depth_source_index(idx, super_layers[stage], dst_layers[stage])
        return f"s{stage}b{src_idx}.{rest}"

    return _remap_tree(super_params, dst_template, name_map=name_map, mode="clone",
                       ema_trees=None, rng=None, keep_template_when_missing=False)


def grow_batch_stats(src_stats: Tree, dst_template: Tree, *, src_layers, dst_layers) -> Tree:
    """Carry BatchNorm running stats through growth where shapes match (the
    VOLO stem never changes width across variants); the template's
    otherwise. `train/bn.py:recalibrate_bn` re-estimates them on request."""
    out: Tree = {}
    for name, tmpl in dst_template.items():
        s = src_stats.get(_depth_mapped_name(name, src_layers, dst_layers)) \
            if src_stats else None
        if s is not None and tuple(s.shape) == tuple(tmpl.shape):
            out[name] = _fresh(s, tmpl.dtype)
        else:
            out[name] = _fresh(tmpl, tmpl.dtype)
    return out
