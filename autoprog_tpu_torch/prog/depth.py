"""Depth-interpolation index math for progressive growth (pure functions).

When a network grows from `prev_l` to `new_l` layers, each new layer index
maps back to a source layer in the smaller network; layer indices whose
source repeats a previous index are "new" layers (initialized as clones and,
in the elastic supernet, skippable as identity).

Mirrors reference `prog/helpers.py:254-262` (`new_idx`/`get_new_layer_idx`)
and the supernet skip-mask computation in `models/volo.py:598-616`
(`VOLO.set_sample_config`).
"""

from __future__ import annotations

from typing import List, Tuple

from autoprog_tpu_torch.prog.schedule import make_divisible


def new_idx(idx: int, prev_l: int, new_l: int) -> int:
    """Source layer index in the `prev_l`-deep net for layer `idx` of the
    `new_l`-deep net (depth interpolation; reference `prog/helpers.py:254`)."""
    if idx * prev_l // (new_l // prev_l * prev_l) < (prev_l - new_l % prev_l):
        return idx * prev_l // (new_l // prev_l * prev_l)
    return (idx + (prev_l - new_l % prev_l)) * prev_l // (new_l // prev_l * prev_l + prev_l)


def get_new_layer_idx(prev_l: int, new_l: int) -> List[int]:
    """Indices in the `new_l`-deep net that are clones of their predecessor
    (the "new" layers; reference `prog/helpers.py:261`)."""
    return [i for i in range(new_l)
            if new_idx(i, prev_l, new_l) == new_idx(i - 1, prev_l, new_l)]


def depth_source_index(idx: int, prev_l: int, new_l: int) -> int:
    """Source index for remapping: identity when not growing."""
    if new_l <= prev_l:
        return idx
    return new_idx(idx, prev_l, new_l)


def volo_depth_split(l: int) -> Tuple[int, int]:
    """Split total depth l into (outlooker layers l0, transformer layers).

    l0 = make_divisible(0.23*l, 2); mirrors `models/submodels.py:20-25` and
    `models/volo.py:602`. For l <= 2 the reference falls back to (1, 1).
    """
    if l > 2:
        l0 = make_divisible(l * 0.23, 2)
        return l0, l - l0
    return 1, 1


def family_depth_split(l: int, family: str = "volo") -> Tuple[int, ...]:
    """Per-stage depth split for a model family: VOLO's two populated
    stages (outlooker + transformer) or DeiT's single transformer stage.
    The reference only wires its elastic machinery for VOLO
    (`models/volo.py:598-616`); the DeiT path here extends the identical
    rule to single-stage ViTs (blocks named s0b{i}, models/vit.py)."""
    if family == "deit":
        return (l,)
    return volo_depth_split(l)


def elastic_keep_masks(layer_num: int, min_layer_num: int,
                       max_layer_num: int,
                       family: str = "volo") -> Tuple[Tuple[bool, ...], ...]:
    """Per-layer keep masks for a supernet built at `max_layer_num` when
    sampling a sub-network of depth `layer_num`.

    Returns one boolean keep tuple per populated stage (VOLO: two —
    outlooker + transformer; DeiT: one). A False entry means the layer
    runs as identity. Mirrors `VOLO.set_sample_config`
    (`models/volo.py:598-616`): the skip set per stage is the list of
    "new" layers going min->max, minus the last
    (layer_num - min_layer_num) entries which stay active.
    """
    split_s = family_depth_split(layer_num, family)
    split_mn = family_depth_split(min_layer_num, family)
    split_mx = family_depth_split(max_layer_num, family)
    masks = []
    for l_s, l_mn, l_mx in zip(split_s, split_mn, split_mx):
        new_layers = get_new_layer_idx(prev_l=l_mn, new_l=l_mx)
        extra = l_s - l_mn
        skip = new_layers if extra == 0 else new_layers[:-extra] if extra > 0 else new_layers
        if extra < 0:
            raise ValueError(
                f"sampled depth {l_s} below supernet minimum {l_mn}")
        keep = tuple(i not in skip for i in range(l_mx))
        masks.append(keep)
    return tuple(masks)


def full_keep_masks(layer_num: int,
                    family: str = "volo") -> Tuple[Tuple[bool, ...], ...]:
    """Keep masks with every layer active, for a standalone model of depth
    `layer_num`."""
    return tuple(tuple([True] * l)
                 for l in family_depth_split(layer_num, family))


def super_select_indices(base_l: int, super_l: int, target_l: int,
                         family: str = "volo") -> Tuple[List[int], ...]:
    """Which supernet layer indices a shrunk standalone model of depth
    `target_l` takes its weights from, per stage.

    Mirrors `load_super` (`prog/helpers.py:752-785`): the skip set is
    computed from (base_l -> super_l) growth, keeping the last
    (target_l - base_l) new layers.
    """
    split_b = family_depth_split(base_l, family)
    split_s = family_depth_split(super_l, family)
    split_t = family_depth_split(target_l, family)
    out: List[List[int]] = []
    for l_b, l_sup, l_t in zip(split_b, split_s, split_t):
        if l_sup <= l_b:
            out.append(list(range(l_t)))
            continue
        new_layers = get_new_layer_idx(prev_l=l_b, new_l=l_sup)
        extra = l_t - l_b
        if extra > 0:
            skip = new_layers[:-extra]
        elif extra == 0:
            skip = new_layers
        else:
            raise ValueError(f"target depth {l_t} below base {l_b}")
        no_skip = [i for i in range(l_sup) if i not in skip]
        if len(no_skip) != l_t:
            raise AssertionError(f"{len(no_skip)} != {l_t}")
        out.append(no_skip)
    return tuple(out)
