"""Per-segment roofline of the volo_d1 train step, counterpart of the JAX
package's `scripts/bench_roofline.py`.

    python -m autoprog_tpu_torch.scripts.bench_roofline [batch]

The step is `bench.py`'s (volo_h12_l18 at 224 px, bf16, token labels,
MixToken, AdamW, 4 EMA decays; its knobs AUTOPROG_BENCH_EMA_BF16 and
AUTOPROG_BENCH_MU_BF16 apply), under each of `bench_parts.py`'s four keep
masks: the full step, without the outlookers, without the transformer
blocks, and with neither. Each is timed (CUDA events around `iters` chained
steps after a warm-up, `bench.time_step`) and, in one step of its own that
is never timed, counted:

  FLOP   `torch.utils.flop_counter`'s formulas (FlopCounterMode's registry)
         for each aten call, split by the dtype of its operands and set
         against the peak of that dtype;
  bytes  every aten call's tensor inputs and outputs (a mutated argument
         of a call that returns nothing counts as written; views, aliases
         and allocations move no data and count nothing; a `_foreach_` call
         counts each tensor of its lists);
  K1, K2 launched through ctypes, where neither count sees them: their
         launches in that step (`ops/attention.SHAPE_LAUNCHES`,
         `ops/outlook_fused.LAUNCHES`) times their work at the step's shapes
         (`scripts/cost.py`, the formula of `chip_smoke.py`'s bound rows).

Each row also splits its counts by the model's top-level child that ran
them, forward and backward (`torch.utils.module_tracker`: the stem
`patch_embed`, the blocks `s0b*` and `s1b*`, `post*`, the heads; the loss,
optimizer and EMA sweeps "outside the model"), and names the aten ops that
moved the most bytes: the split of the "rest" segment.

The FLOP floor is the sum over dtypes of FLOP / peak, the byte floor the
bytes over the HBM rate (the H100's published peaks, `scripts/cost.py`).
The rows give the three segments (`bench_parts.derive`) and the total; each
one's verdict names the floor that binds and how many times it the segment
takes. The full step's MFU is its FLOP over its time over the bf16 peak.
XLA's `cost_analysis()`, which the JAX script reads, has no eager
counterpart; the counts here are of the eager step as it runs, op by op.

The table goes to stderr; the last line of stdout is one JSON object with
the rows, the segments, the full step's img/s and MFU, the kernels'
launches over the run, and the card's name and power limit. With
AUTOPROG_TORCH_DEVICE=cpu (the tests) it runs one step a row at batch 2;
the counts are the CPU step's and the times say nothing of the card.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import sys
from typing import Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from autoprog_tpu_torch.scripts import cost


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class WorkCounter(TorchDispatchMode):
    """FLOP by operand dtype and bytes moved, over every aten call made
    under it (forward, backward and optimizer alike), also by aten op
    (`by_op`: bytes) and, given a `torch.utils.module_tracker.ModuleTracker`
    entered around the same calls, by the model's top-level child that was
    running, forward or backward (`by_part`: [bytes, FLOP]; children that
    differ only by their index are one part, "s1b*"; calls outside the
    model's forward and backward, the loss, optimizer and EMA sweeps, are
    "outside the model")."""

    def __init__(self, tracker=None):
        super().__init__()
        self.flops: Dict[str, float] = collections.Counter()
        self.bytes = 0
        self.by_op: Dict[str, int] = collections.Counter()
        self.by_part: Dict[str, list] = collections.defaultdict(lambda: [0, 0.0])
        self.tracker = tracker

    def _part(self) -> str:
        children = [p for p in self.tracker.parents if p.count(".") == 1]
        if children:
            return re.sub(r"\d+$", "*", children[0].split(".")[1])
        return "model (own ops)" if len(self.tracker.parents) > 1 else "outside the model"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        packet = func._overloadpacket
        flops = 0
        if packet in flop_registry:
            dtype = next((t.dtype for t in ins if t.is_floating_point()), torch.float32)
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops[str(dtype).replace("torch.", "")] += flops
        nbytes = call_bytes(func, args, kwargs, out)
        self.bytes += nbytes
        self.by_op[packet.__name__] += nbytes
        if self.tracker is not None:
            part = self.by_part[self._part()]
            part[0] += nbytes
            part[1] += flops
        return out


def call_bytes(func, args, kwargs, out) -> int:
    """Bytes one aten call moves: its tensor inputs read and its outputs
    written once. A call that returns nothing (an in-place `_foreach_` call)
    writes its mutated arguments; a view or alias (nothing mutated, every
    output on an input's storage) and an allocation (`empty*`) move
    nothing."""
    schema = func._schema
    if schema.name.split("::")[-1].startswith(("empty", "new_empty")):
        return 0
    ins, outs = _tensors((args, kwargs)), _tensors(out)
    if not schema.is_mutable and outs:
        storages = {t.untyped_storage().data_ptr() for t in ins}
        if all(t.untyped_storage().data_ptr() in storages for t in outs):
            return 0
    if not outs:
        for i, arg in enumerate(schema.arguments):
            if arg.alias_info is not None and arg.alias_info.is_write:
                outs += _tensors(args[i] if i < len(args) else kwargs.get(arg.name))
    return _nbytes(ins) + _nbytes(outs)


def kernel_work(batch: int, k1_launches, k2_launches: Dict[str, int], k2_shapes,
                item: int, dtype: str) -> Dict[str, Dict[str, float]]:
    """{kernel side: {"launches", "flops", "bytes", "dtype"}} of K1 and K2
    in one counted step: K1's launches by (side, tokens, heads, head_dim) at
    the step's batch, K2's at the one outlooker map the step ran (B, H, W, C,
    heads), each times its work (`scripts/cost.py`). K2's arithmetic is f32
    whatever its operands' type, as its bound counts it."""
    work = {}
    for (side, n, heads, d), count in sorted(k1_launches.items()):
        flops, nbytes = cost.k1_work(side, batch, n, heads, d, item)
        w = work.setdefault(f"K1 {side}", {"launches": 0, "flops": 0.0, "bytes": 0.0,
                                            "dtype": dtype})
        w["launches"] += count
        w["flops"] += count * flops
        w["bytes"] += count * nbytes
    if any(k2_launches.values()):
        if len(k2_shapes) != 1:
            raise RuntimeError(f"K2 ran at {len(k2_shapes)} maps in one step: {k2_shapes}")
        (shape,) = k2_shapes
        for side in ("fwd", "bwd"):
            flops, nbytes = cost.k2_work(side, *shape, item)
            work[f"K2 {side}"] = {"launches": k2_launches[side],
                                  "flops": k2_launches[side] * flops,
                                  "bytes": k2_launches[side] * nbytes, "dtype": "float32"}
    return work


def count_step(step, model, batch: int) -> Dict:
    """One call of `step` (a train step at `batch` of `model`) under
    `WorkCounter`, with K1's and K2's launches in it and the maps the outlook
    attention ran at: {"flops": {dtype: FLOP}, "bytes", "kernels":
    `kernel_work`, "by_part": {part: {"bytes", "flops"}}, "top_ops": the 12
    aten ops that moved the most bytes}."""
    from torch.utils.module_tracker import ModuleTracker
    from autoprog_tpu_torch.models.layers import OutlookAttention
    from autoprog_tpu_torch.ops import attention as A
    from autoprog_tpu_torch.ops import outlook_fused as O
    k1_before = collections.Counter(A.SHAPE_LAUNCHES)
    k2_before = dict(O.LAUNCHES)
    maps, hooks = set(), []
    for m in model.modules():
        if isinstance(m, OutlookAttention):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, inp: maps.add((*inp[0].shape[:3], mod.num_heads * mod.head_dim,
                                           mod.num_heads))))
    try:
        with ModuleTracker() as tracker, WorkCounter(tracker) as counter:
            step()
    finally:
        for h in hooks:
            h.remove()
    k1 = collections.Counter(A.SHAPE_LAUNCHES)
    k1.subtract(k1_before)
    k2 = {side: O.LAUNCHES[side] - k2_before[side] for side in ("fwd", "bwd")}
    item = torch.empty((), dtype=model.dtype).element_size()
    return {"flops": dict(counter.flops), "bytes": counter.bytes,
            "kernels": kernel_work(batch, {k: v for k, v in k1.items() if v}, k2, maps, item,
                                   str(model.dtype).replace("torch.", "")),
            "by_part": {k: {"bytes": b, "flops": f} for k, (b, f) in
                        sorted(counter.by_part.items(), key=lambda kv: -kv[1][0])},
            "top_ops": dict(counter.by_op.most_common(12))}


def floors(flops: Dict[str, float], nbytes: float) -> Tuple[float, float]:
    """(FLOP floor ms, byte floor ms) at the card's peaks."""
    unknown = set(flops) - set(cost.PEAKS)
    if unknown:
        raise KeyError(f"no peak for FLOP of dtype {sorted(unknown)}")
    return (sum(f / cost.PEAKS[dt] for dt, f in flops.items()) * 1e3,
            nbytes / cost.HBM_BPS * 1e3)


def verdict(ms: float, flop_floor: float, byte_floor: float) -> Dict:
    binding = max(flop_floor, byte_floor)
    return {"bound_by": "operations" if flop_floor >= byte_floor else "bytes",
            "floor_share": binding / ms if ms > 0 else float("inf"),
            "times_floor": ms / binding if binding > 0 else float("inf")}


def main(argv=None) -> Dict:
    from autoprog_tpu_torch import bench
    from autoprog_tpu_torch.platform import default_device
    from autoprog_tpu_torch.scripts import bench_parts
    from autoprog_tpu_torch.ops import launch_counts, launches_since
    from autoprog_tpu_torch.scripts.timing import card_name

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=None)
    opts = p.parse_args(argv)
    device = default_device()
    on_card = device.type == "cuda"
    batch = opts.batch or (128 if on_card else 2)
    iters, warmup = (20, 3) if on_card else (1, 0)
    sb, state, data = bench.make_step(device, batch)
    lr, r = 1.6e-3, bench.IMG_SIZE
    start = launch_counts()
    rows = {}
    for name, keep in bench_parts.keep_masks(state.model).items():
        ms = bench.time_step(sb, state, data, lr, r=r, keep=keep, iters=iters,
                             warmup=warmup) * 1e3
        counted = count_step(lambda: sb.train_step(state, data, lr, r=r, keep=keep),
                             state.model, batch)
        flops = collections.Counter(counted["flops"])
        nbytes = counted["bytes"]
        for w in counted["kernels"].values():
            flops[w["dtype"]] += w["flops"]
            nbytes += w["bytes"]
        flop_floor, byte_floor = floors(flops, nbytes)
        rows[name] = {"ms": ms, "flops": sum(flops.values()), "bytes": nbytes,
                      "flops_by_dtype": dict(flops), "flop_floor_ms": flop_floor,
                      "byte_floor_ms": byte_floor, "kernels": counted["kernels"],
                      "by_part": counted["by_part"], "top_ops": counted["top_ops"]}
    segments = {}
    for key in ("ms", "flops", "bytes", "flop_floor_ms", "byte_floor_ms"):
        for name, value in bench_parts.derive({n: row[key] for n, row in rows.items()}).items():
            segments.setdefault(name, {})[key] = value
    segments["TOTAL full step"] = {k: rows["full step"][k] for k in
                                   ("ms", "flops", "bytes", "flop_floor_ms", "byte_floor_ms")}
    for table in (rows, segments):
        for row in table.values():
            row.update(verdict(row["ms"], row["flop_floor_ms"], row["byte_floor_ms"]))
    full = rows["full step"]
    img_s = batch / (full["ms"] / 1e3)
    mfu = full["flops"] / (full["ms"] / 1e3) / cost.BF16_FLOPS
    card = card_name(device)
    print(f"b={batch} img={r} {bench.MODEL} train step (fwd+bwd+adamw+4ema, token-label) "
          f"on {card}", file=sys.stderr)
    print(f"{'row / segment':<48}{'ms':>9}{'GFLOP':>10}{'GB':>8}{'flop-floor':>11}"
          f"{'byte-floor':>11}  verdict", file=sys.stderr)
    for table in (rows, segments):
        for name, s in table.items():
            print(f"{name:<48}{s['ms']:9.3f}{s['flops'] / 1e9:10.1f}{s['bytes'] / 1e9:8.2f}"
                  f"{s['flop_floor_ms']:11.3f}{s['byte_floor_ms']:11.3f}  {s['bound_by']}-bound "
                  f"floor; {s['times_floor']:.1f}x above it", file=sys.stderr)
    print(f"full step: {img_s:.1f} img/s, {full['flops'] / 1e12:.3f} TFLOP, MFU "
          f"{100 * mfu:.2f}% of the bf16 peak", file=sys.stderr)
    for name in ("stem+post+heads+opt only", "full step"):
        row = rows[name]
        print(f"{name} by part (GB, GFLOP, byte floor ms): " + "; ".join(
            f"{part} {w['bytes'] / 1e9:.2f}, {w['flops'] / 1e9:.1f}, "
            f"{w['bytes'] / cost.HBM_BPS * 1e3:.2f}" for part, w in row["by_part"].items())
            + "; " + "; ".join(f"{k} {w['bytes'] / 1e9:.2f}, {w['flops'] / 1e9:.1f}"
                               for k, w in row["kernels"].items()), file=sys.stderr)
        print(f"{name} top ops by GB: " + ", ".join(
            f"{op} {b / 1e9:.2f}" for op, b in row["top_ops"].items()), file=sys.stderr)
    launches = launches_since(start)
    result = {"metric": "volo_d1_train_step_roofline", "batch": batch, "img_size": r,
              "card": card, "peaks": {"hbm_bytes_per_s": cost.HBM_BPS, "flops": cost.PEAKS},
              "rows": rows, "segments": segments, "img_per_s": img_s, "mfu": mfu,
              "launches": launches}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
