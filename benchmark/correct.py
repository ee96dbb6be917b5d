"""The comparison that decides `correct`.

The program's set-up runs the cell's first `CHECK_STEPS` steps through the window's own
call and feed (`Program.step`, the pool's first batches, rows that all
differ) and keeps, before the window moves the state on:

  * `loss`: each step's loss (across chips, the mean of the ranks' losses);
  * `grad`: each parameter's first gradient as the optimizer got it, worked
    out from AdamW's first moment after one step (m1 = (1 - b1) g1);
  * `delta`: each parameter's change over the first steps (a host copy);
  * `ema`: per EMA decay, each EMA leaf's change over them (host copies).

The reference (`reference/train.py`) runs the same steps from the same
weights and batches in float32. Four numbers are compared, each with a
limit of its own from the cell's file (`limits`):

  * `loss_gap`: the largest |L - L_ref| / |L_ref| over the steps;
  * `grad_gap`: over the leaves, the largest gap between the program's and
    the reference's first-gradient norms, over the larger of the
    reference's norm of that leaf and of the median leaf;
  * `update_gap`, `ema_gap`: the same for the norms of the parameters' and
    the EMA trees' change, taken over the elements whose reference
    gradient is at least a thousandth of the median leaf's RMS gradient.
    An element whose gradient is nought to rounding (a key's bias under
    softmax: the middle third of a qkv bias) moves under Adam by round-off
    alone, differently on each side; a leaf with no such element counts
    whole, one with none counted is left out.

A step that leaves the state unchanged reads 1 on `update_gap`. A limit of
None (JSON null) shows the number beside no limit and leaves it out of the
verdict: a number that neither the control nor a planted fault reads
clearly above the sound runs' readings could only fail sound runs.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence

import torch

#: the steps compared: every limit was set from readings over these three
CHECK_STEPS = 3
#: elements whose reference gradient is under this share of the median
#: leaf's RMS gradient are left out of `update_gap` and `ema_gap`
QUIET = 1e-3
NUMBERS = ("loss_gap", "grad_gap", "update_gap", "ema_gap")


def program_readings(program, batches: Sequence[dict], weights0, beta1: float,
                     mean_over_ranks=None) -> dict:
    """Run the first steps and keep the readings: the losses and gradient
    norms as device tensors (the caller reads them after the window), the
    changes as host copies, taken before the window moves the state on.
    `weights0()` gives the initial weights again; `mean_over_ranks` averages
    the losses across chips."""
    named = list(program.named_parameters())
    names = [n for n, _ in named]
    losses, grad = [], None
    for t, batch in enumerate(batches, start=1):
        losses.append(program.step(batch))
        if t == 1:
            with torch.no_grad():
                grad = torch.stack([program.first_moment(p).float().norm()
                                    for _, p in named]) / (1.0 - beta1)
    with torch.no_grad():
        w0 = weights0()
        delta = {n: (p.detach() - w0[n]).cpu() for n, p in named}
        ema = [{n: (tree[n].float() - w0[n]).cpu() for n in names}
               for tree in program.ema_trees()]
        loss = torch.stack(losses).float()
        if mean_over_ranks is not None:
            loss = mean_over_ranks(loss)
        del w0
    return {"names": names, "loss": loss, "grad": grad, "delta": delta, "ema": ema}


def to_host(readings: dict) -> dict:
    """The readings on the host keyed by leaf name, as the reference gives
    them."""
    names = readings["names"]
    return {"loss": [float(v) for v in readings["loss"]],
            "grad": dict(zip(names, readings["grad"].tolist())),
            "delta": readings["delta"], "ema": readings["ema"]}


def _worst(prog: Dict[str, float], ref: Dict[str, float], names: List[str]):
    med = statistics.median(ref[n] for n in names)
    worst, where = 0.0, None
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med)
        if not math.isfinite(gap):
            return math.inf, n
        if gap > worst:
            worst, where = gap, n
    return worst, where


def _masked_norms(changes: Dict[str, torch.Tensor], masks: Dict[str, torch.Tensor]):
    return {n: float(changes[n][m].norm()) for n, m in masks.items()}


def numbers(prog: dict, ref: dict) -> Dict[str, dict]:
    """The compared numbers: {name: {"value", "leaf"}}. `ref` also holds
    the reference's first gradients (`grad_t`)."""
    out = {}
    loss = max((abs(p - r) / abs(r) if math.isfinite(p) else math.inf)
               for p, r in zip(prog["loss"], ref["loss"]))
    out["loss_gap"] = {"value": loss, "leaf": None}
    names = list(ref["grad"])
    v, leaf = _worst(prog["grad"], ref["grad"], names)
    out["grad_gap"] = {"value": v, "leaf": leaf}
    rms = statistics.median(ref["grad"][n] / math.sqrt(ref["grad_t"][n].numel())
                            for n in names)
    masks = {n: ref["grad_t"][n].abs() >= QUIET * rms for n in names}
    masks = {n: m for n, m in masks.items() if bool(m.any())}
    counted = list(masks)
    v, leaf = _worst(_masked_norms(prog["delta"], masks), _masked_norms(ref["delta"], masks),
                     counted)
    out["update_gap"] = {"value": v, "leaf": leaf}
    worst = (0.0, None)
    for p_tree, r_tree in zip(prog["ema"], ref["ema"]):
        worst = max(worst, _worst(_masked_norms(p_tree, masks), _masked_norms(r_tree, masks),
                                  counted), key=lambda x: x[0])
    out["ema_gap"] = {"value": worst[0], "leaf": worst[1]}
    return out


def judge(nums: Dict[str, dict], limits: Dict[str, float], failed_steps: int) -> dict:
    """{"correct": bool, "checks": {name: {"value", "limit"}}}; every
    number with a limit must be finite and within it, every step's loss
    finite."""
    checks = {}
    ok = failed_steps == 0
    for name in NUMBERS:
        value, limit = nums[name]["value"], limits[name]
        checks[name] = {"value": value, "limit": limit}
        if limit is not None:
            ok = ok and math.isfinite(value) and value <= limit
    checks["nonfinite_steps"] = {"value": failed_steps, "limit": 0}
    return {"correct": ok, "checks": checks}
