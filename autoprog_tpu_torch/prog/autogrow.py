"""AutoProg sub-network search ("auto grow"), counterpart of
`autoprog_tpu/prog/autogrow.py`.

At a stage boundary the engine grows a weight-shared elastic supernet to the
largest candidate, trains it for `search_epochs` while sampling a random
(layer-count, resolution) sub-network per batch, probes each candidate's
training loss (on EMA[0]) and per-step time, and picks the candidate that
minimises `mean_loss * step_time^w`, with `w` fitted on the fly by a
power-law `curve_fit` (host-side scipy).

`candidate_window`, `fit_time_exponent`, `score_candidates` and `parse_cfg`
are host code, copied unchanged. The rest is ported:
  * a candidate (r, l) is a resolution and a static keep mask passed to the
    eager train step; there is nothing to compile, so the JAX package's
    ahead-of-time warm-up of every candidate program has no counterpart
    here and is left out;
  * sampling uses `np.random.RandomState(epoch)` and draws l before r, as
    the JAX package does, so both walk the same sequence;
  * the step time is `iters` forward + backward steps between two CUDA
    events after a warm-up step (`train/steps.py:chained_throughput_probe`);
  * per-batch losses stay on the device and are read once per log interval
    (averaged over the ranks under a process group); AUTOPROG_SYNC_SEARCH=1
    reads each probe step's loss and each supernet step's loss to the host
    as it comes, as the JAX package's switch does, only so that the cost of
    those reads can be measured (`scripts/ab_search_sync.py`);
  * `sync_decision` broadcasts rank 0's decision under a process group
    (`parallel/mesh.py`); every rank draws the same candidates from the same
    `RandomState(epoch)`, and the probes' times stay per rank until then.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from autoprog_tpu_torch.parallel import mesh
from autoprog_tpu_torch.prog.depth import elastic_keep_masks
from autoprog_tpu_torch.prog.schedule import no_repeats
from autoprog_tpu_torch.utils.meters import AverageMeter, SmoothMeter

_logger = logging.getLogger("autoprog_tpu_torch.autogrow")


# ------------------------- candidate windowing ----------------------------


def candidate_window(r_list, h_list, l_list, current_r, current_h, current_l,
                     stage: int) -> Tuple[List[int], List[int], List[int]]:
    """Search window at a stage boundary (`main_prog.py:792-803`):
    stage 0 searches {min, mid, max} of r and l; later stages search a
    sliding window of <=2 resolutions x <=3 depths above the current
    config."""
    r_u, h_u, l_u = no_repeats(r_list), no_repeats(h_list), no_repeats(l_list)
    if stage > 0:
        r_s, h_s, l_s = r_u.index(current_r), h_u.index(current_h), \
            l_u.index(current_l)
        if l_s < len(l_u) - 1:
            l_s += 1
        r_e = min(r_s + 2, len(r_u))
        h_e = min(h_s + 3, len(h_u))
        l_e = min(l_s + 3, len(l_u))
        return r_u[r_s:r_e], h_u[h_s:h_e], l_u[l_s:l_e]
    return ([r_u[0], r_u[len(r_u) // 2], r_u[-1]], h_u,
            [l_u[0], l_u[len(l_u) // 2], l_u[-1]])


# ------------------------- scoring ----------------------------------------


def fit_time_exponent(times: Sequence[float], losses: Sequence[float]
                      ) -> float:
    """Fit loss ~ a2 * time^a1 and return w = max(-a1, 0)
    (`main_prog.py:1741-1747`)."""
    from scipy.optimize import curve_fit

    def _curve(x, a1, a2):
        return a2 * np.power(x, a1)

    try:
        para, _ = curve_fit(_curve, np.asarray(times, float),
                            np.asarray(losses, float), maxfev=10000)
        return float(max(-para[0], 0.0))
    except Exception as e:  # singular fits on degenerate inputs
        _logger.warning("curve_fit failed (%s); using w=0", e)
        return 0.0


def score_candidates(search_metrics: List[Dict[str, Dict[str, float]]],
                     cfg_strs: Sequence[str], stage: int
                     ) -> Tuple[str, Dict[str, float]]:
    """Convergence-speed criterion (`main_prog.py:1698-1819`).

    search_metrics: one dict per probe round, cfg -> {'loss', 'time'}
    ('time' present in round 0 only). Returns (best_cfg, table).
    """
    n = len(search_metrics)
    taylor0, time_d = {}, {}
    extras: Dict[str, Dict[str, float]] = {}
    for cfg in cfg_strs:
        losses = [search_metrics[i][cfg]["loss"] for i in range(n)]
        taylor0[cfg] = sum(losses) / len(losses)
        time_d[cfg] = search_metrics[0][cfg]["time"]
        if n > 3:
            t = 1.0 / n
            delta = losses[-1] - losses[0]
            delta2 = ((losses[-1] - losses[-2]) -
                      (losses[1] - losses[0])) / ((n - 1) * t)
            delta3 = (((losses[-1] - losses[-2]) - (losses[-2] - losses[-3]))
                      / t - ((losses[2] - losses[1]) -
                             (losses[1] - losses[0])) / t) / ((n - 2) * t)
            extras[cfg] = dict(
                delta=delta, delta2=delta2, delta3=delta3,
                taylor1=taylor0[cfg] + delta * 18,
                taylor2=taylor0[cfg] + delta * 18 + delta2 * 18 ** 2 / 2,
            )
    if extras:
        # log the taylor extrapolation diagnostics as the reference does
        # (`main_prog.py:1698-1730`); they inform log readers, not the
        # argmin (parity: the reference's criterion also uses taylor0)
        for name in ("delta", "delta2", "delta3", "taylor1", "taylor2"):
            _logger.info("search %s: %s", name,
                         "; ".join(f"{c}: {extras[c][name]:.4f}"
                                   for c in cfg_strs))
    w = fit_time_exponent([time_d[c] for c in cfg_strs],
                          [taylor0[c] for c in cfg_strs])
    converge = {c: taylor0[c] * time_d[c] ** w for c in cfg_strs}
    # The reference multiplies a *constant* repetition regularizer
    # (18/15)^0.3 into every candidate for stage>0 (`main_prog.py:1760-1766`)
    # — it cannot change the argmin; kept for log parity only.
    reg = (18 / 15) ** 0.3 if stage > 0 else 1.0
    table = {c: converge[c] * reg for c in cfg_strs}
    best = min(cfg_strs, key=lambda c: table[c])
    _logger.info("search w=%.4f  converge-speed: %s", w,
                 "; ".join(f"{c}: {table[c]:.4f}" for c in
                           sorted(cfg_strs, key=lambda c: table[c])))
    return best, table


def parse_cfg(cfg: str) -> Tuple[int, int]:
    r, l = cfg.split("_")
    return int(r.lstrip("r")), int(l.lstrip("l"))


# ------------------------- probes ------------------------------------------


def take_probe_batches(ctx, loader_search, total_steps: int) -> List:
    """Materialise `total_steps` fixed-aug probe batches once per search
    epoch, on the device, then shut the loader's worker pool down.

    A list and not a live loader: every candidate and every probe round
    scores against the identical batches, and an abandoned mid-epoch
    iterator would keep its pool grinding the whole epoch in the
    background. A search split shorter than the budget wraps around."""
    from autoprog_tpu_torch.engine import to_device
    loader_search.set_epoch(0)
    batches = []
    it = iter(loader_search)
    while len(batches) < total_steps:
        try:
            batches.append(to_device(next(it), ctx.device))
        except StopIteration:
            if not batches:
                break  # the search split is empty; raised below
            it = iter(loader_search)
    close = getattr(loader_search, "close", None)
    if close is not None:
        close()  # stop the pool from finishing the abandoned epoch
    if not batches:
        raise RuntimeError(
            "search loader yielded no probe batches: the search split is "
            "empty (dataset smaller than one batch?); cannot score candidates")
    return batches


def probe_candidate(ctx, batches: Sequence, *, r: int, keep, params,
                    with_time: bool = False) -> Dict[str, float]:
    """Loss (and optionally step-time) probe over the fixed probe batches.
    Every candidate draws its DropPath masks and MixToken boxes from
    generators seeded alike, and the loss sum stays on the device: one host
    read per probe (one per step under AUTOPROG_SYNC_SEARCH=1, which sums
    the losses in float64 on the host)."""
    if not batches:
        raise ValueError("probe_candidate called with no probe batches")
    _logger.info("probe r%d keep=%s: loss probe (first dispatch compiles)",
                 r, "full" if keep is None else sum(sum(k) for k in keep))
    sync = os.environ.get("AUTOPROG_SYNC_SEARCH") == "1"
    seed = ctx.args.seed + 4242
    drop_gen = torch.Generator(ctx.device).manual_seed(seed)
    mix_gen = torch.Generator("cpu").manual_seed(seed + 1)
    loss_sum = None
    n = 0
    for batch in batches:
        loss = ctx.sb.loss_probe_step(ctx.state, batch, r=r, keep=keep, params=params,
                                      drop_gen=drop_gen, mix_gen=mix_gen)
        if sync:
            loss = float(loss)
        # sample-weighted so that a short final batch does not skew the mean
        bs = int(batch["image"].shape[0])
        loss_sum = loss * bs if loss_sum is None else loss_sum + loss * bs
        n += bs
    out = {"loss": float(loss_sum) / n}
    if with_time:
        iters = int(getattr(ctx.args, "search_time_iters", 10))
        _logger.info("probe r%d: chained time probe (compile+warm)", r)
        out["time"] = ctx.sb.chained_throughput_probe(
            ctx.state, batches[0], r=r, keep=keep, iters=iters, params=params,
            drop_gen=drop_gen, mix_gen=mix_gen)
    return out


# ------------------------- supernet epoch ----------------------------------


def train_one_epoch_super(ctx, epoch: int, loader, loader_search, *,
                          r_list: Sequence[int], l_list: Sequence[int],
                          cfg_strs: Sequence[str], splits: int, eval_times: int,
                          epoch_time_m: Optional[AverageMeter] = None,
                          re_prob: float = 0.0):
    """One supernet epoch with random sub-network sampling. Returns
    (train_metrics, search_metrics_rounds, loss_0, loss_last)."""
    from autoprog_tpu_torch.engine import device_re_prob, epoch_batches, to_device
    args = ctx.args
    device_re = device_re_prob(args, re_prob)
    sampler = np.random.RandomState(epoch)
    l_min, l_max = l_list[0], l_list[-1]
    fam = getattr(ctx.mdef.arch, "family", "volo")
    keep_of = {l: elastic_keep_masks(l, l_min, l_max, fam) for l in l_list}
    lr = ctx.schedule.fn(epoch)
    loader.set_epoch(epoch)
    losses_m = [[SmoothMeter() for _ in l_list] for _ in r_list]
    batch_time = AverageMeter()

    def probe_params():
        return ctx.state.ema_params[0] if ctx.state.ema_params else None

    def probe_round(with_time: bool):
        rnd = {}
        for cfg in cfg_strs:
            r_c, l_c = parse_cfg(cfg)
            rnd[cfg] = probe_candidate(ctx, probe_batches, r=r_c, keep=keep_of[l_c],
                                       params=probe_params(), with_time=with_time)
        return rnd

    # fixed probe batches, materialised once and reused by every candidate
    # and every probe round
    probe_batches = take_probe_batches(ctx, loader_search,
                                       getattr(args, "search_probe_steps", 50))
    _logger.info("search: %d probe batches materialized; round-0 probes for %s",
                 len(probe_batches), list(cfg_strs))
    # round 0: per-candidate loss + the step time that feeds the criterion
    search_rounds: List[Dict[str, Dict[str, float]]] = [probe_round(True)]

    nb, batches = epoch_batches(loader)
    eval_steps = [nb // eval_times * i for i in range(1, eval_times)] + \
        [nb - 1] if eval_times else []
    loss_0, loss_last = {}, {}
    end = time.time()
    pending: List[Tuple[int, int, torch.Tensor]] = []
    sync = os.environ.get("AUTOPROG_SYNC_SEARCH") == "1"

    def drain():
        if not pending:
            return
        vals = mesh.mean_over_ranks(torch.stack([v for _, _, v in pending])).cpu().tolist()
        for (i_r, i_l, _), v in zip(pending, vals):
            losses_m[i_r][i_l].update(float(v))
        pending.clear()

    def grid_of(fmt):
        return {f"r{i}_l{j}": fmt(losses_m[i][j].avg)
                for j in range(len(l_list)) for i in range(len(r_list))}

    for batch_idx, batch in batches:
        l = int(sampler.choice(l_list))     # l before r, as the reference draws
        r = int(sampler.choice(r_list))
        metrics = ctx.sb.train_step(ctx.state, to_device(batch, ctx.device), lr, r=r,
                                    keep=keep_of[l], splits=splits, re_prob=device_re)
        pending.append((r_list.index(r), l_list.index(l), metrics["loss"]))
        if sync:
            drain()
        batch_time.update(time.time() - end)

        if batch_idx % args.log_interval == 0 or batch_idx == nb - 1 or \
                batch_idx == 49 or batch_idx in eval_steps:
            drain()
        if batch_idx % args.log_interval == 0 or batch_idx == nb - 1:
            grid = "; ".join(f"{k}: {v}" for k, v in grid_of(lambda x: f"{x:.4f}").items())
            _logger.info("TrainSuper: %d [%4d/%d] sampled r%d l%d  All Loss: %s",
                         epoch, batch_idx, nb, r, l, grid)
        if batch_idx == 49:
            loss_0 = grid_of(lambda x: round(x, 4))
        if batch_idx == nb - 1:
            loss_last = grid_of(lambda x: round(x, 4))
        if batch_idx in eval_steps:
            search_rounds.append(probe_round(False))
        end = time.time()
    drain()
    if nb < len(loader):
        loader.close()
    if epoch_time_m is not None:
        epoch_time_m.update(batch_time.sum)
    train_metrics = {"loss": losses_m[0][0].avg, "step_time": batch_time.avg}
    return train_metrics, search_rounds, loss_0, loss_last


# ------------------------- top-level search --------------------------------


def sync_decision(best_r: int, best_l: int) -> Tuple[int, int]:
    """The grow decision every process follows: rank 0's, broadcast under a
    process group (each rank timed its own probes); the identity in one
    process."""
    if mesh.process_group_active():
        best_r, best_l = mesh.broadcast_ints([best_r, best_l])
    return best_r, best_l
