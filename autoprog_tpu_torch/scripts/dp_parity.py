"""The data-parallel train step against one process: how close the two come,
over several seeds, and how far a planted fault takes them apart.

    python -m autoprog_tpu_torch.scripts.dp_parity [--seeds 0 1 2] [--out DIR]

For each seed, volo_d1 (random weights from the seed, f32, tf32 off) takes
one train step on `--batch` synthetic token-label images drawn from the
seed, with one fixed MixToken box: once in this process without a process
group, and once on two gloo ranks sharing the card (this script run twice as
`--worker DIR` with torchrun's environment), each rank on its half. The
comparison is `chip_smoke.py` phase 11 (c)'s: the loss, the all-reduced
gradients (|g2 - g1| / |g1| over all of them and per tensor) and the
BatchNorm running stats. Per tensor it reports the worst tensor of the stem
(`patch_embed.stem*`, whose gradients come through BatchNorm's backward) and
the worst of the others.

Each planted fault runs every seed once more on the two ranks, put into
the workers' own process (the code on disk is untouched):
`local-bn-backward` makes `mesh._SumOverRanks.backward` return its gradient
unreduced (each rank's BatchNorm backward sees its own half only), and
`no-grad-all-reduce` skips the gradient all-reduce of the step. The
readings with and without the faults are what phase 11 (c)'s limits
(`RTOL_ALL`, `RTOL_STEM`) are set between; each row says whether it keeps
them.

It also times the flatten of the gradient all-reduce without a group
(`torch.cat` of every gradient and the copy back, CUDA events for the card
and the wall clock for the host).

The table goes to stderr; the last line of stdout is one JSON object with
every reading and the card's name and power limit. On the CPU
(`--device cpu`, a small model such as `--model volo_h2_l4 --img-size 64
--batch 8`) it checks that the script runs; such numbers say nothing of
the card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict

import torch

DECAYS = (0.998, 0.9986, 0.999, 0.9996)
STEM = "patch_embed.stem"
PLANTS = ("local-bn-backward", "no-grad-all-reduce")

#: the limits on |g2 - g1| / |g1| that `chip_smoke.py` phase 11 (c) holds the
#: 2-rank step to: over all gradients and per tensor, the stem's tensors
#: looser. Set between this script's readings on an H100 (seeds 0-2): clean, at
#: most 1.9e-5 over all, 4.4e-4 for a stem tensor and 1.4e-6 for any other;
#: with each rank's BatchNorm backward left local, at least 7.5e-2 over all
#: and 2.7 for the worst stem tensor; with no gradient all-reduce, 0.24 over
#: all and ~1 for every tensor
RTOL_ALL = 1e-4
RTOL_STEM = 5e-3


def box(img_size: int):
    """One MixToken box on the token grid of `img_size` (img_size // 16 a
    side): (3, 2, 10, 9) on volo_d1's 14 x 14 grid."""
    g = img_size // 16
    return torch.tensor((3 * g // 14, 2 * g // 14, 10 * g // 14, 9 * g // 14),
                        dtype=torch.int32)


def setup(batch: int, dtype, *, seed: int = 0, model: str = "volo_d1",
          img_size: int = 224, num_classes: int = 1000, drop_path: float = 0.0,
          device: str = "cuda", bias_std: float = 0.0, opt: str = "adamw",
          opt_eps=None, mu_bf16: bool = False, ema_bf16: bool = False, remat: str = ""):
    """`model` from `seed` with its optimizer, 4 EMAs and its step builder, and a
    synthetic token-label batch of `batch` rows drawn on the host from
    `seed` (the same rows in every process). Rank 0's parameters are
    broadcast under a group; under the grid of `--model-parallel`
    (`mesh.init_grid`) each rank then keeps its shard (`parallel/tp.py`).
    `bias_std` > 0 draws every bias from N(0, bias_std) (the init leaves
    them 0, where a fault in how a bias is added cannot show). The step's
    options: `opt` (`--opt`), `opt_eps`, `mu_bf16` (`--adam-mu-bf16`),
    `ema_bf16` (`--model-ema-bf16`) and `remat` (`--remat`)."""
    from autoprog_tpu_torch import create_model
    from autoprog_tpu_torch.losses import build_train_loss
    from autoprog_tpu_torch.parallel import mesh, tp
    from autoprog_tpu_torch.train.optim import create_optimizer
    from autoprog_tpu_torch.train.state import TrainState
    from autoprog_tpu_torch.train.steps import StepBuilder
    g_side = img_size // 16
    args = argparse.Namespace(opt=opt, opt_betas=None, opt_eps=opt_eps, weight_decay=0.05,
                              momentum=0.9, adam_mu_bf16=mu_bf16, token_label=True,
                              token_label_size=g_side, ground_truth=False, dense_weight=0.5,
                              cls_weight=1.0)
    torch.manual_seed(seed)
    kw = dict(num_classes=num_classes, img_size=img_size, drop_path_rate=drop_path,
              dtype=dtype, remat=remat)
    net = create_model(model).make(**kw)
    if bias_std:
        g = torch.Generator().manual_seed(7 + seed)
        with torch.no_grad():
            for n, p in net.named_parameters():
                if n.endswith("bias"):
                    p.normal_(0.0, bias_std, generator=g)
    net = net.to(device)
    mesh.replicate(net, world=True)
    if mesh.model_count() > 1:
        full = {n: p.detach() for n, p in net.named_parameters()}
        buffers = dict(net.named_buffers())
        net = create_model(model).make(**kw, model_parallel=mesh.model_count()).to(device)
        tp.load_shards(net, full, buffers)
        del full, buffers
    state = TrainState.create(model=net, optimizer=create_optimizer(args, net),
                              ema_decays=DECAYS,
                              ema_dtype=torch.bfloat16 if ema_bf16 else None)
    sb = StepBuilder(train_loss=build_train_loss(args), ema_decays=DECAYS,
                     num_classes=num_classes, token_label=True, has_token_label_data=True,
                     device=torch.device(device), seed=seed, rank=mesh.data_index())
    g = torch.Generator().manual_seed(11 + seed)
    scores = torch.rand(batch, 5, g_side, g_side, generator=g)
    data = {"image": torch.randn(batch, img_size, img_size, 3, generator=g),
            "label": torch.randint(0, num_classes, (batch,), generator=g),
            "label_scores": scores / (scores.sum(1, keepdim=True) * 1.25),
            "label_inds": torch.randint(0, num_classes, (batch, 5, g_side, g_side),
                                        generator=g, dtype=torch.int32)}
    return state, sb, {k: v.to(device) for k, v in data.items()}


def dp_step(state, sb, data, img_size: int = 224):
    """One train step on this process's rows of `data` with the fixed box:
    the loss averaged over the ranks, the gradients the optimizer saw (the
    all-reduced ones under a group) and the BatchNorm running stats."""
    from autoprog_tpu_torch.parallel import mesh
    rows = mesh.process_batch_slice(data["image"].shape[0])
    grads = {}
    optimizer_step = state.optimizer.step

    def step_and_record():
        grads.update({n: p.grad.detach().clone() for n, p in state.model.named_parameters()})
        optimizer_step()
    state.optimizer.step = step_and_record
    m = sb.train_step(state, {k: v[rows] for k, v in data.items()}, 1e-3, r=img_size,
                      bbox=box(img_size))
    state.optimizer.step = optimizer_step
    loss = float(mesh.mean_over_ranks(m["loss"]))
    return loss, grads, {n: b.detach().clone() for n, b in state.model.named_buffers()}


def grad_errors(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]):
    """|got - want| / |want| in the 2-norm over all tensors, and per tensor."""
    diff = {k: (got[k].double().cpu() - w.double().cpu()) for k, w in want.items()}
    total = math.sqrt(sum(float(d.pow(2).sum()) for d in diff.values()) /
                      sum(float(w.double().pow(2).sum()) for w in want.values()))
    per = {k: float(d.norm() / want[k].double().cpu().norm().clamp_min(1e-30))
           for k, d in diff.items()}
    return total, per


def worst(per: Dict[str, float], stem: bool):
    """The tensor with the largest error among the stem's (or the others)."""
    part = {k: v for k, v in per.items() if k.startswith(STEM) == stem}
    k = max(part, key=part.get)
    return k, part[k]


def stat_error(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> float:
    """The largest max |got - want| / (|want| + max |want|) over the stats."""
    out = 0.0
    for k, w in want.items():
        w = w.double().cpu()
        err = (got[k].double().cpu() - w).abs() / (w.abs() + w.abs().max()).clamp_min(1e-30)
        out = max(out, float(err.max()))
    return out


@contextlib.contextmanager
def planted(plant: str):
    """`plant` put into this process's modules for the duration."""
    from autoprog_tpu_torch.parallel import mesh
    if plant == "none":
        yield
        return
    if plant == "local-bn-backward":
        cls, name = mesh._SumOverRanks, "backward"
        fault = staticmethod(lambda ctx, grad: grad.contiguous().clone())
    else:                                   # no-grad-all-reduce
        cls, name = mesh, "all_reduce_grads"
        fault = lambda params: None  # noqa: E731
    saved = cls.__dict__[name]
    setattr(cls, name, fault)
    try:
        yield
    finally:
        setattr(cls, name, saved)


def _device_args(a) -> dict:
    return dict(model=a.model, img_size=a.img_size, num_classes=a.num_classes,
                device=a.device)


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def worker(out_dir: str) -> None:
    """One rank: every (fault, seed) step, rank 0's tensors to `out_dir`."""
    from autoprog_tpu_torch.parallel import mesh
    with open(os.path.join(out_dir, "args.json")) as f:
        a = argparse.Namespace(**json.load(f))
    torch.set_num_threads(1)
    _no_tf32()
    if not mesh.maybe_init_distributed():
        raise SystemExit("the worker found no torchrun environment")
    rank = mesh.process_index()
    for plant in ("none",) + PLANTS:
        for seed in a.seeds:
            state, sb, data = setup(a.batch, torch.float32, seed=seed, **_device_args(a))
            with planted(plant):
                loss, grads, stats = dp_step(state, sb, data, a.img_size)
            if rank == 0:
                torch.save({"loss": loss, "grads": {k: v.cpu() for k, v in grads.items()},
                            "stats": {k: v.cpu() for k, v in stats.items()}},
                           os.path.join(out_dir, f"{plant}_{seed}.pt"))
            del state, sb, data
    mesh.destroy()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(a, out_dir: str):
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   AUTOPROG_DIST_BACKEND="gloo",
                   AUTOPROG_TORCH_DEVICE="cuda:0" if a.device == "cuda" else "cpu")
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "autoprog_tpu_torch.scripts.dp_parity", "--worker",
                 out_dir], env=env, stdout=subprocess.DEVNULL, stderr=err))
    return procs


def _wait(procs, out_dir: str, timeout: float) -> None:
    deadline = time.time() + timeout
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.wait()
            raise SystemExit(f"the 2-rank run did not end within {timeout} s")
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(out_dir, f"rank{rank}.err")) as f:
                raise SystemExit(f"rank {rank} failed ({p.returncode}):\n{f.read()[-4000:]}")


def flatten_times(grads, iters: int = 10) -> Dict[str, float]:
    """The all-reduce's flatten without a group: `torch.cat` of the
    gradients and the copy back into them, on the card (CUDA events) and on
    the host's clock."""
    gs = list(grads.values())

    def cat():
        return torch.cat([t.reshape(-1) for t in gs])

    def back(flat):
        parts = flat.split([t.numel() for t in gs])
        torch._foreach_copy_(gs, [p.view_as(t) for p, t in zip(parts, gs)])
    flat = cat()
    back(flat)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    for _ in range(iters):
        flat = cat()
    ev[1].record()
    for _ in range(iters):
        back(flat)
    ev[2].record()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        back(cat())
    torch.cuda.synchronize()
    return {"values": int(flat.numel()), "cat_ms": ev[0].elapsed_time(ev[1]) / iters,
            "copy_back_ms": ev[1].elapsed_time(ev[2]) / iters,
            "wall_ms": (time.perf_counter() - t0) / iters * 1e3}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--worker", metavar="DIR", help=argparse.SUPPRESS)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--batch", type=int, default=32, help="the global batch")
    p.add_argument("--model", default="volo_d1")
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--out", default="output/dp_parity", help="where summary.json goes")
    p.add_argument("--timeout", type=float, default=600)
    a = p.parse_args(argv)
    if a.worker:
        worker(a.worker)
        return
    if a.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to check the script on the CPU")
    _no_tf32()
    os.makedirs(a.out, exist_ok=True)
    work = tempfile.mkdtemp(prefix="dp_parity_")     # rank 0's gradients, 111 MB a step
    with open(os.path.join(work, "args.json"), "w") as f:
        json.dump({k: v for k, v in vars(a).items() if k != "worker"}, f)
    t0 = time.time()
    procs = _spawn(a, work)
    ref = {}
    for seed in a.seeds:
        state, sb, data = setup(a.batch, torch.float32, seed=seed, **_device_args(a))
        ref[seed] = dp_step(state, sb, data, a.img_size)
        del state, sb, data
    _wait(procs, work, a.timeout)
    rows = []
    for plant in ("none",) + PLANTS:
        for seed in a.seeds:
            two = torch.load(os.path.join(work, f"{plant}_{seed}.pt"))
            loss, grads, stats = ref[seed]
            total, per = grad_errors(two["grads"], grads)
            rows.append({"plant": plant, "seed": seed, "loss_one": loss, "loss_two": two["loss"],
                         "loss_rel": abs(two["loss"] - loss) / abs(loss), "grad_total": total,
                         "worst_stem": worst(per, True), "worst_rest": worst(per, False),
                         "stat_err": stat_error(two["stats"], stats)})
            r = rows[-1]
            r["within"] = (total <= RTOL_ALL and r["worst_stem"][1] <= RTOL_STEM
                           and r["worst_rest"][1] <= RTOL_ALL)
            print(f"{plant:>18} seed {seed}: loss {loss:.7f} / {two['loss']:.7f} (rel "
                  f"{r['loss_rel']:.2e}); gradients over all {total:.2e}; worst stem tensor "
                  f"{r['worst_stem'][0]} {r['worst_stem'][1]:.2e}; worst other "
                  f"{r['worst_rest'][0]} {r['worst_rest'][1]:.2e}; BatchNorm stats "
                  f"{r['stat_err']:.2e}; {'within' if r['within'] else 'BEYOND'} the limits",
                  file=sys.stderr)
    out = {"model": a.model, "img_size": a.img_size, "batch": a.batch, "device": a.device,
           "rows": rows, "wall_s": time.time() - t0}
    if a.device == "cuda":
        out["flatten"] = flatten_times(ref[a.seeds[-1]][1])
        print(f"flatten of {out['flatten']['values']} gradient values: cat "
              f"{out['flatten']['cat_ms']:.3f} ms, copy back {out['flatten']['copy_back_ms']:.3f}"
              f" ms on the card; {out['flatten']['wall_ms']:.3f} ms on the host's clock",
              file=sys.stderr)
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
    shutil.rmtree(work)
    with open(os.path.join(a.out, "summary.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
