"""The tensor-parallel train step against one process: how close the two
come, and how far a planted fault takes them apart.

    python -m autoprog_tpu_torch.scripts.tp_parity [--seeds 0] [--out DIR]

For each seed, volo_d1 (random weights from the seed, the biases drawn from
N(0, 0.02) rather than left at 0, f32, tf32 off) takes
one train step on `--batch` synthetic token-label images drawn from the seed,
with one fixed MixToken box (`scripts/dp_parity.py`'s setup and step): once
in this process without a process group, and once on two gloo ranks of one
model group (`--model-parallel 2`: each rank holds half of every block's
heads and hidden units and sees the whole batch; this script run twice as
`--worker DIR` with torchrun's environment). The comparison is the loss and
every gradient leaf, gathered over the model group, relative to its norm;
each leaf's error is printed, and the worst of each family: `column` (the
column-parallel kernels and biases: qkv, kv, q, v, attn, fc1), `row` (the
row-parallel kernels, proj and fc2), `block` (the replicated leaves of the
blocks: norms, the row-parallel biases), `stem` (`patch_embed.stem*`, whose
gradients come through BatchNorm's backward) and `other` (embeddings,
heads, downsamples).

Each planted fault runs every seed once more on the two ranks, put into the
workers' own process (the code on disk is untouched): `no-row-reduce` makes
`tp.reduce_from_model` return its input (each rank's row-parallel layers
keep their partial product), and `bias-every-rank` adds the row-parallel
bias to every rank's partial product before the reduce (so M times). The
readings with and without the faults are what the limits below are set
between; each row says whether it keeps them. `chip_smoke.py` phase 12 (a)
and `tests/test_torch_tp.py` hold the step to them.

The module also runs and holds the step's options under the grid for
`chip_smoke.py` phase 12 (f) and tests/test_torch_tp.py: `leg_steps` records
a few steps' losses, gradients, parameters, optimizer state and EMA trees,
gathered; `mu_bf16_bounds` and `ema_bf16_steps` hold the bf16 first moment
(`--adam-mu-bf16`) and the bf16 EMA trees (`--model-ema-bf16`) to what one
rounding apart allows.

The table goes to stderr; the last line of stdout is one JSON object with
every reading (and, on the card, its name and power limit). On the CPU
(`--device cpu`, a small model such as `--model volo_h4_l4 --img-size 64
--batch 8`) it checks that the script runs; such numbers say nothing of the
card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict

import torch

from autoprog_tpu_torch.scripts import dp_parity

PLANTS = ("no-row-reduce", "bias-every-rank")
FAMILIES = ("column", "row", "block", "stem", "other")

#: the limits that `chip_smoke.py` phase 12 (a) holds the 2-rank f32 step
#: to: the loss relative to one process's, every gradient leaf relative to its
#: norm (the stem's looser: cancellation in BatchNorm's backward), and all
#: leaves together. Set between this script's readings on an H100 (volo_d1,
#: seeds 0-2): clean, the loss equal, at most 9.5e-7 over all, 8.7e-7 for a
#: leaf outside the stem and 1.9e-5 in it; with either fault, at least 6.3e-5
#: on the loss, 0.30 over all and 0.28 on the worst leaf of every family
RTOL_LOSS = 1e-5
RTOL_ALL = 1e-4
RTOL_LEAF = 1e-3
RTOL_STEM = 5e-3


def family(name: str, t: torch.Tensor) -> str:
    """The leaf family of a parameter (see the module docstring)."""
    from autoprog_tpu_torch.parallel import tp
    if name.startswith(dp_parity.STEM):
        return "stem"
    spec = tp.param_spec(name, t.ndim)
    if spec is not None:
        return "column" if spec[0] == 0 else "row"
    head = name.split(".")[0]
    if head.startswith("post") or (head.startswith("s") and "b" in head):
        return "block"
    return "other"


def worst_by_family(per: Dict[str, float], grads: Dict[str, torch.Tensor]):
    """{family: (leaf, error)} of the largest error in each family."""
    out = {}
    for k, v in per.items():
        f = family(k, grads[k])
        if f not in out or v > out[f][1]:
            out[f] = (k, v)
    return out


def within(row) -> bool:
    """Whether a reading keeps every limit."""
    fam = row["worst"]
    return (row["loss_rel"] <= RTOL_LOSS and row["grad_total"] <= RTOL_ALL
            and all(v[1] <= (RTOL_STEM if f == "stem" else RTOL_LEAF)
                    for f, v in fam.items()))


def tp_step(state, sb, data, img_size: int = 224):
    """`dp_parity.dp_step` under the grid: the loss, the full gradients
    (gathered over the model group: every rank of it must call this) and the
    BatchNorm stats."""
    from autoprog_tpu_torch.parallel import tp
    loss, grads, stats = dp_parity.dp_step(state, sb, data, img_size)
    return loss, tp.gather_local(grads), stats


def gathered(tree) -> Dict[str, torch.Tensor]:
    """`tp.gather_local(tree)` copied to the host (every rank of the model
    group must call it; at M = 1 it is a copy of the tree itself)."""
    from autoprog_tpu_torch.parallel import tp
    return {k: v.detach().to("cpu", copy=True) for k, v in tp.gather_local(tree).items()}


def optimizer_by_name(state) -> Dict[str, Dict[str, torch.Tensor]]:
    """The optimizer's per-parameter tensors (moments, momentum buffers),
    full and on the host, by parameter name (a collective over the model
    group, as `gathered`)."""
    from autoprog_tpu_torch.parallel import tp
    names = tp._param_names(state.model, state.optimizer)
    saved = tp.gather_optimizer_state(state.model, state.optimizer)
    return {names[i]: {k: v.detach().to("cpu", copy=True) for k, v in st.items()
                       if torch.is_tensor(v) and v.ndim}
            for i, st in saved["state"].items()}


#: what `leg_steps` records after each step
RECORD = ("grads", "params", "opt", "ema")


def leg_steps(state, sb, batches, *, img_size: int, bbox, lr: float = 1e-3,
              splits: int = 1, sparse: bool = False, keys=RECORD):
    """One train step per batch of `batches` on this process's rows of it,
    with the MixToken box `bbox`, in `splits` micro-batches, with sparse
    token-label targets (AUTOPROG_SPARSE_TL=1) where `sparse`. Per step:
    the loss averaged over the ranks and, of `keys`, the gradients the
    optimizer saw, the parameters, the optimizer state by name and the EMA
    trees after the step, gathered over the model group and on the host
    (every rank of the group must call this)."""
    from autoprog_tpu_torch.parallel import mesh
    steps, grads = [], {}
    optimizer_step = state.optimizer.step

    def record():
        if "grads" in keys:
            grads.update(gathered({n: p.grad for n, p in state.model.named_parameters()}))
        optimizer_step()
    state.optimizer.step = record
    env = os.environ.get("AUTOPROG_SPARSE_TL")
    os.environ["AUTOPROG_SPARSE_TL"] = "1" if sparse else "0"
    try:
        for batch in batches:
            rows = mesh.process_batch_slice(batch["image"].shape[0])
            m = sb.train_step(state, {k: v[rows] for k, v in batch.items()}, lr, r=img_size,
                              bbox=bbox, splits=splits)
            rec = {"loss": float(mesh.mean_over_ranks(m["loss"]))}
            if "grads" in keys:
                rec["grads"] = dict(grads)
            if "params" in keys:
                rec["params"] = gathered(state.params)
            if "opt" in keys:
                rec["opt"] = optimizer_by_name(state)
            if "ema" in keys:
                rec["ema"] = [gathered(e) for e in state.ema_params]
            steps.append(rec)
    finally:
        state.optimizer.step = optimizer_step
        if env is None:
            del os.environ["AUTOPROG_SPARSE_TL"]
        else:
            os.environ["AUTOPROG_SPARSE_TL"] = env
    return steps


def bf16_steps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in bf16 steps, elementwise: the distance between the ordered
    bit patterns of two bf16 tensors (0 where equal, 1 for neighbours)."""
    def key(t):
        v = t.contiguous().view(torch.int16).int()
        return torch.where(v < 0, -(v & 0x7FFF), v)
    return (key(a) - key(b)).abs()


def bf16_spacing(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """The step of a float with `bits` significant bits at |x| (bf16: 8,
    f32: 24): 2^(floor(log2 |x|) + 1 - bits), elementwise."""
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                       torch.frexp(x.float())[1] - bits)


def mu_bf16_bounds(two, one, *, lr: float, eps: float, betas=(0.9, 0.999),
                   atol: float = 1e-6) -> dict:
    """Two AdamW steps with the first moment stored in bf16 (`--adam-mu-bf16`,
    rounded to nearest), `leg_steps`' records at M = 2 (`two`) and of one
    process (`one`), held element by element to the bounds that one flipped
    rounding gives. Step 1 updates from the f32 moment; its stored m1 may
    land on the other bf16 neighbour: |dm1| <= (1 - b1) |dg1| + one spacing
    of m1. Step 2 starts from m1: m32 = (1 - b1) g2 + bf16(b1 m1) (the
    product rounded in bf16, as optax does), so where m1 differs, |dm32| <=
    dmu = b1 |dm1| + one spacing of b1 m1 beyond (1 - b1) |dg2| and the f32
    roundings of (1 - b1) g2 (one f32 step at its size: the two terms can
    cancel to far below it); the stored |dm2| <= that + one bf16 spacing of
    m2; and the parameters
    move apart by at most atol + lr dmu / (bc1 (sqrt(v2 / bc2) + eps)),
    bc_t = 1 - b^t. Returns the counts of differing m1 and m2 elements,
    the largest parameter difference and bound after step 2, and the
    leaves beyond a bound."""
    b1 = float(torch.tensor(betas[0], dtype=torch.bfloat16))
    bc1, bc2 = 1 - betas[0] ** 2, 1 - betas[1] ** 2
    out = {"m1": 0, "m2": 0, "elements": 0, "dp": 0.0, "bound": 0.0, "beyond": []}

    def spacing(a, b):
        return bf16_spacing(torch.maximum(a.float().abs(), b.float().abs()))
    for k in one[1]["params"]:
        m1g, m1w = two[0]["opt"][k]["exp_avg"], one[0]["opt"][k]["exp_avg"]
        m2g, m2w = two[1]["opt"][k]["exp_avg"], one[1]["opt"][k]["exp_avg"]
        if {m1g.dtype, m1w.dtype, m2g.dtype, m2w.dtype} != {torch.bfloat16}:
            out["beyond"].append(f"{k}: exp_avg not bf16")
            continue
        dm1, dm2 = ((a.float() - b.float()).abs() for a, b in ((m1g, m1w), (m2g, m2w)))
        dg1, dg2 = ((two[i]["grads"][k].float() - one[i]["grads"][k].float()).abs()
                    for i in (0, 1))
        dmu = torch.where(dm1 > 0, b1 * dm1 + spacing(b1 * m1g.float(), b1 * m1w.float()),
                          0.0)
        v2 = one[1]["opt"][k]["exp_avg_sq"].float()
        bound = atol + lr * dmu / (bc1 * ((v2 / bc2).sqrt() + eps))
        dp = (two[1]["params"][k] - one[1]["params"][k]).abs()
        if not bool((dm1 <= (1 - betas[0]) * dg1 + spacing(m1g, m1w)).all()):
            out["beyond"].append(f"{k}: m1")
        g2 = torch.maximum(two[1]["grads"][k].abs(), one[1]["grads"][k].abs())
        f32_g2 = bf16_spacing((1 - betas[0]) * g2, bits=24)
        if not bool((dm2 <= dmu + (1 - betas[0]) * dg2 + f32_g2 + spacing(m2g, m2w)).all()):
            out["beyond"].append(f"{k}: m2")
        if not bool((dp <= bound).all()):
            out["beyond"].append(f"{k}: parameters")
        out["m1"] += int((dm1 > 0).sum())
        out["m2"] += int((dm2 > 0).sum())
        out["elements"] += dm1.numel()
        out["dp"] = max(out["dp"], float(dp.max()))
        out["bound"] = max(out["bound"], float(bound.max()))
    return out


def ema_bf16_steps(two, one) -> dict:
    """bf16 EMA trees at M = 2 (`two`, a list of trees) against one
    process's: the largest distance of an element in bf16 steps, the count
    of differing elements and of all."""
    out = {"max_steps": 0, "differ": 0, "elements": 0}
    for g, w in zip(two, one):
        for k in w:
            if g[k].dtype != torch.bfloat16 or w[k].dtype != torch.bfloat16:
                out["max_steps"] = float("inf")
                continue
            d = bf16_steps(g[k], w[k])
            out["max_steps"] = max(out["max_steps"], int(d.max()))
            out["differ"] += int((d > 0).sum())
            out["elements"] += d.numel()
    return out


def _bias_every_rank(dense, x):
    """The planted fault: the bias in every rank's partial product."""
    import torch.nn.functional as F
    from autoprog_tpu_torch.parallel import tp
    dt = dense.dtype
    part = F.linear(x.to(dt), dense.weight.to(dt), dense.bias.to(dt))
    return tp.reduce_from_model(part.float()).to(dt)


@contextlib.contextmanager
def planted(plant: str):
    """`plant` put into this process's `parallel/tp.py` for the duration."""
    from autoprog_tpu_torch.parallel import tp
    if plant == "none":
        yield
        return
    name, fault = {"no-row-reduce": ("reduce_from_model", lambda x: x),
                   "bias-every-rank": ("row_parallel", _bias_every_rank)}[plant]
    saved = getattr(tp, name)
    setattr(tp, name, fault)
    try:
        yield
    finally:
        setattr(tp, name, saved)


#: the biases' spread (`dp_parity.setup`): a fault in how the row-parallel
#: bias is added shows only where the biases are not 0
BIAS_STD = 0.02


def _device_args(a) -> dict:
    return dict(model=a.model, img_size=a.img_size, num_classes=a.num_classes,
                device=a.device, bias_std=BIAS_STD)


def worker(out_dir: str) -> None:
    """One rank: every (fault, seed) step, rank 0's gathered tensors to
    `out_dir`."""
    from autoprog_tpu_torch.parallel import mesh
    with open(os.path.join(out_dir, "args.json")) as f:
        a = argparse.Namespace(**json.load(f))
    torch.set_num_threads(1)
    dp_parity._no_tf32()
    if not mesh.maybe_init_distributed():
        raise SystemExit("the worker found no torchrun environment")
    mesh.init_grid(2)
    for plant in ("none",) + PLANTS:
        for seed in a.seeds:
            state, sb, data = dp_parity.setup(a.batch, torch.float32, seed=seed,
                                              **_device_args(a))
            with planted(plant):
                loss, grads, _ = tp_step(state, sb, data, a.img_size)
            if mesh.is_primary():
                torch.save({"loss": loss, "grads": {k: v.cpu() for k, v in grads.items()}},
                           os.path.join(out_dir, f"{plant}_{seed}.pt"))
            del state, sb, data, grads
    mesh.destroy()


def spawn(module: str, out_dir: str, device: str):
    """Two ranks of `python -m module --worker out_dir` on gloo (cuda:0
    shared, or the CPU), stderr to out_dir/rank<r>.err."""
    port = dp_parity._free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   AUTOPROG_DIST_BACKEND="gloo",
                   AUTOPROG_TORCH_DEVICE="cuda:0" if device == "cuda" else "cpu")
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as err:
            procs.append(subprocess.Popen([sys.executable, "-m", module, "--worker", out_dir],
                                          env=env, stdout=subprocess.DEVNULL, stderr=err))
    return procs


def compare(loss_two: float, grads_two, loss_one: float, grads_one, plant: str, seed: int,
            leaves=None) -> dict:
    """One row of readings: the 2-rank step's against the one-process step's.
    `leaves` (a list) takes every leaf's error line."""
    total, per = dp_parity.grad_errors(grads_two, grads_one)
    row = {"plant": plant, "seed": seed, "loss_one": loss_one, "loss_two": loss_two,
           "loss_rel": abs(loss_two - loss_one) / abs(loss_one), "grad_total": total,
           "worst": worst_by_family(per, grads_one)}
    row["within"] = within(row)
    if leaves is not None:
        leaves.extend(f"{plant} seed {seed} {family(k, grads_one[k]):>6} {k}: {v:.3e}"
                      for k, v in per.items())
    return row


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--worker", metavar="DIR", help=argparse.SUPPRESS)
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    p.add_argument("--batch", type=int, default=32, help="the global batch")
    p.add_argument("--model", default="volo_d1")
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--out", default="output/tp_parity", help="where summary.json goes")
    p.add_argument("--timeout", type=float, default=600)
    a = p.parse_args(argv)
    if a.worker:
        worker(a.worker)
        return
    if a.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to check the script on the CPU")
    dp_parity._no_tf32()
    os.makedirs(a.out, exist_ok=True)
    work = tempfile.mkdtemp(prefix="tp_parity_")
    with open(os.path.join(work, "args.json"), "w") as f:
        json.dump({k: v for k, v in vars(a).items() if k != "worker"}, f)
    t0 = time.time()
    procs = spawn("autoprog_tpu_torch.scripts.tp_parity", work, a.device)
    ref = {}
    for seed in a.seeds:
        state, sb, data = dp_parity.setup(a.batch, torch.float32, seed=seed,
                                          **_device_args(a))
        loss, grads, _ = dp_parity.dp_step(state, sb, data, a.img_size)
        ref[seed] = (loss, {k: v.cpu() for k, v in grads.items()})
        del state, sb, data
    dp_parity._wait(procs, work, a.timeout)
    rows, leaves = [], []
    for plant in ("none",) + PLANTS:
        for seed in a.seeds:
            two = torch.load(os.path.join(work, f"{plant}_{seed}.pt"))
            r = compare(two["loss"], two["grads"], *ref[seed], plant, seed, leaves)
            rows.append(r)
            fam = "; ".join(f"{f} {r['worst'][f][0]} {r['worst'][f][1]:.2e}"
                            for f in FAMILIES if f in r["worst"])
            print(f"{plant:>15} seed {seed}: loss {r['loss_one']:.7f} / {r['loss_two']:.7f} "
                  f"(rel {r['loss_rel']:.2e}); gradients over all {r['grad_total']:.2e}; "
                  f"worst per family: {fam}; {'within' if r['within'] else 'BEYOND'} the "
                  f"limits", file=sys.stderr)
    with open(os.path.join(a.out, "leaves.txt"), "w") as f:
        f.write("\n".join(leaves) + "\n")
    out = {"model": a.model, "img_size": a.img_size, "batch": a.batch, "device": a.device,
           "limits": {"loss": RTOL_LOSS, "all": RTOL_ALL, "leaf": RTOL_LEAF,
                      "stem": RTOL_STEM},
           "rows": rows, "wall_s": time.time() - t0}
    if a.device == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
    shutil.rmtree(work)
    with open(os.path.join(a.out, "summary.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
