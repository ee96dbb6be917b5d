"""Tensor parallelism of the port (`--model-parallel`, `parallel/tp.py`) across
gloo processes on the CPU, against the JAX package's tensor-parallel step.

Worker processes, this file run as a script (`python tests/test_torch_tp.py
worker <dir>`, with torchrun's environment set by the test), join one gloo
group, lay out the (data, model) grid with M = 2 and write what they saw to
<dir>. Two ranks (one model group) run:

  (a) one train step of volo_h4_l4 (heads 2/4/4/4) at 64 px, f32, global
      batch 8, dense token labels, the MixToken box JAX drew, AdamW at eps
      1e-3 and 4 EMA decays, from the JAX model's parameters;
  (b) the JAX package's checkpoint file (APTC0001) of the JAX step's state,
      resumed under M = 2 through `engine.resume_from`;
  (c) one deit_h2_l2 step under `--clip-grad` in each of the three modes;
  (d) one volo_h4_l4 step under `--remat full` and without, drop-path 0.1;
  (e) growth deit_h2_l2 -> deit_h2_l4 through `engine.create_stage_model_and_state`
      and one step of the grown model;
  (f) `main_prog.main --auto-grow --model-parallel 2` through a grow boundary,
      then `--resume` of its checkpoint-1.ckpt at M = 2;
  (g) `validate.main` over the two ranks (data parallel: M = 1) on an eval
      set that leaves each rank a padded last batch;
  (h) one f32 step of deit_h2_l2 (built with attn_drop_rate > 0) and one of
      volo_h4_l4, each with dropout on the attention probabilities, the
      class attention and the MLPs' hidden units (the sharded dropout sites),
      recording the masks each rank drew there;
  (i) two steps of (a)'s model from seeded parameters under `--opt sgd` and
      `--opt momentum`, and (a)'s step under `--opt sgd`;
  (j) two AdamW steps with `--adam-mu-bf16`, their state saved by rank 0 and
      resumed at M = 2 through `engine.resume_from`;
  (k) two AdamW steps with one bf16 EMA tree (`--model-ema-bf16`), and
      `StepBuilder._update_ema` alone on bf16 trees from the same f32
      parameters in every process;
  (l) two steps under `--batch-splits 2`, `--remat dots` with drop-path 0.1,
      AUTOPROG_SPARSE_TL=1 and `--drop 0.1`, one option at a time;
  (m) `main.main --aug-splits 3 --jsd` for 2 epochs and `main_prog.main
      --recal-bn-steps 2` through a depth growth.

Four ranks (data 2 x model 2) run (a) on their data group's half of the
batch. The test process meanwhile runs the JAX step on the virtual 8-device
mesh with `make_mesh(model_parallel=2)` and `shard_state_tp`, as
tests/test_tp.py does (under AdamW and SGD), and the one-process references
of (c) to (m). The tolerances are those of tests/test_torch_dist.py: loss rel
1e-5; gradients rtol 1e-4 / atol 1e-5; parameters and EMA trees atol 1e-6.
Where a leg states its own bound, its test derives it: the stem's gradients
from the second step on (`_hold_grads`), the bf16 first moment
(`tp_parity.mu_bf16_bounds`) and the bf16 EMA (one bf16 step). Each worker
has one intra-op thread and its own timeout. The legs (i) to (m) alone:
`python -m pytest tests/test_torch_tp.py -k "sgd or bf16 or option or jsd or
recal or dither"` (the workers run every case once for the module).
"""

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_dist import (  # noqa: E402
    B, DECAYS, IMG, LR, NC, REPO, _free_port, make_batch, step_args)

TIMEOUT = 180
MODEL = "volo_h4_l4"
TRAINER_ARGV = [
    "synthetic://", "--model", MODEL, "--num-classes", "10",
    "--img-size", "32", "-b", "32", "--epochs", "3",
    "--warmup-epochs", "1", "--cooldown-epochs", "0", "--workers", "0",
    "--fake-data-size", "64", "--no-bf16", "--num-stages", "2",
    "--r-scale", "0.5", "--l-scale", "0.5", "--drop-path", "0.0",
    "--auto-grow", "--search-epochs", "1", "--search-probe-steps", "2",
    "--search-time-iters", "2", "--load-with-clone", "--seed", "11",
    "--model-ema", "--model-ema-decay", "0.99",
]
VALIDATE_ARGV = ["synthetic://", "--num-classes", "10", "--img-size", "32", "-b", "16",
                 "--workers", "0", "--fake-data-size", "70"]
GROW_ARGV = ["synthetic://", "--model", "deit_h2_l2", "--num-classes", "8",
             "--img-size", "32", "-b", "8", "--workers", "0", "--no-bf16",
             "--drop-path", "0.0"]
CLIPS = {"norm": 0.05, "agc": 0.01, "value": 1e-4}
DROP = 0.2
DROP_MODELS = ("deit_h2_l2", MODEL)
JAX_RESUME_ARGV = ["synthetic://", "--model", MODEL, "--num-classes", str(NC),
                   "--img-size", str(IMG), "-b", str(B), "--workers", "0", "--no-bf16",
                   "--token-label", "--token-label-data", "synthetic", "--model-ema",
                   "--model-ema-decay", *map(str, DECAYS)]
#: (i) to (l): train steps a leg, the fixed MixToken box, the options of (l)
LEG_STEPS = 2
BBOX = torch.tensor([1, 1, 3, 2])
SGD_OPTS = ("sgd", "momentum")
OPTION_LEGS = {"batch_splits": dict(splits=2), "remat_dots": dict(remat="dots", drop_path=0.1),
               "sparse_tl": dict(sparse=True), "drop": dict(drop=0.1)}
#: (k): the decay of the trained bf16 EMA, and those of `_update_ema` alone
EMA_BF16 = (0.99,)
EMA_ROUND = (0.99, 0.9)
MU_RESUME_ARGV = JAX_RESUME_ARGV[:JAX_RESUME_ARGV.index("--model-ema")] + ["--adam-mu-bf16"]
#: (m): the fixed trainer with JSD over 3 aug splits, and the progressive
#: trainer with BatchNorm recalibration at its depth growth (l 2 -> 4)
MAIN_ARGV = ["synthetic://", "--model", MODEL, "--num-classes", "10", "--img-size", "32",
             "-b", "32", "--epochs", "2", "--warmup-epochs", "1", "--cooldown-epochs", "0",
             "--workers", "0", "--fake-data-size", "64", "--no-bf16", "--drop-path", "0.0",
             "--seed", "11", "--aug-splits", "3", "--jsd"]
RECAL_ARGV = ["synthetic://", "--model", MODEL, "--num-classes", "10", "--img-size", "32",
              "-b", "32", "--epochs", "2", "--warmup-epochs", "1", "--cooldown-epochs", "0",
              "--workers", "0", "--fake-data-size", "64", "--no-bf16", "--num-stages", "2",
              "--r-scale", "1.0", "--l-scale", "0.5", "--drop-path", "0.0", "--seed", "11",
              "--recal-bn-steps", "2"]


def _save(path, trees):
    np.savez(path, **{f"{p}.{k}": v.detach().float().cpu().numpy()
                      for p, tree in trees.items() for k, v in tree.items()})


def _tree(npz, prefix):
    return {k[len(prefix) + 1:]: torch.from_numpy(npz[k]) for k in npz.files
            if k.startswith(prefix + ".")}


def build(model, full, buffers, *, args, dtype=torch.float32, img=IMG, nc=NC, remat="",
          drop_path=0.0, ema=DECAYS, token_label=True, attn_drop=0.0, drop=0.0,
          ema_dtype=None):
    """The model's state and step builder on this rank: the full parameters
    `full` (and `buffers`), sharded under the grid."""
    from autoprog_tpu_torch import create_model
    from autoprog_tpu_torch.losses import build_train_loss
    from autoprog_tpu_torch.parallel import mesh, tp
    from autoprog_tpu_torch.train.optim import create_grad_clip, create_optimizer
    from autoprog_tpu_torch.train.state import TrainState
    from autoprog_tpu_torch.train.steps import StepBuilder
    net = create_model(model).make(num_classes=nc, img_size=img, dtype=dtype, remat=remat,
                                   drop_path_rate=drop_path, attn_drop_rate=attn_drop,
                                   drop_rate=drop, model_parallel=mesh.model_count())
    tp.load_shards(net, full, buffers)
    state = TrainState.create(model=net, optimizer=create_optimizer(args, net),
                              ema_decays=ema, ema_dtype=ema_dtype)
    sb = StepBuilder(train_loss=build_train_loss(args), ema_decays=ema, num_classes=nc,
                     token_label=token_label, has_token_label_data=token_label,
                     grad_clip=create_grad_clip(args), seed=3, rank=mesh.data_index())
    return state, sb


def seeded(model, seed=0, img=32, nc=8):
    """A model's full parameters and buffers from a seed (the same in every
    process)."""
    from autoprog_tpu_torch import create_model
    torch.manual_seed(seed)
    net = create_model(model).make(num_classes=nc, img_size=img, dtype=torch.float32)
    return ({n: p.detach() for n, p in net.named_parameters()},
            {n: b.detach() for n, b in net.named_buffers()})


def clip_args(mode):
    return argparse.Namespace(
        opt="adamw", opt_eps=1e-3, opt_betas=None, momentum=0.9, weight_decay=0.05,
        clip_grad=CLIPS[mode], clip_mode=mode, token_label=False, token_label_data="",
        token_label_size=2, dense_weight=0.5, cls_weight=1.0, ground_truth=False,
        smoothing=0.1)


def deit_batch():
    rs = np.random.default_rng(4)
    return {"image": torch.from_numpy(rs.normal(size=(8, 32, 32, 3)).astype(np.float32)),
            "label": torch.from_numpy(rs.integers(0, 8, 8).astype(np.int64))}


def clip_step(mode):
    """One deit_h2_l2 step under `--clip-grad` `mode`: the parameters after
    it, gathered."""
    from autoprog_tpu_torch.parallel import tp
    full, buffers = seeded("deit_h2_l2")
    state, sb = build("deit_h2_l2", full, buffers, args=clip_args(mode), img=32, nc=8,
                      ema=(), token_label=False)
    sb.train_step(state, deit_batch(), LR, r=32)
    return tp.gather_local({n: p.detach() for n, p in state.model.named_parameters()})


def remat_step(remat):
    """One volo_h4_l4 step at drop-path 0.1 under `remat`: loss and the
    gathered gradients."""
    from autoprog_tpu_torch.parallel import mesh, tp
    full, buffers = seeded(MODEL, img=IMG, nc=NC)
    state, sb = build(MODEL, full, buffers, args=step_args(), remat=remat, drop_path=0.1,
                      ema=())
    grads = {}
    optimizer_step = state.optimizer.step

    def record():
        grads.update({n: p.grad.clone() for n, p in state.model.named_parameters()})
        optimizer_step()
    state.optimizer.step = record
    batch = {k: torch.from_numpy(v[mesh.process_batch_slice(B)]) for k, v in make_batch().items()}
    m = sb.train_step(state, batch, LR, r=IMG, bbox=torch.tensor([1, 1, 3, 2]))
    return float(mesh.mean_over_ranks(m["loss"])), tp.gather_local(grads)


def dropout_step(model):
    """One f32 step of `model` with dropout DROP at the sharded sites: the
    attention probabilities (deit_h2_l2 built with attn_drop_rate; volo_h4_l4's
    outlookers take none, so its transformers and class attention are set
    after the build), and every MLP's hidden units. Returns the loss, the
    gathered gradients and the masks this rank drew at those sites."""
    from autoprog_tpu_torch.models import layers
    from autoprog_tpu_torch.parallel import mesh, tp
    deit = model == "deit_h2_l2"
    img, nc = (32, 8) if deit else (IMG, NC)
    full, buffers = seeded(model, img=img, nc=nc)
    args = argparse.Namespace(**dict(vars(clip_args("norm")), clip_grad=None)) if deit \
        else step_args()
    state, sb = build(model, full, buffers, args=args, img=img, nc=nc, ema=(),
                      token_label=not deit, attn_drop=DROP if deit else 0.0)
    for m in state.model.modules():
        if isinstance(m, layers.Mlp):
            m.drop = DROP
        elif isinstance(m, (layers.Attention, layers.ClassAttention)):
            m.attn_drop = DROP
    grads, masks = {}, []
    optimizer_step, drop = state.optimizer.step, layers.dropout

    def record():
        grads.update({n: p.grad.clone() for n, p in state.model.named_parameters()})
        optimizer_step()

    def recorded(*args, **kwargs):
        y = drop(*args, **kwargs)
        if kwargs.get("shard_dim") is not None:
            masks.append((y == 0).numpy())
        return y
    state.optimizer.step, layers.dropout = record, recorded
    try:
        if deit:
            m = sb.train_step(state, deit_batch(), LR, r=img)
        else:
            batch = {k: torch.from_numpy(v[mesh.process_batch_slice(B)])
                     for k, v in make_batch().items()}
            m = sb.train_step(state, batch, LR, r=img, bbox=torch.tensor([1, 1, 3, 2]))
    finally:
        layers.dropout = drop
    return float(mesh.mean_over_ranks(m["loss"])), tp.gather_local(grads), masks


def grow(argv):
    """engine.setup on `argv`, then growth to deit_h2_l4 (mode clone): the
    context and the grown full parameters."""
    from autoprog_tpu_torch import engine
    from autoprog_tpu_torch.config import parse_args
    from autoprog_tpu_torch.parallel import tp
    args, text = parse_args(argv, prog=True)
    ctx = engine.setup(args, text, prog=True, initial_model="deit_h2_l2")
    engine.create_stage_model_and_state(ctx, "deit_h2_l4", dp=0.0, load="slice")
    full = tp.gather_local({n: p.detach() for n, p in ctx.state.params.items()})
    return ctx, {k: v.clone() for k, v in full.items()}


def trainer_losses(run_dir, epoch=None):
    log = open(glob.glob(os.path.join(run_dir, "train", "*", "log.txt"))[0]).read()
    pat = r"Train: (\d+) \[\s*\d+/\d+\]\s+Loss: (\S+)"
    return [float(v) for e, v in re.findall(pat, log) if epoch is None or int(e) == epoch]


def opt_args(opt="adamw", mu_bf16=False):
    return argparse.Namespace(**dict(vars(step_args()), opt=opt, adam_mu_bf16=mu_bf16))


def leg(opt="adamw", *, mu_bf16=False, ema=(), ema_bf16=False, remat="", drop_path=0.0,
        drop=0.0, splits=1, sparse=False):
    """LEG_STEPS train steps of (a)'s model from seeded parameters on
    make_batch(step)'s rows with the fixed box, under one set of options
    (`tp_parity.leg_steps`: each step's loss, gradients, parameters,
    optimizer state and EMA trees, gathered), and the EMA trees as this rank
    holds them after the last. Returns (that record, the state)."""
    from autoprog_tpu_torch.scripts import tp_parity
    full, buffers = seeded(MODEL, img=IMG, nc=NC)
    state, sb = build(MODEL, full, buffers, args=opt_args(opt, mu_bf16), remat=remat,
                      drop_path=drop_path, drop=drop, ema=ema,
                      ema_dtype=torch.bfloat16 if ema_bf16 else None)
    batches = [{k: torch.from_numpy(v) for k, v in make_batch(i).items()}
               for i in range(LEG_STEPS)]
    steps = tp_parity.leg_steps(state, sb, batches, img_size=IMG, bbox=BBOX, lr=LR,
                                splits=splits, sparse=sparse)
    local = [{k: v.clone() for k, v in e.items()} for e in state.ema_params]
    return {"steps": steps, "ema_local": local}, state


def ema_round():
    """`StepBuilder._update_ema` alone on bf16 trees (decays EMA_ROUND),
    twice, towards the same f32 parameters in every process: seeded ones
    moved by a numpy draw of N(0, 0.01), this rank's shards of them. The
    trees after each sweep, gathered."""
    from autoprog_tpu_torch.parallel import tp
    from autoprog_tpu_torch.scripts.tp_parity import gathered
    full, buffers = seeded(MODEL, img=IMG, nc=NC)
    state, sb = build(MODEL, full, buffers, args=step_args(), ema=EMA_ROUND,
                      ema_dtype=torch.bfloat16)
    rs = np.random.default_rng(6)
    target = {k: v + torch.from_numpy(rs.normal(0, 0.01, v.shape).astype(np.float32))
              for k, v in full.items()}
    shards = tp.shard_tree(target)
    params = [shards[n] for n, _ in state.model.named_parameters()]
    out = []
    for _ in range(2):
        sb._update_ema(state, params)
        out.append([gathered(e) for e in state.ema_params])
    return out


def run_legs():
    """(i) to (l) in this process: the records of `leg` by name (and of
    `ema_round`), and the state of (j)'s leg for its checkpoint."""
    legs = {opt: leg(opt)[0] for opt in SGD_OPTS}
    legs["mu_bf16"], mu_state = leg(mu_bf16=True)
    legs["ema_bf16"] = leg(ema=EMA_BF16, ema_bf16=True)[0]
    legs["ema_round"] = ema_round()
    for name, kw in OPTION_LEGS.items():
        legs[name] = leg(**kw)[0]
    return legs, mu_state


class recorded_losses:
    """Every train step's loss (a float), while the context is open."""

    def __enter__(self):
        from autoprog_tpu_torch.train.steps import StepBuilder
        self.losses, self.step = [], StepBuilder.train_step
        step, losses = self.step, self.losses

        def train_step(sb, *a, **kw):
            out = step(sb, *a, **kw)
            losses.append(float(out["loss"]))
            return out
        StepBuilder.train_step = train_step
        return self.losses

    def __exit__(self, *exc):
        from autoprog_tpu_torch.train.steps import StepBuilder
        StepBuilder.train_step = self.step


def jsd_run(run_dir, extra=()):
    """`main.main` with `--aug-splits 3 --jsd` (MAIN_ARGV): every step's
    loss."""
    from autoprog_tpu_torch import main
    with recorded_losses() as losses:
        main.main(MAIN_ARGV + list(extra) + ["--output", run_dir])
    return list(losses)


def recal_run(run_dir, extra=()):
    """`main_prog.main` with `--recal-bn-steps 2` through a depth-growth
    boundary (RECAL_ARGV): the BatchNorm buffers right after each
    recalibration and at the end, the stage history and every loss."""
    from autoprog_tpu_torch import main_prog
    from autoprog_tpu_torch.train import bn
    after = []
    recal = bn.recalibrate_bn

    def recorded(ctx, *a, **kw):
        recal(ctx, *a, **kw)
        after.append({n: b.detach().clone() for n, b in ctx.state.model.named_buffers()})
    bn.recalibrate_bn = recorded
    try:
        with recorded_losses() as losses:
            main_prog.main(RECAL_ARGV + list(extra) + ["--output", run_dir])
    finally:
        bn.recalibrate_bn = recal
    ctx = main_prog.LAST_CTX
    return {"recal": after, "final": {n: b.detach().clone()
                                      for n, b in ctx.state.model.named_buffers()},
            "history": [[h["r"], h["l"]] for h in ctx.stage_history], "loss": list(losses)}


def mu_resume(path):
    """The checkpoint at `path` resumed through `engine.resume_from` under
    this process's grid with `--adam-mu-bf16`: the names of the parameters
    and optimizer tensors whose gathered values differ from the file's in
    bits or dtype, and the dtypes of the first moment as this rank holds it."""
    from autoprog_tpu_torch import engine
    from autoprog_tpu_torch.config import parse_args
    from autoprog_tpu_torch.parallel import mesh
    from autoprog_tpu_torch.train.checkpoint import build_payload, load_checkpoint_file
    extra = ["--model-parallel", str(mesh.model_count())] if mesh.model_count() > 1 else []
    args, text = parse_args(MU_RESUME_ARGV + extra, prog=False)
    ctx = engine.setup(args, text)
    want = load_checkpoint_file(path)
    engine.resume_from(ctx, want)
    got = build_payload(state=ctx.state, args_text="", arch_name=MODEL, stage_info={})
    differ = [n for n, t in want["state_dict"].items()
              if not torch.equal(got["state_dict"][n], t)]
    for i, st in want["optimizer"]["state"].items():
        for k, v in st.items():
            g = got["optimizer"]["state"][i][k]
            if g.dtype != v.dtype or not torch.equal(g, v):
                differ.append(f"opt.{i}.{k}")
    local = {str(st["exp_avg"].dtype) for st in ctx.state.optimizer.state.values()}
    return {"differ": differ, "local_mu_dtypes": sorted(local), "step": ctx.state.step}


# ------------------------------------------------------------------ worker


def worker(out_dir: str) -> None:
    torch.set_num_threads(1)
    from autoprog_tpu_torch import engine, main_prog, validate
    from autoprog_tpu_torch.config import parse_args
    from autoprog_tpu_torch.parallel import mesh, tp
    from autoprog_tpu_torch.prog import autogrow
    from autoprog_tpu_torch.scripts import tp_parity
    from autoprog_tpu_torch.train.checkpoint import (
        build_payload, load_checkpoint_file, save_checkpoint_file)
    assert mesh.maybe_init_distributed()
    mesh.init_grid(2)
    rank, world = mesh.process_index(), mesh.process_count()
    res = {"rank": rank, "world": world, "data": [mesh.data_index(), mesh.data_count()],
           "model": [mesh.model_index(), mesh.model_count()]}

    def out(name):
        return os.path.join(out_dir, f"{name}{rank}.npz")

    # (a) the step, on this data group's rows
    inp = np.load(os.path.join(out_dir, "step_in.npz"))
    full = {k[2:]: torch.from_numpy(inp[k]) for k in inp.files if k.startswith("p.")}
    params = {k: v for k, v in full.items() if not k.endswith(("running_mean", "running_var"))}
    buffers = {k: v for k, v in full.items() if k not in params}
    state, sb = build(MODEL, params, buffers, args=step_args())
    grads = {}
    optimizer_step = state.optimizer.step

    def record():
        grads.update({n: p.grad.clone() for n, p in state.model.named_parameters()})
        optimizer_step()
    state.optimizer.step = record
    rows = mesh.process_batch_slice(B)
    batch = {k[2:]: torch.from_numpy(inp[k][rows]) for k in inp.files if k.startswith("b.")}
    m = sb.train_step(state, batch, LR, r=IMG, bbox=torch.from_numpy(inp["bbox"]))
    res["loss"] = float(mesh.mean_over_ranks(m["loss"]))
    names = {id(p): n for n, p in state.model.named_parameters()}
    moments = {names[id(p)]: st["exp_avg"] for p, st in state.optimizer.state.items()}
    trees = {"g": grads, "p": state.params, "s": state.batch_stats, "m": moments}
    trees.update({f"e{i}": t for i, t in enumerate(state.ema_params)})
    _save(out("step"), trees)                          # this rank's shards
    res["local_shapes"] = {k: [list(t["s1b0.attn.qkv.weight"].shape),
                               list(t["s0b0.mlp.fc2.weight"].shape)]
                           for k, t in trees.items() if k != "s"}
    del state, sb
    if world == 4:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        mesh.destroy()
        return

    # a head count that M does not divide
    args, text = parse_args(["synthetic://", "--model", "volo_h2_l4", "--model-parallel", "2",
                             "--num-classes", "10", "--img-size", "32", "-b", "8",
                             "--workers", "0", "--no-bf16"], prog=False)
    try:
        engine.setup(args, text)
    except ValueError as e:
        res["h2_error"] = str(e)

    # (b) the JAX checkpoint of the JAX step's state, resumed under M = 2
    path = os.path.join(out_dir, "jax_tp.ckpt")
    deadline = time.time() + TIMEOUT
    while not os.path.exists(path) and time.time() < deadline:
        time.sleep(0.2)
    args, text = parse_args(JAX_RESUME_ARGV + ["--model-parallel", "2"], prog=False)
    ctx = engine.setup(args, text)
    engine.resume_from(ctx, load_checkpoint_file(path))
    names = {id(p): n for n, p in ctx.state.model.named_parameters()}
    opt = {names[id(p)]: st for p, st in ctx.state.optimizer.state.items()}
    _save(out("resumed"), {"p": ctx.state.params, "e3": ctx.state.ema_params[3],
                           "mu": {n: st["exp_avg"] for n, st in opt.items()},
                           "nu": {n: st["exp_avg_sq"] for n, st in opt.items()}})
    res["resumed_step"] = ctx.state.step
    del ctx

    # (c) the clip modes; (d) remat; (e) growth
    _save(out("clip"), {mode: clip_step(mode) for mode in CLIPS})
    loss_plain, g_plain = remat_step("")
    loss_remat, g_remat = remat_step("full")
    res["remat_loss"] = [loss_plain, loss_remat]
    _save(out("remat"), {"plain": g_plain, "full": g_remat})
    ctx, grown = grow(GROW_ARGV + ["--model-parallel", "2"])
    res["grown_qkv"] = list(ctx.state.params["s0b3.attn.qkv.weight"].shape)
    g = torch.Generator().manual_seed(0)
    gbatch = {"image": torch.randn(8, 32, 32, 3, generator=g),
              "label": torch.randint(0, 8, (8,), generator=g)}
    res["grown_loss"] = float(ctx.sb.train_step(ctx.state, gbatch, LR, r=32)["loss"])
    _save(out("grown"), {"p": grown})
    del ctx

    # (h) dropout at the sharded sites
    res["dropout_loss"] = {}
    for model in DROP_MODELS:
        loss, grads, masks = dropout_step(model)
        res["dropout_loss"][model] = loss
        _save(out(f"dropout_{model}_"), {"g": grads})
        np.savez(out(f"masks_{model}_"), *masks)

    # (i) SGD and momentum; (j) the bf16 first moment and its checkpoint;
    # (k) the bf16 EMA, alone and in the step; (l) one option at a time
    t_legs = time.time()
    legs, mu_state = run_legs()
    state, sb = build(MODEL, params, buffers, args=opt_args("sgd"), ema=())   # (a)'s inputs
    legs["sgd_jax"] = tp_parity.leg_steps(state, sb, [batch], img_size=IMG, lr=LR,
                                          bbox=torch.from_numpy(inp["bbox"]),
                                          keys=("params", "opt"))[0]
    del state, sb
    mu_path = os.path.join(out_dir, "mu_bf16.ckpt")
    payload = build_payload(state=mu_state, args_text="", arch_name=MODEL, stage_info={})
    if rank == 0:
        save_checkpoint_file(mu_path, dict(payload, epoch=0))
    mesh.barrier("mu_bf16.ckpt")
    res["mu_resume"] = mu_resume(mu_path)
    del mu_state, payload
    torch.save(legs, os.path.join(out_dir, f"legs{rank}.pt"))
    res["legs_s"] = time.time() - t_legs

    # (m) the trainers: JSD over aug splits, BatchNorm recalibration
    t_trainers = time.time()
    res["jsd_loss"] = jsd_run(os.path.join(out_dir, f"jsd{rank}"), ["--model-parallel", "2"])
    recal = recal_run(os.path.join(out_dir, f"recal{rank}"), ["--model-parallel", "2"])
    res["recal_history"], res["recal_loss"] = recal.pop("history"), recal.pop("loss")
    torch.save(recal, os.path.join(out_dir, f"recal{rank}.pt"))
    res["trainers_s"] = time.time() - t_trainers

    # (f) the progressive trainer, then a resume at M = 2
    decisions = []
    sync = autogrow.sync_decision

    def recorded(r, l):
        synced = sync(r, l)
        decisions.append([[r, l], list(synced)])
        return synced
    autogrow.sync_decision = recorded
    run_dir = os.path.join(out_dir, f"out{rank}")
    os.makedirs(run_dir)
    main_prog.main(TRAINER_ARGV + ["--model-parallel", "2", "--output", run_dir])
    res["decisions"] = decisions
    res["history"] = [h["l"] for h in main_prog.LAST_CTX.stage_history]
    res["files"] = sorted(os.path.relpath(os.path.join(d, f), run_dir)
                          for d, _, fs in os.walk(run_dir) for f in fs)
    mesh.barrier("files")
    ckpt = glob.glob(os.path.join(out_dir, "out0", "train", "*", "checkpoint-1.ckpt"))[0]
    resume_dir = os.path.join(out_dir, f"resume{rank}")
    os.makedirs(resume_dir)
    main_prog.main(TRAINER_ARGV + ["--model-parallel", "2", "--resume", ckpt,
                                   "--output", resume_dir])
    ctx = main_prog.LAST_CTX
    _save(out("resume"), {"p": tp.gather_local(ctx.state.params)})

    # (g) the validator over both ranks (data parallel: the grid back to M = 1)
    mesh.init_grid(1)
    best = glob.glob(os.path.join(out_dir, "out0", "train", "*", "model_best.ckpt"))[0]
    res["validate"] = validate.main(VALIDATE_ARGV + ["--checkpoint", best, "--results-file",
                                                     os.path.join(out_dir, f"v{rank}.csv")])
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f, default=float)
    mesh.destroy()


# --------------------------------------------------------------- the test


def _spawn(out_dir, nproc):
    port = str(_free_port())
    procs = []
    for rank in range(nproc):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(nproc), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port, AUTOPROG_TORCH_DEVICE="cpu",
                   OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep +
                   os.environ.get("PYTHONPATH", ""))
        env.pop("AUTOPROG_DIST_BACKEND", None)
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "worker", out_dir],
                stdout=subprocess.DEVNULL, stderr=err, env=env))
    return procs


def _wait(procs, out_dir):
    deadline = time.time() + TIMEOUT
    for rank, p in enumerate(procs):
        try:
            p.wait(timeout=max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.wait()
            raise
        with open(os.path.join(out_dir, f"rank{rank}.err")) as f:
            assert p.returncode == 0, f"rank {rank} failed:\n{f.read()[-6000:]}"
    res = []
    for rank in range(len(procs)):
        with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
            res.append(json.load(f))
    return res


def _jax_inputs(out_dir):
    """The JAX model's variables, the batch and JAX's MixToken box, written
    for the workers (step_in.npz), as tests/test_torch_dist.py makes them."""
    import jax
    import jax.numpy as jnp
    from autoprog_tpu.losses import build_train_loss as jax_build_train_loss
    from autoprog_tpu.registry import create_model as jax_create_model
    from autoprog_tpu.train import optim as joptim
    from autoprog_tpu.train.steps import StepBuilder as JaxStepBuilder
    from autoprog_tpu_torch.convert import flax_to_torch
    args = step_args()
    jmodel = jax_create_model(MODEL).make(num_classes=NC, img_size=IMG, dtype=jnp.float32)
    variables = jax.jit(lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                                            jnp.zeros((1, IMG, IMG, 3)), train=False))()
    params, bs = variables["params"], variables["batch_stats"]
    tx = joptim.create_optimizer(args, params)
    jsb = JaxStepBuilder(model=jmodel, tx=tx, train_loss=jax_build_train_loss(args),
                         ema_decays=DECAYS, num_classes=NC, token_label=True,
                         has_token_label_data=True, donate=False)
    batch = make_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(7)
    step_rng = jax.random.fold_in(rng, 0)
    out, _ = jax.jit(lambda p: jsb._apply_train(p, bs, jbatch["image"], step_rng, None))(params)
    arrays = {"p." + n: t.numpy() for n, t in flax_to_torch(params, bs).items()}
    arrays.update({"b." + k: v for k, v in batch.items()})
    np.savez(os.path.join(out_dir, "step_in.npz"), bbox=np.asarray(out[2]), **arrays)
    return dict(jsb=jsb, tx=tx, params=params, bs=bs, batch=batch, jbatch=jbatch, rng=rng,
                step_rng=step_rng, jmodel=jmodel)


def _jax_tp_step(j, out_dir):
    """JAX's loss and gradients on the whole batch, and its state after one
    step on the (4 data x 2 model) mesh with the shardings of
    `shard_state_tp`; that state also as the JAX package's checkpoint file
    (jax_tp.ckpt)."""
    import jax
    from jax.sharding import PartitionSpec as P
    from autoprog_tpu.parallel.mesh import MODEL_AXIS, make_mesh, replicate, shard_batch
    from autoprog_tpu.parallel.tp import shard_state_tp
    from autoprog_tpu.train import checkpoint as jax_ckpt
    from autoprog_tpu.train.state import TrainState as JaxTrainState
    jsb, params, bs, jbatch = j["jsb"], j["params"], j["bs"], j["jbatch"]
    target = jsb._build_target(jbatch, IMG)

    def loss_fn(p):
        out, _ = jsb._apply_train(p, bs, jbatch["image"], j["step_rng"], None)
        return jsb.train_loss(out, target)
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    mesh = make_mesh(model_parallel=2)
    state = JaxTrainState.create(params=params, batch_stats=bs, tx=j["tx"], ema_decays=DECAYS)
    state = shard_state_tp(mesh, replicate(mesh, state))
    assert state.params["s1b0"]["attn"]["qkv"]["kernel"].sharding.spec == P(None, MODEL_AXIS)
    batch = shard_batch(mesh, {k: jax.numpy.asarray(v) for k, v in j["batch"].items()})
    jnew, _ = jsb.train_step(r=IMG)(state, batch, LR, j["rng"])
    payload = jax_ckpt.build_payload(state=jnew, args_text="", arch_name=MODEL,
                                     stage_info={}, ema_decays=DECAYS)
    jax_ckpt.save_checkpoint_file(os.path.join(out_dir, "jax_tp.ckpt"), dict(payload, epoch=0))
    return dict(loss=float(jloss), grads=jgrads, new=jnew)


def _jax_sgd_tp_step(j, out_dir):
    """(a)'s step with `--opt sgd` in the JAX package on the (4 data x 2
    model) mesh with `shard_state_tp`'s shardings: its state in the port's
    names (parameters and the Nesterov trace), through the JAX package's
    checkpoint file (jax_sgd.ckpt)."""
    import jax
    from autoprog_tpu.losses import build_train_loss as jax_build_train_loss
    from autoprog_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from autoprog_tpu.parallel.tp import shard_state_tp
    from autoprog_tpu.train import checkpoint as jax_ckpt
    from autoprog_tpu.train import optim as joptim
    from autoprog_tpu.train.state import TrainState as JaxTrainState
    from autoprog_tpu.train.steps import StepBuilder as JaxStepBuilder
    from autoprog_tpu_torch.train.checkpoint import load_checkpoint_file
    args = opt_args("sgd")
    tx = joptim.create_optimizer(args, j["params"])
    jsb = JaxStepBuilder(model=j["jmodel"], tx=tx, train_loss=jax_build_train_loss(args),
                         ema_decays=(), num_classes=NC, token_label=True,
                         has_token_label_data=True, donate=False)
    mesh = make_mesh(model_parallel=2)
    state = JaxTrainState.create(params=j["params"], batch_stats=j["bs"], tx=tx, ema_decays=())
    state = shard_state_tp(mesh, replicate(mesh, state))
    batch = shard_batch(mesh, {k: jax.numpy.asarray(v) for k, v in j["batch"].items()})
    jnew, _ = jsb.train_step(r=IMG)(state, batch, LR, j["rng"])
    path = os.path.join(out_dir, "jax_sgd.ckpt")
    payload = jax_ckpt.build_payload(state=jnew, args_text="", arch_name=MODEL,
                                     stage_info={}, ema_decays=())
    jax_ckpt.save_checkpoint_file(path, dict(payload, epoch=0))
    ck = load_checkpoint_file(path)
    return {"params": ck["state_dict"], "trace": ck["optimizer"]["momentum_buffer"]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both runs' results (2 and 4 ranks), the JAX step computed while they
    run, and the one-process references of (c) to (g)."""
    from autoprog_tpu_torch import main_prog, validate
    from autoprog_tpu_torch.parallel import mesh
    for k in mesh.TORCHRUN_ENV:
        assert k not in os.environ, k
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AUTOPROG_TORCH_DEVICE", "cpu")
        return _run_ranks(tmp_path_factory)


def _run_ranks(tmp_path_factory):
    from autoprog_tpu_torch import main_prog, validate
    dirs = {n: str(tmp_path_factory.mktemp(f"tp{n}")) for n in (2, 4)}
    j = _jax_inputs(dirs[2])
    for d in dirs.values():
        if d != dirs[2]:
            os.link(os.path.join(dirs[2], "step_in.npz"), os.path.join(d, "step_in.npz"))
    procs = {n: _spawn(d, n) for n, d in dirs.items()}
    jax_out = _jax_tp_step(j, dirs[2])
    jax_out["sgd"] = _jax_sgd_tp_step(j, dirs[2])
    ref = {"clip": {mode: clip_step(mode) for mode in CLIPS}, "grown": grow(GROW_ARGV)[1],
           "dropout": {model: dropout_step(model)[:2] for model in DROP_MODELS},
           "legs": run_legs()[0], "jsd": jsd_run(os.path.join(dirs[2], "jsd_one")),
           "recal": recal_run(os.path.join(dirs[2], "recal_one"))}
    res = {n: _wait(procs[n], d) for n, d in dirs.items()}
    ref["mu_resume"] = mu_resume(os.path.join(dirs[2], "mu_bf16.ckpt"))
    ckpt = glob.glob(os.path.join(dirs[2], "out0", "train", "*", "checkpoint-1.ckpt"))[0]
    one = os.path.join(dirs[2], "resume_one")
    main_prog.main(TRAINER_ARGV + ["--resume", ckpt, "--output", one])
    ref["resume"] = {n: p.detach() for n, p in main_prog.LAST_CTX.state.params.items()}
    best = glob.glob(os.path.join(dirs[2], "out0", "train", "*", "model_best.ckpt"))[0]
    ref["validate"] = validate.main(VALIDATE_ARGV + ["--checkpoint", best])
    return dict(dirs=dirs, res=res, jax=jax_out, ref=ref, resume_one=one)


def _gathered(ranks, world, name, prefix, group=(0, 1)):
    from autoprog_tpu_torch.parallel import tp
    d = ranks["dirs"][world]
    shards = [_tree(np.load(os.path.join(d, f"{name}{r}.npz")), prefix) for r in group]
    return tp.gather_tree(shards)


def _full(ranks, name, prefix):
    """A tree the 2-rank workers gathered themselves: rank 0's (rank 1's is
    the same, bit for bit)."""
    d = ranks["dirs"][2]
    trees = [_tree(np.load(os.path.join(d, f"{name}{r}.npz")), prefix) for r in (0, 1)]
    for k in trees[0]:
        assert torch.equal(trees[0][k], trees[1][k]), (name, prefix, k)
    return trees[0]


def _close(got, want, **tol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **tol)


# ------------------------------------------------------- no process needed


def test_param_spec_rules():
    """`tests/test_tp.py::test_param_spec_rules` on the port's names, with the
    head-wise parts of the fused qkv / kv kernels."""
    from autoprog_tpu_torch.parallel.tp import param_spec
    assert param_spec("s1b0.attn.qkv.weight", 2) == (0, 3)
    assert param_spec("s1b0.attn.proj.weight", 2) == (1, 1)
    assert param_spec("s1b0.mlp.fc1.weight", 2) == (0, 1)
    assert param_spec("s1b0.mlp.fc2.weight", 2) == (1, 1)
    assert param_spec("s1b0.mlp.fc1.bias", 1) == (0, 1)
    assert param_spec("s0b0.attn.v.weight", 2) == (0, 1)
    assert param_spec("s0b0.attn.attn.weight", 2) == (0, 1)
    assert param_spec("post0.attn.kv.weight", 2) == (0, 2)
    assert param_spec("post0.attn.kv.bias", 1) == (0, 2)
    for name, ndim in (("s1b0.norm1.weight", 1), ("s1b0.mlp.fc2.bias", 1),
                       ("s1b0.attn.proj.bias", 1), ("pos_embed", 4), ("head.weight", 2),
                       ("patch_embed.proj.weight", 4), ("patch_embed.stem0.bn.weight", 1),
                       ("ds0.proj.weight", 4), ("cls_token", 3)):
        assert param_spec(name, ndim) is None, name


@pytest.mark.parametrize("model", [MODEL, "deit_h2_l2"])
def test_param_spec_follows_the_jax_rules_leaf_for_leaf(model):
    """Every leaf of the model: the JAX package's PartitionSpec and the port's
    spec say the same sharded axis (Flax kernel [in, out], torch weight [out,
    in]); the port splits qkv in 3 parts and kv in 2 where JAX splits
    contiguously."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from autoprog_tpu.parallel.mesh import MODEL_AXIS
    from autoprog_tpu.parallel.tp import param_spec as jax_spec
    from autoprog_tpu.registry import create_model as jax_create_model
    from autoprog_tpu_torch.parallel.tp import param_spec
    jmodel = jax_create_model(model).make(num_classes=NC, img_size=32, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                                                jnp.zeros((1, 32, 32, 3)), train=False))
    leaves = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    _leaf = {"kernel": "weight", "scale": "weight"}
    n_sharded = 0
    for path, leaf in leaves:
        keys = [p.key for p in path]
        name = ".".join(keys[:-1] + [_leaf.get(keys[-1], keys[-1])])
        want = jax_spec(path, leaf.ndim)
        got = param_spec(name, leaf.ndim)
        parts = {"qkv": 3, "kv": 2}.get(keys[-2] if len(keys) > 1 else "", 1)
        if want == P(None, MODEL_AXIS) or want == P(MODEL_AXIS) and keys[-1] == "bias":
            assert got == (0, parts), name
        elif want == P(MODEL_AXIS, None):
            assert got == (1, 1), name
        else:
            assert want == P() and got is None, name
        n_sharded += got is not None
    assert n_sharded > 10


def test_validate_tp_and_the_grid_refuse():
    from autoprog_tpu_torch import create_model
    from autoprog_tpu_torch.main import main
    from autoprog_tpu_torch.parallel import mesh
    from autoprog_tpu_torch.parallel.tp import validate_tp
    validate_tp(2, (6, 12, 12, 12))
    validate_tp(1, (5, 7))
    with pytest.raises(ValueError, match="must divide every head count"):
        validate_tp(2, (5, 12))
    with pytest.raises(ValueError, match="must divide every head count"):
        create_model("volo_h2_l4").make(num_classes=10, model_parallel=2)
    # one process cannot hold a model axis of 2
    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        main(["synthetic://", "--model", MODEL, "--model-parallel", "2"])
    assert mesh.model_count() == 1 and not mesh.process_group_active()


def test_setup_refuses_a_model_parallel_the_grid_was_not_laid_out_for():
    """engine.setup builds on the grid the process's start laid out: a
    `--model-parallel` that disagrees with it raises, rather than building
    whole layers under a flag that asks for shards."""
    from autoprog_tpu_torch import engine
    from autoprog_tpu_torch.config import parse_args
    args, text = parse_args(["synthetic://", "--model", "deit_h2_l2", "--model-parallel", "2",
                             "--num-classes", "10", "--img-size", "32", "-b", "8",
                             "--workers", "0", "--no-bf16"], prog=False)
    with pytest.raises(ValueError, match="on a grid of model size 1"):
        engine.setup(args, text)


def test_model_group_collectives_are_identities_without_tensor_parallelism():
    """At M = 1 the f / g functions and the model-group sum return their
    input (model_sum in f32), launch no collective and count none, so the
    clip's one formula is the one-device global norm."""
    from autoprog_tpu_torch.parallel import mesh, tp
    assert mesh.model_count() == 1
    before = dict(tp.COUNTS)
    x = torch.randn(3, 4, dtype=torch.bfloat16, requires_grad=True)
    assert tp.copy_to_model(x) is x and tp.reduce_from_model(x) is x
    s = tp.model_sum(x)
    assert s.dtype == torch.float32 and torch.equal(s, x.detach().float())
    assert tp.COUNTS == before


@pytest.mark.parametrize("model", [MODEL, "deit_h2_l2"])
def test_shards_of_a_jax_tree_gather_back_bit_for_bit(model):
    """`convert.flax_to_torch_shard` of the JAX parameters and of the
    optimizer's moments for each rank of M = 2: each rank holds half of every
    sharded leaf, qkv by heads, and `gather_tree` gives the full conversion
    back bit for bit."""
    import jax
    import jax.numpy as jnp
    from autoprog_tpu.registry import create_model as jax_create_model
    from autoprog_tpu.train import optim as joptim
    from autoprog_tpu_torch.convert import flax_to_torch, flax_to_torch_shard
    from autoprog_tpu_torch.parallel.tp import gather_tree
    jmodel = jax_create_model(model).make(num_classes=NC, img_size=32, dtype=jnp.float32)
    params = jmodel.init({"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 32, 32, 3)),
                         train=False)["params"]
    mu = jax.tree.map(lambda x: x * 0.5 + 1.0, params)     # a moment-shaped tree
    opt = joptim.create_optimizer(step_args(), params)
    assert opt is not None
    for tree in (params, mu):
        full = flax_to_torch(tree)
        shards = [flax_to_torch_shard(tree, m, 2) for m in range(2)]
        qkv = [k for k in full if k.endswith("qkv.weight")][0]
        assert shards[0][qkv].shape[0] * 2 == full[qkv].shape[0]
        C = full[qkv].shape[1]
        # rank 0's q, k and v: the first half of the heads of each
        for part in range(3):
            want = full[qkv][part * C:part * C + C // 2]
            got = shards[0][qkv][part * C // 2:(part + 1) * C // 2]
            assert torch.equal(got, want)
        back = gather_tree(shards)
        assert sorted(back) == sorted(full)
        for k in full:
            assert back[k].dtype == full[k].dtype and torch.equal(back[k], full[k]), k


# ------------------------------------------------------------- the workers


def test_grid_layout(ranks):
    res2, res4 = ranks["res"][2], ranks["res"][4]
    assert [(r["data"], r["model"]) for r in res2] == [([0, 1], [0, 2]), ([0, 1], [1, 2])]
    assert [(r["data"], r["model"]) for r in res4] == [
        ([0, 2], [0, 2]), ([0, 2], [1, 2]), ([1, 2], [0, 2]), ([1, 2], [1, 2])]
    assert all("must divide every head count" in r["h2_error"] for r in res2)


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_holds_only_its_shards(ranks, world):
    """qkv [3 C / 2, C] and fc2 [C, hidden / 2] in the parameters, the
    gradients, Adam's first moment and every EMA tree."""
    C, C0, hidden = 128, 64, 192           # s1b0's width, s0b0's width and hidden
    for r in ranks["res"][world]:
        assert sorted(r["local_shapes"]) == ["e0", "e1", "e2", "e3", "g", "m", "p"]
        for tree, (qkv, fc2) in r["local_shapes"].items():
            assert qkv == [3 * C // 2, C] and fc2 == [C0, hidden // 2], (tree, qkv, fc2)


@pytest.mark.parametrize("world", [2, 4])
def test_tp_step_equals_the_jax_tp_step(ranks, world):
    """The gathered shards of each model group (data group 0, and data group
    1 for 4 ranks) against the JAX step on the (4 data x 2 model) mesh."""
    from autoprog_tpu_torch.convert import flax_to_torch
    j = ranks["jax"]
    groups = [(0, 1)] if world == 2 else [(0, 1), (2, 3)]
    for r in ranks["res"][world]:
        assert r["loss"] == pytest.approx(j["loss"], rel=1e-5)
    for group in groups:
        def got(prefix):
            return _gathered(ranks, world, "step", prefix, group)
        _close(got("g"), flax_to_torch(j["grads"]), rtol=1e-4, atol=1e-5)
        _close(got("p"), flax_to_torch(j["new"].params), rtol=0, atol=1e-6)
        _close(got("s"), flax_to_torch({}, j["new"].batch_stats), rtol=1e-4, atol=1e-5)
        for i in range(len(DECAYS)):
            _close(got(f"e{i}"), flax_to_torch(j["new"].ema_params[i]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_replicated_leaves_agree_across_the_model_group(ranks, world):
    """With copy_to_model and the f32 reduce, every replicated leaf (norms,
    embeddings, stem, heads, row-parallel biases) and its gradient are bit
    for bit the same on the ranks of a model group, and all ranks of a data
    group hold the same shards."""
    from autoprog_tpu_torch.parallel.tp import param_spec
    d = ranks["dirs"][world]
    trees = [np.load(os.path.join(d, f"step{r}.npz")) for r in range(world)]
    for name in trees[0].files:
        leaf = name.split(".", 1)[1]
        for r in range(1, world):
            same = param_spec(leaf, trees[0][name].ndim) is None or r % 2 == 0
            if same:
                np.testing.assert_array_equal(trees[r][name], trees[0][name], err_msg=name)


def test_jax_checkpoint_resumes_under_model_parallel(ranks):
    """The JAX package's APTC0001 file of the JAX TP step's state, resumed at
    M = 2 (`engine.resume_from`): the gathered parameters, EMA tree and Adam
    moments equal the file's, bit for bit, and the step count is its own."""
    from autoprog_tpu_torch.train.checkpoint import load_checkpoint_file
    want = load_checkpoint_file(os.path.join(ranks["dirs"][2], "jax_tp.ckpt"))
    for prefix, tree in (("p", want["state_dict"]), ("e3", want["state_dict_ema_3"]),
                         ("mu", want["optimizer"]["exp_avg"]),
                         ("nu", want["optimizer"]["exp_avg_sq"])):
        got = _gathered(ranks, 2, "resumed", prefix)
        assert sorted(got) == sorted(tree), prefix
        for k in tree:
            assert torch.equal(got[k], tree[k].float()), (prefix, k)
    assert all(r["resumed_step"] == int(want["step"]) == 1 for r in ranks["res"][2])


@pytest.mark.parametrize("mode", sorted(CLIPS))
def test_clip_modes_under_tp_equal_one_process(ranks, mode):
    """`--clip-grad` with `--clip-mode` norm (the global norm over every
    shard), agc (unit norms summed over the model group where a unit spans
    the shards) and value: the parameters after one step, gathered, against
    one process's; and the clip moved them (against the step clipped by
    another mode)."""
    got = _full(ranks, "clip", mode)
    want = ranks["ref"]["clip"][mode]
    _close(got, want, rtol=0, atol=1e-6)
    other = ranks["ref"]["clip"]["value" if mode != "value" else "norm"]
    assert max(float((want[k] - other[k]).abs().max()) for k in want) > 1e-5


def test_remat_full_under_tp_equals_no_remat(ranks):
    """`--remat full` repeats each block's forward all-reduces in the
    backward on every rank in the same order: the loss and the gathered
    gradients equal the step without remat bit for bit (drop-path 0.1: the
    recompute draws the forward's paths)."""
    a, b = ranks["res"][2][0]["remat_loss"]
    assert a == b
    plain = _full(ranks, "remat", "plain")
    full = _full(ranks, "remat", "full")
    for k in plain:
        assert torch.equal(plain[k], full[k]), k


@pytest.mark.parametrize("model", DROP_MODELS)
def test_dropout_under_tp_equals_one_process(ranks, model):
    """Dropout inside the blocks at M = 2: each rank draws the mask of the
    full tensor from the step's generator and keeps its block, so the loss
    and the gathered gradients equal one process's step from the same
    generator seed, up to summation order."""
    loss, grads = ranks["ref"]["dropout"][model]
    for r in ranks["res"][2]:
        assert r["dropout_loss"][model] == pytest.approx(loss, rel=1e-5)
    _close(_full(ranks, f"dropout_{model}_", "g"), grads, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("model", DROP_MODELS)
def test_sharded_dropout_masks_differ_across_ranks(ranks, model):
    """The two ranks of the model group hold other heads and other hidden
    units, so their masks at every sharded site differ (one generator seed
    on both: a mask of the shard's shape would repeat across them)."""
    d = ranks["dirs"][2]
    m0, m1 = (np.load(os.path.join(d, f"masks_{model}_{r}.npz")) for r in (0, 1))
    assert len(m0.files) == len(m1.files) >= 4
    for k in m0.files:
        assert m0[k].shape == m1[k].shape and m0[k].any()
        assert not np.array_equal(m0[k], m1[k]), k


def test_growth_under_tp_equals_one_process(ranks):
    """`tests/test_tp.py::test_tp_with_progressive_growth` in the port: the
    grown deit_h2_l4 is sharded again (qkv by heads), its full parameters
    equal the one-process growth's, and it trains."""
    r0 = ranks["res"][2][0]
    assert r0["grown_qkv"] == [3 * 128 // 2, 128]
    assert np.isfinite(r0["grown_loss"])
    got = _full(ranks, "grown", "p")
    want = ranks["ref"]["grown"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k].float()), k


def test_auto_grow_under_tp_writes_full_checkpoints_from_rank_0(ranks):
    """One decision, rank 0's; one stage history; files from rank 0 alone,
    whose tensors have the shapes of a run without tensor parallelism."""
    from autoprog_tpu_torch import create_model
    r0, r1 = ranks["res"][2]
    assert len(r0["decisions"]) == 1 and r1["decisions"][0][1] == r0["decisions"][0][0]
    assert r0["history"] == r1["history"] and len(r0["history"]) >= 2
    assert {"last.ckpt", "last-search.ckpt", "checkpoint-1.ckpt"} <= \
        {os.path.basename(f) for f in r0["files"]}
    assert r1["files"] == []
    ck = glob.glob(os.path.join(ranks["dirs"][2], "out0", "train", "*", "last.ckpt"))[0]
    ckpt = torch.load(ck, map_location="cpu", weights_only=False)
    net = create_model(MODEL).make(num_classes=10, img_size=32, mix_token=False,
                                   return_dense=False)
    shapes = {n: tuple(p.shape) for n, p in net.named_parameters()}
    assert {n: tuple(t.shape) for n, t in ckpt["state_dict"].items()} == shapes
    assert {n: tuple(t.shape) for n, t in ckpt["state_dict_ema_0"].items()} == shapes
    from autoprog_tpu_torch.parallel.tp import _param_names
    from autoprog_tpu_torch.train.optim import create_optimizer
    names = _param_names(net, create_optimizer(step_args(), net))
    assert len(ckpt["optimizer"]["state"]) == len(names)
    for i, st in ckpt["optimizer"]["state"].items():
        assert tuple(st["exp_avg"].shape) == shapes[names[i]], names[i]


def test_tp_checkpoint_resumes_at_m1_and_m2(ranks):
    """checkpoint-1.ckpt of the TP run resumed at M = 2 (the workers) and at
    M = 1 (this process): the epoch after it gives the TP run's losses, and
    the two resumed runs end on the same parameters."""
    d = ranks["dirs"][2]
    run = trainer_losses(os.path.join(d, "out0"), epoch=2)
    at2 = trainer_losses(os.path.join(d, "resume0"), epoch=2)
    at1 = trainer_losses(ranks["resume_one"], epoch=2)
    assert run and run == at2 == at1
    got = _full(ranks, "resume", "p")
    _close(got, {k: v.float() for k, v in ranks["ref"]["resume"].items()}, rtol=0, atol=1e-5)


def test_validate_over_two_ranks_equals_one_process(ranks):
    """70 samples at -b 16 over 2 ranks: 35 a rank, the last batch padded;
    top-1 and top-5 exactly one process's, the loss to f32 summation order,
    the CSV from rank 0 alone."""
    want = ranks["ref"]["validate"][0]
    for r in ranks["res"][2]:
        got = r["validate"][0]
        assert got["count"] == want["count"] == 70
        assert got["top1"] == want["top1"] and got["top5"] == want["top5"]
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)
    d = ranks["dirs"][2]
    assert os.path.exists(os.path.join(d, "v0.csv")) and not os.path.exists(
        os.path.join(d, "v1.csv"))


def test_parity_limits_catch_planted_faults(tmp_path):
    """`autoprog_tpu_torch/scripts/tp_parity.py` (the readings behind
    `chip_smoke.py` phase 12 (a)'s limits) on the CPU at volo_h4_l4's size:
    the clean 2-rank step keeps the limits, and each planted fault, the
    row-parallel reduce skipped or the bias added on every rank, breaks
    them."""
    from autoprog_tpu_torch.scripts import tp_parity
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "AUTOPROG_DIST_BACKEND"):
        env.pop(k, None)
    res = subprocess.run(
        [sys.executable, "-m", "autoprog_tpu_torch.scripts.tp_parity", "--device", "cpu",
         "--model", MODEL, "--img-size", str(IMG), "--num-classes", str(NC), "--batch",
         str(B), "--seeds", "0", "--out", str(tmp_path), "--timeout", str(TIMEOUT)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=TIMEOUT + 30)
    assert res.returncode == 0, res.stderr[-4000:]
    rows = {r["plant"]: r for r in json.loads(res.stdout.strip().splitlines()[-1])["rows"]}
    assert set(rows) == {"none", *tp_parity.PLANTS}
    assert rows["none"]["within"] and rows["none"]["grad_total"] < tp_parity.RTOL_ALL
    for plant in tp_parity.PLANTS:
        assert not rows[plant]["within"], plant
        assert rows[plant]["grad_total"] > 100 * tp_parity.RTOL_ALL, plant
        assert rows[plant]["loss_rel"] > tp_parity.RTOL_LOSS, plant



# ------------------------------------------- the options under TP: (i) to (m)


@pytest.fixture(scope="module")
def legs(ranks):
    """The workers' records of (i) to (l), rank 0's and rank 1's, and one
    process's."""
    d = ranks["dirs"][2]
    two = [torch.load(os.path.join(d, f"legs{r}.pt")) for r in (0, 1)]
    return two, ranks["ref"]["legs"]


def _bit_equal(a, b, where=()):
    """Two records (dicts, lists, tensors, floats) the same bit for bit."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _bit_equal(a[k], b[k], where + (k,))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _bit_equal(x, y, where + (i,))
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a == b, where


def _same_on_both(two, key):
    """The record `key` of the two ranks, which must be the same bit for
    bit (a gather gives every rank the same full tensors); `ema_local`, each
    rank's own shards, is left out."""
    a, b = two[0][key], two[1][key]
    if isinstance(a, dict):
        a, b = ({k: v for k, v in r.items() if k != "ema_local"} for r in (a, b))
    _bit_equal(a, b, (key,))
    return two[0][key]


def _hold_grads(got, want, step):
    """Gradients of a 2-rank leg against one process's, at the tolerances of
    tests/test_torch_dist.py (rtol 1e-4, atol 1e-5 per element), but for
    the stem's leaves from step 2 on. A later step's gradients are taken at
    parameters that already differ by the f32 summation order, and a unit
    of the stem's three ReLUs can sit at its kink within that difference:
    in the SGD legs one unit of 262144 after stem2 changes sides in step 2
    (in one process too, from the one f32 ulp of stem0's kernel that the
    2-rank step moved), which moves every stem leaf's gradient by ~1.8e-3
    of its norm. So there the stem's leaves are held as
    `scripts/tp_parity.py` holds them on the card: each relative to its
    norm within RTOL_STEM."""
    from autoprog_tpu_torch.scripts import dp_parity, tp_parity
    stem = {k for k in want if tp_parity.family(k, want[k]) == "stem"} if step else set()
    _close({k: v for k, v in got.items() if k not in stem},
           {k: v for k, v in want.items() if k not in stem}, rtol=1e-4, atol=1e-5)
    if stem:
        _, per = dp_parity.grad_errors({k: got[k] for k in stem}, {k: want[k] for k in stem})
        for k, err in per.items():
            assert err <= tp_parity.RTOL_STEM, (step, k, err)


def _hold_leg(got, want, *, params=True):
    """A 2-rank leg's steps against one process's: every step's loss (rel
    1e-5) and gradients (`_hold_grads`), the parameters after each step
    (atol 1e-6)."""
    assert [r["loss"] for r in got] == pytest.approx([r["loss"] for r in want], rel=1e-5)
    for step, (g, w) in enumerate(zip(got, want)):
        _hold_grads(g["grads"], w["grads"], step)
        if params:
            _close(g["params"], w["params"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("count", [2, 4])
def test_sharded_dither_equals_the_one_process_rounding(count):
    """`cast_bf16_sr` with the shards' specs (no process group: each shard
    from `tp.shard_tree`): every shard of the one-process rounding equals
    the rounding of that shard, at M = 2 and 4, for qkv and kv (head-wise
    parts), a row-parallel kernel, contiguous column-parallel kernels and
    biases, and replicated leaves. The largest leaf is sharded, so the
    unrepaired rounding, a sweep of the local largest leaf read at each
    shard's own shape (the call without specs), differs in every sharded
    leaf."""
    from autoprog_tpu_torch.ops.rounding import cast_bf16_sr
    from autoprog_tpu_torch.parallel import tp
    C = 16
    shapes = {"s1b0.attn.qkv.weight": (3 * C, C), "post0.attn.kv.weight": (2 * C, C),
              "post0.attn.kv.bias": (2 * C,), "s1b0.attn.proj.weight": (C, C),
              "s1b0.mlp.fc1.weight": (4 * C, C), "s1b0.mlp.fc1.bias": (4 * C,),
              "s0b0.attn.v.weight": (C, C), "s1b0.norm1.weight": (C,),
              "s1b0.attn.proj.bias": (C,), "pos_embed": (1, 4, 4, C)}
    rs = np.random.default_rng(count)
    full = {k: torch.from_numpy(rs.normal(size=v).astype(np.float32)) for k, v in shapes.items()}
    specs = {k: tp.param_spec(k, v.ndim) for k, v in full.items()}
    assert max(full.values(), key=torch.Tensor.numel) is full["s1b0.mlp.fc1.weight"]
    assert specs["s1b0.attn.qkv.weight"] == (0, 3) and specs["post0.attn.kv.bias"] == (0, 2)
    assert specs["s1b0.attn.proj.weight"] == (1, 1) and specs["pos_embed"] is None

    def rounded(tree, **kw):
        out = cast_bf16_sr(list(tree.values()), torch.Generator().manual_seed(9), **kw)
        return dict(zip(tree, out))
    one = rounded(full)
    sharded_differ = set()
    for m in range(count):
        shards = tp.shard_tree(full, m, count)
        got = rounded(shards, specs=[specs[k] for k in shards], m=m, count=count)
        want = tp.shard_tree(one, m, count)
        old = rounded(shards)
        for k in full:
            assert got[k].dtype == torch.bfloat16 and got[k].shape == shards[k].shape
            assert torch.equal(got[k].view(torch.int16), want[k].view(torch.int16)), (m, k)
            if not torch.equal(old[k].view(torch.int16), want[k].view(torch.int16)):
                sharded_differ.add(k)
    assert sharded_differ >= {k for k, sp in specs.items() if sp is not None}
    # without tensor parallelism the specs change nothing
    again = rounded(full, specs=list(specs.values()), m=0, count=1)
    for k in full:
        assert torch.equal(again[k].view(torch.int16), one[k].view(torch.int16)), k


def test_bf16_ema_sweep_under_tp_is_the_one_process_rounding(legs):
    """`StepBuilder._update_ema` on bf16 trees (two decays, two sweeps) from
    the same f32 parameters: the two ranks' trees, gathered, equal one
    process's bit for bit (volo_h4_l4: qkv, kv, row-parallel proj / fc2,
    contiguous v / attn / fc1)."""
    from autoprog_tpu_torch.parallel.tp import param_spec
    two, one = legs
    got = _same_on_both(two, "ema_round")
    n_sharded = 0
    for sweep_got, sweep_want in zip(got, one["ema_round"]):
        for g, w in zip(sweep_got, sweep_want):
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == torch.bfloat16
                assert torch.equal(g[k].view(torch.int16), w[k].view(torch.int16)), k
                n_sharded += param_spec(k, w[k].ndim) is not None
    assert n_sharded > 40


@pytest.mark.parametrize("opt", SGD_OPTS)
def test_sgd_under_tp_equals_one_process(legs, opt):
    """(i) two steps of `--opt sgd` / `momentum` (the Nesterov trace) at M = 2:
    losses, gradients and parameters as one process's, and the momentum
    buffers gathered by `tp.gather_optimizer_state` (gradient-like: as
    `_hold_grads` holds the gradients of the same step)."""
    two, one = legs
    got, want = _same_on_both(two, opt)["steps"], one[opt]["steps"]
    _hold_leg(got, want)
    for step, (g, w) in enumerate(zip(got, want)):
        _hold_grads({k: v["momentum_buffer"] for k, v in g["opt"].items()},
                    {k: v["momentum_buffer"] for k, v in w["opt"].items()}, step)


def test_sgd_tp_step_equals_the_jax_tp_step(ranks, legs):
    """(i) (a)'s step under `--opt sgd` at M = 2 against the JAX package's SGD
    step on the (4 data x 2 model) mesh with `shard_state_tp`: the loss, the
    parameters and the Nesterov trace."""
    two, _ = legs
    jax_sgd = ranks["jax"]["sgd"]
    got = _same_on_both(two, "sgd_jax")
    assert got["loss"] == pytest.approx(ranks["jax"]["loss"], rel=1e-5)
    _close(got["params"], {k: v.float() for k, v in jax_sgd["params"].items()},
           rtol=0, atol=1e-6)
    _close({k: v["momentum_buffer"] for k, v in got["opt"].items()}, jax_sgd["trace"],
           rtol=1e-4, atol=1e-5)


def test_bf16_first_moment_under_tp_within_one_rounding(legs):
    """(j) two AdamW steps with `--adam-mu-bf16` at M = 2: losses and
    gradients as one process's, the parameters after step 1 too (it updates
    from the f32 moment); the bf16 moments and the parameters after step 2
    within the bounds that a moment rounded to its other bf16 neighbour
    gives (`tp_parity.mu_bf16_bounds`, element by element). The counts and
    the bound are printed."""
    from autoprog_tpu_torch.scripts import tp_parity
    two, one = legs
    got, want = _same_on_both(two, "mu_bf16")["steps"], one["mu_bf16"]["steps"]
    _hold_leg(got, want, params=False)
    _close(got[0]["params"], want[0]["params"], rtol=0, atol=1e-6)
    b = tp_parity.mu_bf16_bounds(got, want, lr=LR, eps=1e-3)
    print(f"(j) bf16 first moment at M=2: {b['m1']} / {b['elements']} elements of m1 and "
          f"{b['m2']} of m2 differ from one process's; parameters after step 2 apart by at "
          f"most {b['dp']:.3e}, the per-element bound at most {b['bound']:.3e}")
    assert b["beyond"] == [] and b["m1"] < b["elements"] // 100


def test_bf16_first_moment_checkpoint_resumes_at_m1_and_m2(ranks):
    """(j) (j)'s state after its two steps, saved at M = 2 by rank 0
    (`build_payload` gathers every shard), resumed through
    `engine.resume_from` at M = 2 (the workers) and at M = 1 (this
    process): the gathered parameters and optimizer state equal the file's
    bit for bit, the first moment in bf16 in the file, on each rank's
    shards and gathered again."""
    from autoprog_tpu_torch.train.checkpoint import load_checkpoint_file
    ck = load_checkpoint_file(os.path.join(ranks["dirs"][2], "mu_bf16.ckpt"))
    mus = [st["exp_avg"] for st in ck["optimizer"]["state"].values()]
    assert mus and all(t.dtype == torch.bfloat16 for t in mus)
    for got in [r["mu_resume"] for r in ranks["res"][2]] + [ranks["ref"]["mu_resume"]]:
        assert got["differ"] == [] and got["local_mu_dtypes"] == ["torch.bfloat16"]
        assert got["step"] == LEG_STEPS


def test_bf16_ema_under_tp_within_one_bf16_step(legs):
    """(k) two AdamW steps with one bf16 EMA tree (decay 0.99) at M = 2 after
    the dither repair: every element of the gathered tree within one bf16
    step of one process's. An element differs only where the f32 values it
    is rounded from differ (the parameters, by summation order): with the
    same dither, x and y round apart with probability |x - y| / spacing, so
    the expected count of new ones is (1 - d) sum |dp| / spacing per step
    (a difference, once made, is carried on by d), and the count is held to
    4 times that plus 10. The replicated leaves are bit-equal across the
    ranks."""
    from autoprog_tpu_torch.parallel.tp import param_spec
    from autoprog_tpu_torch.scripts import tp_parity
    two, one = legs
    got, want = _same_on_both(two, "ema_bf16")["steps"], one["ema_bf16"]["steps"]
    _hold_leg(got, want)
    d, n_diff, expected = EMA_BF16[0], [], 0.0
    for g, w in zip(got, want):
        r = tp_parity.ema_bf16_steps(g["ema"], w["ema"])
        assert r["max_steps"] <= 1, r
        n_diff.append(r["differ"])
        expected += sum(float(((1 - d) * (g["params"][k] - w["params"][k]).abs() /
                               tp_parity.bf16_spacing(w["ema"][0][k])).sum())
                        for k in w["params"])
    print(f"(k) bf16 EMA at M=2: {n_diff} of {r['elements']} elements one bf16 step from "
          f"one process's after steps 1, 2 (expected from the parameter differences: "
          f"{expected:.2f} new ones in all)")
    assert n_diff[-1] <= 4 * expected + 10
    r0, r1 = two[0]["ema_bf16"]["ema_local"][0], two[1]["ema_bf16"]["ema_local"][0]
    for k, v in r0.items():
        if param_spec(k, v.ndim) is None:
            assert torch.equal(v.view(torch.int16), r1[k].view(torch.int16)), k


@pytest.mark.parametrize("option", sorted(OPTION_LEGS))
def test_step_option_under_tp_equals_one_process(legs, option):
    """(l) two steps at M = 2 under `--batch-splits 2`, `--remat dots` with
    drop-path 0.1 (the recompute replays the drop paths and the
    row-parallel all-reduce), AUTOPROG_SPARSE_TL=1 or `--drop 0.1` (the
    position-embedding dropout on replicated tokens, one mask on both
    ranks): losses, gradients and parameters as one process's."""
    two, one = legs
    _hold_leg(_same_on_both(two, option)["steps"], one[option]["steps"])


def test_jsd_aug_splits_under_tp_equals_one_process(ranks):
    """(m) `main.py --model-parallel 2 --aug-splits 3 --jsd` for 2 epochs:
    every step's loss on both ranks equals one process's within 1e-5
    relative."""
    want = ranks["ref"]["jsd"]
    assert len(want) == 4 and all(np.isfinite(want))
    for r in ranks["res"][2]:
        assert r["jsd_loss"] == pytest.approx(want, rel=1e-5)


def test_recal_bn_under_tp_equals_one_process(ranks):
    """(m) `main_prog.py --model-parallel 2 --recal-bn-steps 2` through its
    depth growth (l 2 -> 4): the stem's BatchNorm running stats right
    after the recalibration and at the end are bit-equal across the ranks
    and equal one process's within 1e-6; the same stages and losses."""
    d = ranks["dirs"][2]
    two = [torch.load(os.path.join(d, f"recal{r}.pt")) for r in (0, 1)]
    want = ranks["ref"]["recal"]
    assert len(want["recal"]) == 1 and want["history"][-1][1] == 4
    for r in ranks["res"][2]:
        assert r["recal_history"] == want["history"]
        assert r["recal_loss"] == pytest.approx(want["loss"], rel=1e-5)
    for when in ("recal", "final"):
        a, b = two[0][when], two[1][when]
        for x, y, w in zip(a if when == "recal" else [a], b if when == "recal" else [b],
                           want[when] if when == "recal" else [want[when]]):
            assert sorted(x) == sorted(w) and any(k.startswith("patch_embed.stem") for k in x)
            for k in w:
                assert torch.equal(x[k], y[k]), (when, k)
            _close(x, w, rtol=0, atol=1e-6)


if __name__ == "__main__":
    if sys.argv[1:2] == ["worker"]:
        worker(sys.argv[2])
    else:
        sys.exit(f"usage: {sys.argv[0]} worker <dir>")
