"""The train step's options end to end in the port on the CPU: the trainers
with `--uint8-pipe`, `--aug-splits 3 --jsd`, `--profile`, `--opt sgd`,
`--remat`, bf16 EMA and Adam state and AUTOPROG_SPARSE_TL=1; the loaders
and the step's input path under them; and checkpoints of the JAX package
trained with SGD and with a bf16 Adam moment and bf16 EMA trees, resumed in
the port with the optimizer state and EMA trees equal to the file's.
"""

import argparse
import glob
import json
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autoprog_tpu.registry import create_model as jax_create_model
from autoprog_tpu.train import checkpoint as jax_ckpt
from autoprog_tpu.train import optim as joptim
from autoprog_tpu.train.state import TrainState as JaxTrainState
from autoprog_tpu_torch import engine, main as port_main, main_prog as port_main_prog
from autoprog_tpu_torch.config import parse_args
from autoprog_tpu_torch.convert import flax_to_torch
from autoprog_tpu_torch.train.checkpoint import load_checkpoint_file
from autoprog_tpu_torch.train.optim import AdamWBf16Mu, NesterovSGD

TINY = ["synthetic://", "--model", "volo_h2_l4", "--num-classes", "8", "--img-size", "32",
        "-b", "8", "--epochs", "1", "--warmup-epochs", "0", "--cooldown-epochs", "0",
        "--workers", "0", "--fake-data-size", "32", "--no-bf16", "--log-interval", "1"]


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("AUTOPROG_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("AUTOPROG_SPARSE_TL", raising=False)


def _run(argv, out):
    port_main.main(argv + ["--output", str(out)])
    run = glob.glob(str(out / "train" / "*"))[0]
    log = open(os.path.join(run, "log.txt")).read()
    losses = [float(v) for v in re.findall(r"Train: 0 \[\s*\d+/\d+\]\s+Loss: (\S+)", log)]
    assert len(losses) == 4 and all(math.isfinite(v) for v in losses), losses
    return run, log


def test_main_with_the_state_and_input_options(tmp_path, monkeypatch):
    """uint8 batches erased on the device, sparse token labels, bf16 EMA
    trees and Adam moment, `--remat dots`: four finite steps, bf16 state in
    the checkpoint, EMA trees that moved off the initial parameters."""
    monkeypatch.setenv("AUTOPROG_SPARSE_TL", "1")
    run, log = _run(TINY + ["--token-label", "--token-label-data", "synthetic",
                            "--uint8-pipe", "--reprob", "0.5", "--model-ema",
                            "--model-ema-decay", "0.9", "0.99", "--model-ema-bf16",
                            "--adam-mu-bf16", "--remat", "dots", "--drop-path", "0.1"],
                    tmp_path)
    assert len(re.findall(r"Test(_EMA_\S+)?: loss", log)) == 3
    ck = load_checkpoint_file(os.path.join(run, "last.ckpt"))
    assert ck["step"] == 4
    for i in range(2):
        assert {t.dtype for t in ck[f"state_dict_ema_{i}"].values()} == {torch.bfloat16}
    assert {s["exp_avg"].dtype for s in ck["optimizer"]["state"].values()} == {torch.bfloat16}
    assert {s["exp_avg_sq"].dtype for s in ck["optimizer"]["state"].values()} == {torch.float32}
    moved = sum(not torch.equal(ck["state_dict_ema_0"][n], p.bfloat16())
                for n, p in ck["state_dict"].items())
    assert moved > len(ck["state_dict"]) // 2


@pytest.mark.parametrize("extra", [["--aug-splits", "3", "--jsd"],
                                   ["--aug-splits", "3", "--jsd", "--uint8-pipe"],
                                   ["--opt", "sgd", "--remat"],
                                   ["--opt", "momentum", "--weight-decay", "0.0001"]])
def test_main_with_aug_splits_jsd_and_sgd(tmp_path, extra):
    run, log = _run(TINY + extra, tmp_path)
    ck = load_checkpoint_file(os.path.join(run, "last.ckpt"))
    kinds = {k for s in ck["optimizer"]["state"].values() for k in s}
    assert kinds == ({"momentum_buffer"} if "--opt" in extra else
                     {"step", "exp_avg", "exp_avg_sq"})


def test_main_profile_writes_a_trace(tmp_path):
    trace_dir = tmp_path / "trace"
    run, log = _run(TINY + ["--profile", str(trace_dir), "--profile-steps", "2"], tmp_path)
    files = glob.glob(str(trace_dir / "*.json"))
    assert len(files) == 1 and f"profiler trace written to {files[0]}" in log
    events = json.load(open(files[0]))["traceEvents"]
    # batches 1 and 2 of the epoch: two optimizer steps in the trace
    steps = [e for e in events if e.get("name", "").startswith("Optimizer.step#")]
    assert len(steps) == 2, {e.get("name") for e in steps}


def test_progressive_growth_keeps_bf16_ema_trees(tmp_path):
    out = tmp_path / "prog"
    i = TINY.index("--epochs")
    argv = TINY[:i] + TINY[i + 2:] + [
        "--epochs", "2", "--num-stages", "2", "--r-scale", "0.5", "--l-scale", "0.5",
        "--load-with-clone", "--model-ema", "--model-ema-decay", "0.9", "0.99",
        "--model-ema-bf16", "--adam-mu-bf16", "--uint8-pipe", "--output", str(out)]
    port_main_prog.main(argv)
    ctx = port_main_prog.LAST_CTX
    depths = [h["l"] for h in ctx.stage_history]
    assert depths[0] == 2 and depths[-1] == 4
    assert ctx.mdef.name == "volo_h2_l4"
    for tree in ctx.state.ema_params:
        assert {t.dtype for t in tree.values()} == {torch.bfloat16}
        assert set(tree) == set(ctx.state.params)
    assert isinstance(ctx.state.optimizer, AdamWBf16Mu)


def _ctx(argv):
    args, text = parse_args(argv, prog=False)
    args.token_label_size = 2
    return engine.setup(args, text)


def test_uint8_and_aug_split_loaders_emit_uint8():
    ctx = _ctx(TINY + ["--aug-splits", "3", "--uint8-pipe"])
    loader = engine.make_train_loader(ctx, aa="", re_prob=0.25, resize=(0.08, 1.0))
    batch = next(iter(loader))
    assert batch["image"].dtype == np.uint8 and batch["image"].shape == (24, 32, 32, 3)
    assert batch["label"].shape == (8,)
    assert loader.transform.re_prob == 0.0
    eval_batch = next(iter(engine.make_eval_loader(ctx)))
    assert eval_batch["image"].dtype == np.uint8
    assert engine.device_re_prob(ctx.args, 0.25) == 0.25
    assert engine.device_re_prob(_ctx(TINY).args, 0.25) == 0.0


def test_the_step_normalises_uint8_batches_as_the_loader_does():
    """A uint8 batch without erasing takes the same step as the batch the
    loader normalises on the host; the JSD loss gets the integer labels."""
    rs = np.random.default_rng(0)
    img = rs.integers(0, 256, (8, 32, 32, 3)).astype(np.uint8)
    mean, std = np.asarray((0.485, 0.456, 0.406)), np.asarray((0.229, 0.224, 0.225))
    host = ((img.astype(np.float32) / 255.0 - mean.astype(np.float32))
            / std.astype(np.float32))
    labels = torch.tensor(rs.integers(0, 8, 8).astype(np.int32))
    results = []
    for image in (torch.from_numpy(img), torch.from_numpy(host)):
        ctx = _ctx(TINY + ["--uint8-pipe"])
        m = ctx.sb.train_step(ctx.state, {"image": image, "label": labels}, 1e-3, r=32)
        results.append((float(m["loss"]), ctx.state.params))
    assert results[0][0] == results[1][0]
    for n, p in results[0][1].items():
        assert torch.equal(p, results[1][1][n]), n
    ctx = _ctx(TINY + ["--aug-splits", "3", "--jsd", "--token-label",
                       "--token-label-data", "synthetic"])
    batch = {"label": labels, "label_scores": torch.rand(8, 5, 2, 2),
             "label_inds": torch.zeros(8, 5, 2, 2, dtype=torch.int32)}
    assert ctx.sb.build_target(batch, 32) is labels


# ------------------------------------------- JAX checkpoints resumed in the port


@pytest.fixture(scope="module")
def jax_variables():
    """volo_h2_l2's variables at 32 px, as the JAX package initialises them."""
    model = jax_create_model("volo_h2_l2").make(num_classes=8, img_size=32,
                                                 dtype=jnp.float32, return_dense=False,
                                                 mix_token=False)
    return jax.jit(lambda: model.init({"params": jax.random.PRNGKey(0)},
                                      jnp.zeros((1, 32, 32, 3)), train=False))()


def _jax_checkpoint(path, args, variables):
    """A JAX TrainState of volo_h2_l2 at 32 px whose optimizer took two
    updates from random gradients, saved by the JAX package's writer."""
    params = variables["params"]
    tx = joptim.create_optimizer(args, params)
    ema_dtype = jnp.bfloat16 if args.model_ema_bf16 else None
    state = JaxTrainState.create(params=params, batch_stats=variables["batch_stats"], tx=tx,
                                 ema_decays=(0.99,), ema_dtype=ema_dtype)
    rs = np.random.default_rng(0)
    opt_state = state.opt_state
    for _ in range(2):
        grads = jax.tree.map(lambda p: jnp.asarray(rs.normal(size=p.shape), jnp.float32),
                             params)
        upd, opt_state = jax.jit(tx.update)(grads, opt_state, params)
        params = optax.apply_updates(params, joptim.apply_lr(upd, 1e-3))
    ema = (jax.tree.map(lambda p: (p * 1.01).astype(ema_dtype or p.dtype), params),)
    state = state.replace(params=params, opt_state=opt_state, ema_params=ema,
                          step=jnp.asarray(2, jnp.int32))
    payload = jax_ckpt.build_payload(state=state, args_text="", arch_name="volo_h2_l2",
                                     stage_info={"r": 32}, ema_decays=(0.99,))
    jax_ckpt.save_checkpoint_file(str(path), dict(payload, epoch=0))
    return state


@pytest.mark.parametrize("opt", ["sgd", "adamw-bf16"])
def test_jax_checkpoint_resumes_with_its_optimizer_state(tmp_path, opt, jax_variables):
    flags = ["--opt", "sgd"] if opt == "sgd" else ["--adam-mu-bf16", "--model-ema-bf16"]
    jargs = argparse.Namespace(opt=opt.split("-")[0], opt_betas=None, opt_eps=None,
                               weight_decay=0.05, clip_grad=None, clip_mode="norm",
                               momentum=0.9, adam_mu_bf16=opt != "sgd",
                               model_ema_bf16=opt != "sgd")
    jstate = _jax_checkpoint(tmp_path / "jax.ckpt", jargs, jax_variables)
    argv = [a if a != "volo_h2_l4" else "volo_h2_l2" for a in TINY] + flags + [
        "--model-ema", "--model-ema-decay", "0.99"]
    ctx = _ctx(argv)
    assert engine.resume_from(ctx, load_checkpoint_file(str(tmp_path / "jax.ckpt"))) == 1
    assert ctx.state.step == 2
    names = {id(p): n for n, p in ctx.state.model.named_parameters()}
    state = {names[id(p)]: s for p, s in ctx.state.optimizer.state.items()}
    assert set(state) == set(names.values())
    if opt == "sgd":
        assert isinstance(ctx.state.optimizer, NesterovSGD)
        trace = next(s for s in jstate.opt_state if hasattr(s, "trace")).trace
        want = {"momentum_buffer": flax_to_torch(jax.tree.map(np.asarray, trace))}
    else:
        assert isinstance(ctx.state.optimizer, AdamWBf16Mu)
        adam = next(s for s in jstate.opt_state if hasattr(s, "mu"))
        want = {"exp_avg": flax_to_torch(jax.tree.map(
                    lambda a: np.asarray(a.astype(jnp.float32)), adam.mu)),
                "exp_avg_sq": flax_to_torch(jax.tree.map(np.asarray, adam.nu))}
        assert {float(s["step"]) for s in state.values()} == {2.0}
        assert {s["exp_avg"].dtype for s in state.values()} == {torch.bfloat16}
    for key, tree in want.items():
        for n, t in tree.items():
            assert torch.equal(state[n][key].float(), t), (key, n)
    ema = flax_to_torch(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                                     jstate.ema_params[0]))
    for n, t in ctx.state.ema_params[0].items():
        assert t.dtype == (torch.float32 if opt == "sgd" else torch.bfloat16)
        assert torch.equal(t.float(), ema[n]), n
    # and the resumed optimizer steps
    m = ctx.sb.train_step(ctx.state, {"image": torch.randn(8, 32, 32, 3),
                                      "label": torch.arange(8, dtype=torch.int32)}, 1e-3, r=32)
    assert math.isfinite(float(m["loss"])) and ctx.state.step == 3
