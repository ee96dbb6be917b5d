"""Data parallelism of the port across two processes (gloo, on the CPU).

The counterpart of tests/test_multiprocess.py for `autoprog_tpu_torch`, and
the parity of the port's data-parallel step with the JAX package's step on
the global batch. Two worker processes, this file run as a script
(`python tests/test_torch_dist.py worker <dir>`, with torchrun's environment
set by the test), join one gloo group and write what they saw to <dir>:

  (a) the primitives: `sync_decision` adopts rank 0's different proposal on
      both ranks; the loader's shards are the disjoint strided split of
      `np.random.default_rng(seed + epoch).permutation(n)` with drop_last;
      the epoch-seeded candidate draws are identical; `replicate` gives
      every rank rank 0's parameters;
  (b) one train step of volo_h2_l4 at 64 px, f32, global batch 8 (4 a
      rank), dense token labels, the MixToken box JAX drew, AdamW at eps
      1e-3 and 4 EMA decays, from parameters the test wrote as numpy;
  (c) the synced BatchNorm alone on a [8, 6, 5, 5] batch split over the
      ranks;
  (d) `main_prog.main --auto-grow` on tests/mp_trainer_worker.py's tiny
      config with one EMA tree stored in bf16 (`--model-ema-bf16`: its
      stochastic rounding must draw the same dither on every rank), through
      a grow boundary.

A last case runs `autoprog_tpu_torch/scripts/dp_parity.py` on the CPU: the
clean 2-rank step keeps `chip_smoke.py` phase 11 (c)'s limits and each of its
planted faults breaks them.

The test process holds (b) against the JAX step on the whole batch at the
tolerances of test_torch_train_step.py (loss rel 1e-5; gradients and
BatchNorm statistics rtol 1e-4 / atol 1e-5; parameters and EMA trees atol
1e-6), (c) against one process on the concatenated batch (rtol 1e-5) and
(d) for one decision, one stage history and bit-equal states on both ranks,
with checkpoint files written by rank 0 alone. Each worker has 120 s and one
intra-op thread.
"""

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

NPROC = 2
IMG, NC, B, LR = 64, 10, 8, 1e-3
DECAYS = (0.998, 0.9986, 0.999, 0.9996)
TIMEOUT = 120
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TRAINER_ARGV = [
    "synthetic://", "--model", "volo_h2_l4", "--num-classes", "10",
    "--img-size", "32", "-b", "32", "--epochs", "3",
    "--warmup-epochs", "1", "--cooldown-epochs", "0", "--workers", "0",
    "--fake-data-size", "64", "--no-bf16", "--num-stages", "2",
    "--r-scale", "0.5", "--l-scale", "0.5", "--drop-path", "0.0",
    "--auto-grow", "--search-epochs", "1", "--search-probe-steps", "2",
    "--search-time-iters", "2", "--load-with-clone", "--seed", "11",
    "--model-ema", "--model-ema-decay", "0.99", "--model-ema-bf16",
]


def step_args():
    """The step's flags, for both packages' loss and optimizer builders."""
    return argparse.Namespace(
        opt="adamw", opt_eps=1e-3, opt_betas=None, momentum=0.9, weight_decay=0.05,
        clip_grad=None, clip_mode="norm", token_label=True, token_label_data="synthetic",
        token_label_size=IMG // 16, dense_weight=0.5, cls_weight=1.0, ground_truth=False,
        smoothing=0.1)


def make_batch(seed=0):
    rs = np.random.default_rng(seed)
    scores = rs.random((B, 5, 14, 14)).astype(np.float32)
    scores /= scores.sum(1, keepdims=True) * 1.25
    return {"image": rs.normal(size=(B, IMG, IMG, 3)).astype(np.float32),
            "label": rs.integers(0, NC, B).astype(np.int32),
            "label_scores": scores,
            "label_inds": rs.integers(0, NC, (B, 5, 14, 14)).astype(np.int32)}


def bn_inputs():
    rs = np.random.default_rng(5)
    x = (rs.normal(size=(8, 6, 5, 5)) * 2 + 1).astype(np.float32)
    return {"x": x, "w_out": rs.normal(size=x.shape).astype(np.float32),
            "weight": rs.normal(size=6).astype(np.float32),
            "bias": rs.normal(size=6).astype(np.float32)}


def run_bn(x, w_out, weight, bias):
    """The port's BatchNorm in train mode on `x`, loss sum(y * w_out):
    output, input gradient, weight and bias gradients (summed over the
    ranks under a group), running statistics."""
    from autoprog_tpu_torch.models.layers import BatchNorm
    from autoprog_tpu_torch.parallel import mesh
    bn = BatchNorm(6, torch.float32)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt, train=True)
    (y * torch.from_numpy(w_out)).sum().backward()
    dw, db = bn.weight.grad, bn.bias.grad
    if mesh.process_group_active():
        dw, db = mesh.all_reduce_sum([dw, db])
    return {"y": y.detach().numpy(), "dx": xt.grad.numpy(), "dw": dw.numpy(),
            "db": db.numpy(), "rm": bn.running_mean.numpy(), "rv": bn.running_var.numpy()}


def state_digest(ctx) -> str:
    """sha256 of every parameter, buffer and EMA tree of a trainer's state."""
    h = hashlib.sha256()
    trees = [dict(ctx.state.model.named_parameters()), dict(ctx.state.model.named_buffers()),
             *ctx.state.ema_params]
    for tree in trees:
        for name in sorted(tree):
            h.update(name.encode())
            t = tree[name].detach().cpu().contiguous()
            h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes())
    return h.hexdigest()


# ------------------------------------------------------------------ worker


def worker(out_dir: str) -> None:
    torch.set_num_threads(1)
    from autoprog_tpu_torch import main_prog
    from autoprog_tpu_torch.data.loader import Loader
    from autoprog_tpu_torch.parallel import mesh
    from autoprog_tpu_torch.prog import autogrow
    assert mesh.maybe_init_distributed()
    rank, world = mesh.process_index(), mesh.process_count()
    res = {"rank": rank, "world": world, "backend": torch.distributed.get_backend()}

    # (a) the primitives; each rank proposes another decision
    res["synced"] = list(autogrow.sync_decision(128 + 32 * rank, 9 + 3 * rank))

    class _IndexOnly:
        def __len__(self):
            return 103
    loader = Loader(_IndexOnly(), batch_size=4, is_training=True, transform=None,
                    num_workers=0, seed=7, process_index=rank, process_count=world)
    loader.set_epoch(3)
    res["shard"] = loader._indices().tolist()
    res["shard_again"] = loader._indices().tolist()
    sampler = np.random.RandomState(3)
    res["cfgs"] = [int(sampler.choice([9, 12, 15])) for _ in range(20)]
    torch.manual_seed(100 + rank)
    lin = torch.nn.Linear(3, 2)
    mesh.replicate(lin)
    res["replicated"] = [float(v) for v in torch.cat([lin.weight.flatten(), lin.bias])]

    # (c) the synced BatchNorm on this rank's rows
    rows = mesh.process_batch_slice(8)
    bn = run_bn(**{k: v[rows] if k in ("x", "w_out") else v for k, v in bn_inputs().items()})
    np.savez(os.path.join(out_dir, f"bn{rank}.npz"), **bn)

    # (b) one data-parallel train step on this rank's rows of the batch
    from autoprog_tpu_torch import create_model
    from autoprog_tpu_torch.losses import build_train_loss
    from autoprog_tpu_torch.train.optim import create_optimizer
    from autoprog_tpu_torch.train.state import TrainState
    from autoprog_tpu_torch.train.steps import StepBuilder
    inp = np.load(os.path.join(out_dir, "step_in.npz"))
    model = create_model("volo_h2_l4").make(num_classes=NC, img_size=IMG, dtype=torch.float32)
    model.load_state_dict({k[2:]: torch.from_numpy(inp[k]) for k in inp.files
                           if k.startswith("p.")})
    args = step_args()
    state = TrainState.create(model=model, optimizer=create_optimizer(args, model),
                              ema_decays=DECAYS)
    sb = StepBuilder(train_loss=build_train_loss(args), ema_decays=DECAYS, num_classes=NC,
                     token_label=True, has_token_label_data=True)
    grads = {}
    optimizer_step = state.optimizer.step

    def step_and_record():
        grads.update({"g." + n: p.grad.numpy().copy() for n, p in model.named_parameters()})
        optimizer_step()
    state.optimizer.step = step_and_record
    rows = mesh.process_batch_slice(B)
    batch = {k[2:]: torch.from_numpy(inp[k][rows]) for k in inp.files if k.startswith("b.")}
    m = sb.train_step(state, batch, LR, r=IMG, bbox=torch.from_numpy(inp["bbox"]))
    out = {"loss": mesh.mean_over_ranks(m["loss"]).numpy(), **grads}
    out.update({"p." + n: t.detach().numpy() for n, t in state.params.items()})
    out.update({"s." + n: t.numpy() for n, t in state.batch_stats.items()})
    for i, tree in enumerate(state.ema_params):
        out.update({f"e{i}." + n: t.numpy() for n, t in tree.items()})
    np.savez(os.path.join(out_dir, f"step{rank}.npz"), **out)

    # (d) the progressive trainer with the search through a grow boundary
    decisions = []
    sync = autogrow.sync_decision

    def recorded(r, l):
        synced = sync(r, l)
        decisions.append([[r, l], list(synced)])
        return synced
    autogrow.sync_decision = recorded
    run_dir = os.path.join(out_dir, f"out{rank}")
    os.makedirs(run_dir)
    main_prog.main(TRAINER_ARGV + ["--output", run_dir])
    ctx = main_prog.LAST_CTX
    res["decisions"] = decisions
    res["history"] = [{k: (list(v) if isinstance(v, tuple) else v) for k, v in h.items()}
                      for h in ctx.stage_history]
    res["arch"] = ctx.mdef.name
    res["checksum"] = float(sum(p.detach().double().abs().sum()
                                for p in ctx.state.model.parameters()))
    res["digest"] = state_digest(ctx)
    res["ema_dtypes"] = sorted({str(t.dtype) for tree in ctx.state.ema_params
                                for t in tree.values()})
    res["files"] = sorted(os.path.relpath(os.path.join(d, f), run_dir)
                          for d, _, fs in os.walk(run_dir) for f in fs)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f, default=float)
    mesh.destroy()


# --------------------------------------------------------------- the test


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_step_inputs(out_dir):
    """The JAX model's initial variables, the batch and the MixToken box of
    JAX's first step; the port's copies are written to step_in.npz."""
    import jax
    import jax.numpy as jnp
    from autoprog_tpu.losses import build_train_loss as jax_build_train_loss
    from autoprog_tpu.registry import create_model as jax_create_model
    from autoprog_tpu.train import optim as joptim
    from autoprog_tpu.train.steps import StepBuilder as JaxStepBuilder
    from autoprog_tpu_torch.convert import flax_to_torch
    args = step_args()
    jmodel = jax_create_model("volo_h2_l4").make(num_classes=NC, img_size=IMG,
                                                 dtype=jnp.float32)
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
    return dict(jsb=jsb, tx=tx, params=params, bs=bs, jbatch=jbatch, rng=rng,
                step_rng=step_rng)


def _jax_step(j):
    """JAX's loss, gradients and state after one step on the whole batch."""
    import jax
    from autoprog_tpu.train.state import TrainState as JaxTrainState
    jsb, params, bs, jbatch = j["jsb"], j["params"], j["bs"], j["jbatch"]
    target = jsb._build_target(jbatch, IMG)

    def loss_fn(p):
        out, _ = jsb._apply_train(p, bs, jbatch["image"], j["step_rng"], None)
        return jsb.train_loss(out, target)
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    jstate = JaxTrainState.create(params=params, batch_stats=bs, tx=j["tx"],
                                  ema_decays=DECAYS)
    jnew, _ = jsb.train_step(r=IMG)(jstate, jbatch, LR, j["rng"])
    return dict(loss=float(jloss), grads=jgrads, new=jnew)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both workers' results and the JAX step, computed while they run."""
    out_dir = str(tmp_path_factory.mktemp("dist"))
    j = _jax_step_inputs(out_dir)
    port = str(_free_port())
    procs = []
    for rank in range(NPROC):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(NPROC), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port, AUTOPROG_TORCH_DEVICE="cpu",
                   OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep +
                   os.environ.get("PYTHONPATH", ""))
        env.pop("AUTOPROG_DIST_BACKEND", None)
        # the log goes to a file: a full pipe would stall one rank and, at
        # its next collective, the other
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "worker", out_dir],
                stdout=subprocess.DEVNULL, stderr=err, env=env))
    jax_out = _jax_step(j)
    for rank, p in enumerate(procs):
        try:
            p.wait(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.wait()
            raise
        with open(os.path.join(out_dir, f"rank{rank}.err")) as f:
            assert p.returncode == 0, f"rank {rank} failed:\n{f.read()[-6000:]}"
    results = []
    for rank in range(NPROC):
        with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
            results.append(json.load(f))
    return dict(dir=out_dir, res=results, jax=jax_out)


def _npz(ranks, name, rank):
    return np.load(os.path.join(ranks["dir"], f"{name}{rank}.npz"))


def test_decision_shards_and_draws_agree(ranks):
    res = ranks["res"]
    assert [d["rank"] for d in res] == [0, 1]
    assert all(d["world"] == NPROC and d["backend"] == "gloo" for d in res)
    # the broadcast: both adopt rank 0's (different) proposal
    assert all(d["synced"] == [128, 9] for d in res)
    order = np.random.default_rng(7 + 3).permutation(103)
    for d in res:
        mine = order[d["rank"]::NPROC]
        mine = mine[: (len(mine) // 4) * 4]          # drop_last, batch 4
        assert d["shard"] == mine.tolist() == d["shard_again"]
    assert not set(res[0]["shard"]) & set(res[1]["shard"])
    assert res[0]["cfgs"] == res[1]["cfgs"]
    assert res[0]["replicated"] == res[1]["replicated"]


def test_synced_batchnorm_equals_one_process(ranks):
    inp = bn_inputs()
    want = run_bn(**inp)
    got = [_npz(ranks, "bn", r) for r in range(NPROC)]
    for key in ("y", "dx"):
        np.testing.assert_allclose(np.concatenate([g[key] for g in got]), want[key],
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    for key in ("dw", "db", "rm", "rv"):
        for g in got:
            np.testing.assert_allclose(g[key], want[key], rtol=1e-5, atol=1e-6, err_msg=key)


def _close(got, want, prefix, **tol):
    names = [k for k in got.files if k.startswith(prefix)]
    assert sorted(n[len(prefix):] for n in names) == sorted(want)
    for name in names:
        np.testing.assert_allclose(got[name], want[name[len(prefix):]].numpy(),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("rank", range(NPROC))
def test_two_rank_step_equals_the_jax_step_on_the_global_batch(ranks, rank):
    from autoprog_tpu_torch.convert import flax_to_torch
    got, j = _npz(ranks, "step", rank), ranks["jax"]
    assert float(got["loss"]) == pytest.approx(j["loss"], rel=1e-5)
    _close(got, flax_to_torch(j["grads"]), "g.", rtol=1e-4, atol=1e-5)
    _close(got, flax_to_torch(j["new"].params), "p.", rtol=0, atol=1e-6)
    _close(got, flax_to_torch({}, j["new"].batch_stats), "s.", rtol=1e-4, atol=1e-5)
    for i in range(len(DECAYS)):
        _close(got, flax_to_torch(j["new"].ema_params[i]), f"e{i}.", rtol=0, atol=1e-6)


def test_two_rank_step_leaves_the_ranks_bit_equal(ranks):
    a, b = (_npz(ranks, "step", r) for r in range(NPROC))
    assert a.files == b.files
    for name in a.files:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_two_rank_auto_grow_follows_rank_0(ranks):
    r0, r1 = ranks["res"]
    assert len(r0["decisions"]) == 1
    assert r0["decisions"][0][1] == r0["decisions"][0][0]         # rank 0's own proposal
    assert r1["decisions"][0][1] == r0["decisions"][0][0]
    assert r0["history"] == r1["history"] and len(r0["history"]) >= 2
    assert r0["arch"] == r1["arch"] == "volo_h2_l4"
    assert r0["ema_dtypes"] == r1["ema_dtypes"] == ["torch.bfloat16"]
    assert r0["checksum"] == r1["checksum"] and r0["digest"] == r1["digest"]
    assert {"last.ckpt", "last-search.ckpt", "summary.csv", "args.yaml"} <= \
        {os.path.basename(f) for f in r0["files"]}
    assert r1["files"] == []


def test_parity_limits_catch_planted_faults(tmp_path):
    """`scripts/dp_parity.py` (the readings behind `chip_smoke.py` phase 11
    (c)'s limits) on the CPU at volo_h2_l4's size: the clean 2-rank step
    keeps the limits, and each planted fault, BatchNorm's backward left local
    or the gradient all-reduce skipped, breaks them."""
    from autoprog_tpu_torch.scripts import dp_parity
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "AUTOPROG_DIST_BACKEND"):
        env.pop(k, None)
    res = subprocess.run(
        [sys.executable, "-m", "autoprog_tpu_torch.scripts.dp_parity", "--device", "cpu",
         "--model", "volo_h2_l4", "--img-size", str(IMG), "--num-classes", str(NC),
         "--batch", str(B), "--seeds", "0", "--out", str(tmp_path), "--timeout", str(TIMEOUT)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=TIMEOUT + 30)
    assert res.returncode == 0, res.stderr[-4000:]
    rows = {r["plant"]: r for r in json.loads(res.stdout.strip().splitlines()[-1])["rows"]}
    assert set(rows) == {"none", *dp_parity.PLANTS}
    assert rows["none"]["within"] and rows["none"]["loss_rel"] < 1e-5
    assert not rows["local-bn-backward"]["within"]
    assert rows["local-bn-backward"]["worst_stem"][1] > dp_parity.RTOL_STEM
    assert rows["local-bn-backward"]["worst_rest"][1] <= dp_parity.RTOL_ALL
    assert rows["no-grad-all-reduce"]["grad_total"] > dp_parity.RTOL_ALL


def _clear_torchrun_env(monkeypatch):
    from autoprog_tpu_torch.parallel import mesh
    for k in mesh.TORCHRUN_ENV + (mesh.BACKEND_ENV,):
        monkeypatch.delenv(k, raising=False)


def test_one_process_without_torchrun_env(monkeypatch):
    """No torchrun environment: no group, rank 0 of 1, MixToken's flip is
    the local one and the grow decision is the proposal."""
    from autoprog_tpu_torch.parallel import mesh
    from autoprog_tpu_torch.prog import autogrow
    _clear_torchrun_env(monkeypatch)
    assert not mesh.maybe_init_distributed()
    assert (mesh.process_index(), mesh.process_count(), mesh.is_primary()) == (0, 1, True)
    assert mesh.process_batch_slice(8) == slice(0, 8)
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(mesh.flip_batch(x), torch.flip(x, dims=(0,)))
    assert autogrow.sync_decision(160, 12) == (160, 12)


@pytest.mark.parametrize("env,error", [
    ({"WORLD_SIZE": "2"}, RuntimeError),                       # torchrun's other keys missing
    ({"AUTOPROG_DIST_BACKEND": "nccl"}, ValueError),           # NCCL on the CPU
    ({"AUTOPROG_DIST_BACKEND": "mpi"}, ValueError),
])
def test_bad_process_group_settings_raise(monkeypatch, env, error):
    """Nothing switches backend or device quietly: a torchrun environment
    that is incomplete, or a backend that does not fit the device, raises
    before any group exists."""
    from autoprog_tpu_torch.parallel import mesh
    _clear_torchrun_env(monkeypatch)
    full = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": "1"}
    for k, v in (env if "WORLD_SIZE" in env else {**full, **env}).items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("AUTOPROG_TORCH_DEVICE", "cpu")
    with pytest.raises(error):
        mesh.maybe_init_distributed()
    assert not mesh.process_group_active()


if __name__ == "__main__":
    if sys.argv[1:2] == ["worker"]:
        worker(sys.argv[2])
    else:
        sys.exit(f"usage: {sys.argv[0]} worker <dir>")
