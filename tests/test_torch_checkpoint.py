"""The port's checkpoint reader and resume against the JAX package's.

  * `train/flax_msgpack.py` decodes what `flax.serialization.msgpack_serialize`
    writes exactly as `flax.serialization.msgpack_restore` does (every
    dtype, nesting, numpy scalars, empty maps, chunked arrays), with
    `msgpack` blocked; the whole reader runs in a process where msgpack,
    flax, jax and the JAX package cannot be imported;
  * a checkpoint written by the JAX package's `main.py` loads into the port
    (both file formats), and the port's resumed train step gives the JAX
    resumed step's parameters within 1e-6 (f32, dropout and drop-path off,
    MixToken's box injected: the tolerance of `test_torch_train_step.py`);
  * the port's own files: resume with and without `--no-resume-opt`,
    recovery files, and a resumed run that equals the uninterrupted one.
"""

import glob
import importlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from autoprog_tpu import engine as jax_engine
from autoprog_tpu import main as jax_main
from autoprog_tpu.config import parse_args as jax_parse_args
from autoprog_tpu.parallel.mesh import shard_batch
from autoprog_tpu.train import checkpoint as jax_ckpt
from autoprog_tpu_torch import engine, main as port_main
from autoprog_tpu_torch.config import parse_args
from autoprog_tpu_torch.convert import flax_to_torch, optax_to_torch_state
from autoprog_tpu_torch.train import flax_msgpack
from autoprog_tpu_torch.train.checkpoint import (CheckpointSaver, get_resume_epoch,
                                                 load_checkpoint_file)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG, NC, B, LR = 32, 8, 8, 1e-3
JAX_RUN = ["synthetic://", "--model", "volo_h2_l2", "--num-classes", str(NC), "--img-size",
           str(IMG), "-b", str(B), "--epochs", "1", "--warmup-epochs", "0",
           "--cooldown-epochs", "0", "--lr", "1e-3", "--workers", "0", "--fake-data-size", "16",
           "--no-bf16", "--token-label", "--token-label-data", "synthetic", "--model-ema",
           "--model-ema-decay", "0.9", "--drop-path", "0.0", "--opt-eps", "1e-3",
           "--clip-grad", "1.0"]
PORT_RUN = ["synthetic://", "--model", "deit_h2_l2", "--num-classes", str(NC), "--img-size",
            str(IMG), "-b", "16", "--warmup-epochs", "0", "--cooldown-epochs", "0", "--lr",
            "1e-3", "--workers", "0", "--fake-data-size", "32", "--no-bf16", "--model-ema",
            "--model-ema-decay", "0.9", "--drop-path", "0.0"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Equal bits from two CPU runs at different times need a fixed
    reduction order: one intra-op thread (MKL hands a loaded machine's
    process fewer threads than asked, and so another order)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def same_tree(want, got, path=""):
    """flax's tree against the decoder's: equal structure and types, equal
    values; bfloat16 leaves come back as float32 of the same values."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(want) == list(got), path
        for k in want:
            same_tree(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(want) == len(got), path
        for i, (a, b) in enumerate(zip(want, got)):
            same_tree(a, b, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        w = np.asarray(want)
        if w.dtype.name == "bfloat16":
            w = w.astype(np.float32)
        else:
            assert type(got) is type(want), (path, type(got), type(want))
        g = np.asarray(got)
        assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype)
        assert np.array_equal(g, w, equal_nan=True), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _trees():
    rs = np.random.default_rng(0)
    dtypes = {np.dtype(t).name: (rs.normal(size=(3, 2)) * 50).astype(t)
              for t in (np.float16, np.float32, np.float64, np.int8, np.int16, np.int32,
                        np.int64, np.uint8, np.uint16, np.uint32, np.uint64, np.complex64,
                        np.complex128)}
    dtypes["bool"] = rs.random((4,)) > 0.5
    dtypes["bfloat16"] = jnp.asarray(rs.normal(size=(2, 5)), jnp.bfloat16)
    dtypes["nan"] = np.array([np.nan, np.inf, -0.0], np.float32)
    return {
        "dtypes": dtypes,
        "nested": {"a": {"b": {"c": {"kernel": rs.normal(size=(4, 3)).astype(np.float32)}},
                         "list": [1, -1, -33, 2 ** 40, -2 ** 40, 2 ** 64 - 1, 0.5, "s", None,
                                  True, False, [2.5, {"x": 1 + 2j}]]},
                   "text": "é" * 40, "raw": b"\x00\xff" * 200},
        "npscalar": {"f": np.float32(1.5), "i": np.int64(-3), "b": np.bool_(True),
                     "u": np.uint8(200), "h": jnp.bfloat16(2.5), "c": np.complex64(1 - 1j)},
        "empty": {"a": {}, "b": {"c": {}, "d": np.zeros((0, 3), np.float32)}, "e": [],
                  "s": "", "z": np.asarray(7, np.int32)},
        "wide": {"map": {f"k{i}": i for i in range(70000)}, "list": list(range(70000)),
                 "bin": bytes(70000), "str": "x" * 70000},
    }


@pytest.mark.parametrize("name", ["dtypes", "nested", "npscalar", "empty", "wide",
                                  "chunked"])
def test_decoder_matches_flax_with_msgpack_blocked(name, monkeypatch):
    if name == "chunked":
        # flax splits leaves over MAX_CHUNK_SIZE bytes into flat chunks
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
        tree = {"big": np.arange(100, dtype=np.float32).reshape(4, 25),
                "n": {"c": np.arange(33, dtype=np.int64), "small": np.ones(3, np.float32)}}
    else:
        tree = _trees()[name]
    blob = serialization.msgpack_serialize(tree)
    want = serialization.msgpack_restore(blob)
    if name == "chunked":
        assert b"__msgpack_chunked_array__" in blob
    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ImportError):
        import msgpack  # noqa: F401
    got = importlib.reload(flax_msgpack).msgpack_restore(blob)
    same_tree(want, got)


@pytest.mark.parametrize("blob, match", [
    (b"\x92\x01", "truncated"),
    (b"\x01\x02", "after the msgpack object"),
    (b"\xc1", "starts no msgpack object"),
    (b"\xd4\x05\x00", "ext type 5"),
    (b"\x82\xb9__msgpack_chunked_array__\xc3\xa5shape\x80", "malformed"),
])
def test_decoder_refuses_malformed_data(blob, match):
    with pytest.raises(flax_msgpack.MsgpackError, match=match):
        flax_msgpack.msgpack_restore(blob)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One JAX `main.py` run (2 steps of volo_h2_l2 at 32 px, token labels,
    one EMA, clip by global norm): its run directory."""
    out = tmp_path_factory.mktemp("jax_run")
    jax_main.main(JAX_RUN + ["--output", str(out)])
    return glob.glob(str(out / "train" / "*"))[0]


def _expected_payload(jtree):
    want = {"state_dict": flax_to_torch(jtree["state_dict"]),
            "batch_stats": flax_to_torch(jtree["batch_stats"]),
            "state_dict_ema_0": flax_to_torch(jtree["state_dict_ema_0"])}
    adam = jtree["optimizer"]["1"]
    assert set(jtree["optimizer"]) == {"0", "1", "2"}          # clip, adam, masked wd
    want["optimizer"] = {"count": int(adam["count"]), "exp_avg": flax_to_torch(adam["mu"]),
                         "exp_avg_sq": flax_to_torch(adam["nu"])}
    return want


def _check_payload(got, want):
    for key in ("state_dict", "batch_stats", "state_dict_ema_0"):
        assert set(got[key]) == set(want[key]), key
        for n, t in want[key].items():
            assert torch.equal(got[key][n], t), (key, n)
    opt = got["optimizer"]
    assert opt["count"] == want["optimizer"]["count"] == 2
    for key in ("exp_avg", "exp_avg_sq"):
        for n, t in want["optimizer"][key].items():
            assert torch.equal(opt[key][n], t), (key, n)


@pytest.mark.parametrize("fmt", ["header", "legacy"])
def test_jax_checkpoint_file_loads_as_the_port_payload(jax_run, tmp_path, fmt):
    path = os.path.join(jax_run, "last.ckpt")
    jtree = jax_ckpt.load_checkpoint_file(path)
    if fmt == "legacy":
        # the JAX package's older files: the msgpack blob alone
        path = str(tmp_path / "legacy.ckpt")
        with open(path, "wb") as f:
            f.write(serialization.msgpack_serialize(
                {k: v for k, v in jtree.items() if k not in ("args_text", "stage_info")}))
    got = load_checkpoint_file(path)
    _check_payload(got, _expected_payload(jtree))
    assert got["arch"] == "volo_h2_l2" and got["epoch"] == 0 and got["step"] == 2
    assert got["state_dict"]["s1b0.attn.qkv.weight"].shape == (3 * 64, 64)   # [out, in]
    assert get_resume_epoch(path) == 1


def test_checkpoint_reader_needs_no_msgpack_flax_or_jax(jax_run):
    """In a process where msgpack, flax, jax, optax and the JAX package
    cannot be imported, the port reads the JAX package's file."""
    path = os.path.join(jax_run, "last.ckpt")
    want = _expected_payload(jax_ckpt.load_checkpoint_file(path))
    code = (
        "import json, sys\n"
        "for m in ('msgpack', 'flax', 'jax', 'jaxlib', 'optax', 'autoprog_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from autoprog_tpu_torch.train.checkpoint import load_checkpoint_file\n"
        f"ck = load_checkpoint_file({path!r})\n"
        "out = {k: {n: float(t.double().sum()) for n, t in ck[k].items()}\n"
        "       for k in ('state_dict', 'batch_stats', 'state_dict_ema_0')}\n"
        "out['count'] = ck['optimizer']['count']\n"
        "out['nu'] = {n: float(t.double().sum()) for n, t in ck['optimizer']['exp_avg_sq'].items()}\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    for key in ("state_dict", "batch_stats", "state_dict_ema_0"):
        assert got[key] == {n: float(t.double().sum()) for n, t in want[key].items()}
    assert got["count"] == 2
    assert got["nu"] == {n: float(t.double().sum())
                         for n, t in want["optimizer"]["exp_avg_sq"].items()}


@pytest.mark.parametrize("opt, clip", [("adamw", "norm"), ("adamw", None), ("adam", "agc"),
                                       ("sgd", None)])
def test_optax_chain_is_walked_to_its_adam_state(opt, clip):
    import types
    from autoprog_tpu.train import optim as joptim
    args = types.SimpleNamespace(opt=opt, opt_betas=None, opt_eps=None, weight_decay=0.05,
                                 clip_grad=None if clip is None else 1.0, clip_mode=clip,
                                 momentum=0.9, adam_mu_bf16=False)
    rs = np.random.default_rng(1)
    params = {"fc": {"kernel": jnp.asarray(rs.normal(size=(3, 4)), jnp.float32),
                     "bias": jnp.zeros(4)}}
    tx = joptim.create_optimizer(args, params)
    grads = jax.tree.map(lambda p: jnp.ones_like(p) * 0.5, params)
    _, opt_state = tx.update(grads, tx.init(params), params)
    tree = serialization.msgpack_restore(serialization.msgpack_serialize(
        serialization.to_state_dict(opt_state)))
    got = optax_to_torch_state(tree)
    if opt == "sgd":
        trace = next(s for s in opt_state if hasattr(s, "trace")).trace
        assert set(got) == {"momentum_buffer"}
        np.testing.assert_array_equal(got["momentum_buffer"]["fc.weight"].numpy(),
                                      np.asarray(trace["fc"]["kernel"]).T)
        np.testing.assert_array_equal(got["momentum_buffer"]["fc.bias"].numpy(),
                                      np.asarray(trace["fc"]["bias"]))
        return
    adam = next(s for s in opt_state if hasattr(s, "mu"))
    assert got["count"] == 1
    np.testing.assert_array_equal(got["exp_avg"]["fc.weight"].numpy(),
                                  np.asarray(adam.mu["fc"]["kernel"]).T)
    np.testing.assert_array_equal(got["exp_avg_sq"]["fc.bias"].numpy(),
                                  np.asarray(adam.nu["fc"]["bias"]))


def test_port_resumes_the_jax_run_and_steps_like_it(jax_run, monkeypatch):
    """Both packages resume the JAX run's last.ckpt and take the same step:
    the parameters, EMA tree and Adam moments after it agree within 1e-6."""
    monkeypatch.setenv("AUTOPROG_TORCH_DEVICE", "cpu")
    path = os.path.join(jax_run, "last.ckpt")
    rs = np.random.default_rng(3)
    scores = rs.random((B, 5, 14, 14)).astype(np.float32)
    scores /= scores.sum(1, keepdims=True) * 1.25
    batch = {"image": rs.normal(size=(B, IMG, IMG, 3)).astype(np.float32),
             "label": rs.integers(0, NC, B).astype(np.int32), "label_scores": scores,
             "label_inds": rs.integers(0, NC, (B, 5, 14, 14)).astype(np.int32)}

    jargs, jtext = jax_parse_args(JAX_RUN, prog=False)
    jargs.token_label_size = IMG // 16
    jctx = jax_engine.setup(jargs, jtext, prog=False)
    assert jax_engine.resume_from(jctx, path) == 1
    jstate = jctx.state
    jbatch = shard_batch(jctx.mesh, batch)
    rng = jax.random.fold_in(jctx.rng, jstate.step)
    out, _ = jax.jit(lambda p, s, x: jctx.sb._apply_train(p, s, x, rng, None))(
        jstate.params, jstate.batch_stats, jbatch["image"])
    jnew, jm = jctx.sb.train_step(r=IMG)(jstate, jbatch, LR, jctx.rng)

    args, text = parse_args(JAX_RUN, prog=False)
    args.token_label_size = IMG // 16
    ctx = engine.setup(args, text)
    assert engine.resume_from(ctx, load_checkpoint_file(path)) == 1
    assert ctx.state.step == 2
    steps = {float(s["step"]) for s in ctx.state.optimizer.state.values()}
    assert steps == {2.0}
    tm = ctx.sb.train_step(ctx.state, {k: torch.from_numpy(v) for k, v in batch.items()}, LR,
                           r=IMG, bbox=torch.tensor(np.asarray(out[2])))
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert ctx.state.step == int(jnew.step) == 3
    want = flax_to_torch(jnew.params)
    for name, p in ctx.state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
    want_ema = flax_to_torch(jnew.ema_params[0])
    for name, t in ctx.state.ema_params[0].items():
        np.testing.assert_allclose(t.numpy(), want_ema[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
    adam = optax_to_torch_state(serialization.to_state_dict(
        jax.tree.map(np.asarray, jnew.opt_state)))
    names = {id(p): n for n, p in ctx.state.model.named_parameters()}
    for p, s in ctx.state.optimizer.state.items():
        assert float(s["step"]) == adam["count"] == 3
        np.testing.assert_allclose(s["exp_avg"].numpy(), adam["exp_avg"][names[id(p)]].numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=names[id(p)])


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port's DeiT run of 2 epochs, with a recovery file every step."""
    os.environ["AUTOPROG_TORCH_DEVICE"] = "cpu"
    try:
        out = tmp_path_factory.mktemp("port_run")
        port_main.main(PORT_RUN + ["--epochs", "2", "--recovery-interval", "1",
                                   "--output", str(out)])
    finally:
        del os.environ["AUTOPROG_TORCH_DEVICE"]
    return glob.glob(str(out / "train" / "*"))[0]


@pytest.mark.parametrize("restore_opt", [True, False], ids=["restore_opt", "no_resume_opt"])
def test_port_round_trip(port_run, restore_opt, monkeypatch):
    monkeypatch.setenv("AUTOPROG_TORCH_DEVICE", "cpu")
    run = port_run
    saver = CheckpointSaver(checkpoint_dir=run)
    recovery = saver.find_recovery()
    assert os.path.basename(recovery) == "recovery-1-1.ckpt"
    assert glob.glob(os.path.join(run, "recovery-*.ckpt")) == [recovery]
    assert get_resume_epoch(recovery) == 2
    ckpt = load_checkpoint_file(os.path.join(run, "checkpoint-0.ckpt"))
    flags = [] if restore_opt else ["--no-resume-opt"]
    args, text = parse_args(PORT_RUN + ["--epochs", "2"] + flags, prog=False)
    args.token_label_size = IMG // 16
    ctx = engine.setup(args, text)
    assert engine.resume_from(ctx, ckpt) == 1
    state = ctx.state
    assert state.step == ckpt["step"] == 2
    for n, p in state.params.items():
        assert torch.equal(p.detach(), ckpt["state_dict"][n]), n
        assert torch.equal(state.ema_params[0][n], ckpt["state_dict_ema_0"][n]), n
    saved = ckpt["optimizer"]["state"]
    if restore_opt:
        got = state.optimizer.state_dict()["state"]
        assert set(got) == set(saved)
        for i in saved:
            for key in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(got[i][key], saved[i][key]), (i, key)
        assert state.optimizer.param_groups[0]["weight_decay"] == args.weight_decay
    else:
        assert not state.optimizer.state


def test_resumed_run_equals_the_uninterrupted_one(port_run, tmp_path, monkeypatch):
    """Epoch 1 resumed from epoch 0's checkpoint gives the uninterrupted
    run's parameters bit for bit (no drop-path, no mixup: the only
    randomness is the data order and augmentation, seeded by the epoch)."""
    monkeypatch.setenv("AUTOPROG_TORCH_DEVICE", "cpu")
    resumed = port_main.main(PORT_RUN + [
        "--epochs", "2", "--resume", os.path.join(port_run, "checkpoint-0.ckpt"),
        "--output", str(tmp_path)])
    assert resumed is not None
    got = load_checkpoint_file(glob.glob(str(tmp_path / "train" / "*" / "last.ckpt"))[0])
    want = load_checkpoint_file(os.path.join(port_run, "last.ckpt"))
    assert got["epoch"] == want["epoch"] == 1 and got["step"] == want["step"] == 4
    for key in ("state_dict", "state_dict_ema_0"):
        for n, t in want[key].items():
            assert torch.equal(got[key][n], t), (key, n)


def test_restore_refuses_a_checkpoint_of_another_arch(port_run, monkeypatch):
    monkeypatch.setenv("AUTOPROG_TORCH_DEVICE", "cpu")
    from autoprog_tpu_torch.train.checkpoint import restore_state
    ckpt = load_checkpoint_file(os.path.join(port_run, "last.ckpt"))
    args, text = parse_args(PORT_RUN + ["--model", "deit_h2_l4"], prog=False)
    ctx = engine.setup(args, text)
    with pytest.raises(KeyError, match="does not fit the model"):
        restore_state(ckpt, ctx.state)
