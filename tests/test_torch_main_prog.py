"""The port's progressive trainer end to end on the CPU, against the JAX
package's.

  * manual growth (`--num-stages 2 --r-scale 0.5 --l-scale 0.5
    --load-with-clone`): the traversed `stage_history` is deterministic and
    equals the JAX run's entry for entry; the last checkpoint records the
    full arch;
  * `--auto-grow`: the search runs, decides, shrinks or grows and trains on.
    The decision depends on measured step times, so it is held to the
    candidate window, not to the JAX run;
  * one train step after a "clone" growth gives the same loss in both
    packages on converted parameters (rel 1e-5, the tolerance of
    `tests/test_torch_train_step.py`: the same f32 formulas in another order).
"""

import glob
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoprog_tpu import main_prog as jax_main_prog
from autoprog_tpu.losses import build_train_loss as jax_build_train_loss
from autoprog_tpu.prog import growth as jgrowth
from autoprog_tpu.registry import create_model as jax_create_model
from autoprog_tpu.train import optim as joptim
from autoprog_tpu.train.state import TrainState as JaxTrainState
from autoprog_tpu.train.steps import StepBuilder as JaxStepBuilder
from autoprog_tpu_torch import create_model, main_prog
from autoprog_tpu_torch.convert import flax_to_torch
from autoprog_tpu_torch.losses import build_train_loss
from autoprog_tpu_torch.prog import autogrow, growth
from autoprog_tpu_torch.train import optim as toptim
from autoprog_tpu_torch.train.state import TrainState
from autoprog_tpu_torch.train.steps import StepBuilder

MANUAL = ["synthetic://", "--model", "volo_h2_l4", "--num-classes", "10",
          "--img-size", "64", "-b", "32", "--epochs", "4", "--warmup-epochs", "1",
          "--cooldown-epochs", "0", "--workers", "0", "--fake-data-size", "128",
          "--no-bf16", "--num-stages", "2", "--r-scale", "0.5", "--l-scale", "0.5",
          "--drop-path", "0.0", "--load-with-clone", "--model-ema"]
AUTO = ["synthetic://", "--model", "volo_h2_l4", "--num-classes", "8", "-b", "16",
        "--warmup-epochs", "1", "--cooldown-epochs", "0", "--lr", "1e-3", "--workers", "0",
        "--fake-data-size", "64", "--no-bf16", "--img-size", "64", "--epochs", "4",
        "--num-stages", "2", "--r-scale", "0.5", "--l-scale", "0.5", "--drop-path", "0.0",
        "--auto-grow", "--search-epochs", "1", "--search-probe-steps", "2",
        "--load-with-clone-ema", "--model-ema", "--model-ema-decay", "0.9", "0.95",
        "0.99", "0.995"]


def plain(entry):
    """A stage_history entry with numpy scalars as Python values."""
    def conv(v):
        if isinstance(v, (tuple, list)):
            return tuple(conv(x) for x in v)
        return v.item() if isinstance(v, np.generic) else v
    return {k: conv(v) for k, v in entry.items()}


@pytest.fixture
def cpu_port(monkeypatch):
    monkeypatch.setenv("AUTOPROG_TORCH_DEVICE", "cpu")


def test_auto_grow_full_pipeline(cpu_port, tmp_path):
    best = main_prog.main(AUTO + ["--output", str(tmp_path)])
    assert best is not None
    run = str(tmp_path / "train" / "*")
    assert glob.glob(run + "/last-search.ckpt") and glob.glob(run + "/last.ckpt")
    search = torch.load(glob.glob(run + "/last-search.ckpt")[0], weights_only=False)
    assert search["arch"] == "volo_h2_l4" and search["stage_info"]["supernet"] is True
    log = open(glob.glob(run + "/log.txt")[0]).read()
    decisions = [ln.split("autoprog_tpu_torch: ")[-1] for ln in log.splitlines()
                 if "auto grow decision" in ln]
    assert len(decisions) == 1
    hist = main_prog.LAST_CTX.stage_history
    r_list, _, l_list = autogrow.candidate_window((32, 64), (2, 2), (2, 4), 32, 2, 2, 0)
    chosen = hist[1]
    assert decisions[0] == f"auto grow decision: r={chosen['r']} l={chosen['l']}"
    assert chosen["r"] in r_list and chosen["l"] in l_list
    assert (hist[-1]["r"], hist[-1]["l"]) == (64, 4)
    assert torch.load(glob.glob(run + "/last.ckpt")[0], weights_only=False)["arch"] == \
        "volo_h2_l4"


def test_manual_growth_walks_the_jax_stage_history(cpu_port, tmp_path):
    best = main_prog.main(MANUAL + ["--output", str(tmp_path / "torch")])
    assert best is not None
    got = [plain(e) for e in main_prog.LAST_CTX.stage_history]
    jax_main_prog.main(MANUAL + ["--output", str(tmp_path / "jax")])
    want = [plain(e) for e in jax_main_prog.LAST_CTX.stage_history]
    assert got == want
    assert [(e["epoch"], e["r"], e["l"]) for e in got] == [(0, 32, 2), (0, 32, 2), (2, 64, 4)]
    last = glob.glob(str(tmp_path / "torch" / "train" / "*" / "last.ckpt"))[0]
    ckpt = torch.load(last, weights_only=False)
    assert ckpt["arch"] == "volo_h2_l4"
    assert ckpt["stage_info"]["l"] == 4 and ckpt["stage_info"]["r"] == 64
    assert ckpt["step"] == 16                       # 4 epochs x 4 steps, carried on
    assert set(ckpt["state_dict_ema_0"]) == set(ckpt["state_dict"])
    assert any(k.startswith("s1b1.") for k in ckpt["state_dict"])


@pytest.mark.parametrize("flags", [["--resume", "x.ckpt"], ["--finetune", "x.ckpt"],
                                   ["--initial-checkpoint", "x"]])
def test_main_prog_refuses_flags_that_are_not_ported(flags):
    with pytest.raises(NotImplementedError, match="not ported"):
        main_prog.main(["synthetic://", "--model", "volo_h2_l4"] + flags)


def test_variant_aliases_are_the_jax_ones():
    assert main_prog._VARIANT_ALIASES == jax_main_prog._VARIANT_ALIASES


def test_train_step_after_clone_growth_matches_jax():
    IMG, NC, B, LR = 64, 10, 4, 1e-3
    args = types.SimpleNamespace(
        opt="adamw", opt_eps=1e-3, opt_betas=None, momentum=0.9, weight_decay=0.05,
        clip_grad=None, clip_mode="norm", token_label=True, token_label_data="synthetic",
        token_label_size=IMG // 16, dense_weight=0.5, cls_weight=1.0, ground_truth=False,
        smoothing=0.1)

    def jinit(name, seed):
        mdef = jax_create_model(name)
        model = mdef.make(num_classes=NC, img_size=IMG, dtype=jnp.float32)
        v = jax.jit(lambda: model.init({"params": jax.random.PRNGKey(seed)},
                                       jnp.zeros((1, IMG, IMG, 3)), train=False))()
        return tuple(mdef.arch.layers), model, v["params"], v["batch_stats"]

    sl, _, sp, ss = jinit("volo_h2_l2", 0)
    bl, jmodel, bp, bs = jinit("volo_h4_l4", 1)
    jparams = jgrowth.grow_params(sp, bp, src_layers=sl, dst_layers=bl, mode="clone")
    jstats = jgrowth.grow_batch_stats(ss, bs, src_layers=sl, dst_layers=bl)
    tx = joptim.create_optimizer(args, jparams)
    jsb = JaxStepBuilder(model=jmodel, tx=tx, train_loss=jax_build_train_loss(args),
                         num_classes=NC, token_label=True, has_token_label_data=True,
                         donate=False)
    rs = np.random.default_rng(0)
    scores = rs.random((B, 5, 14, 14)).astype(np.float32)
    scores /= scores.sum(1, keepdims=True) * 1.25
    batch = {"image": rs.normal(size=(B, IMG, IMG, 3)).astype(np.float32),
             "label": rs.integers(0, NC, B).astype(np.int32), "label_scores": scores,
             "label_inds": rs.integers(0, NC, (B, 5, 14, 14)).astype(np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(7)
    # the step folds its step count (0) into rng: this forward draws its box
    out, _ = jax.jit(lambda p: jsb._apply_train(p, jstats, jbatch["image"],
                                                jax.random.fold_in(rng, 0), None))(jparams)
    jstate = JaxTrainState.create(params=jparams, batch_stats=jstats, tx=tx)
    _, jm = jsb.train_step(r=IMG)(jstate, jbatch, LR, rng)

    tmodel = create_model("volo_h4_l4").make(num_classes=NC, img_size=IMG,
                                             dtype=torch.float32)
    small, tmpl = flax_to_torch(sp), flax_to_torch(bp)
    grown = growth.grow_params(small, tmpl, src_layers=sl, dst_layers=bl, mode="clone")
    stats = growth.grow_batch_stats(flax_to_torch({}, ss), flax_to_torch({}, bs),
                                    src_layers=sl, dst_layers=bl)
    tmodel.load_state_dict({**grown, **stats})
    tsb = StepBuilder(train_loss=build_train_loss(args), num_classes=NC, token_label=True,
                      has_token_label_data=True)
    tstate = TrainState.create(model=tmodel,
                               optimizer=toptim.create_optimizer(args, tmodel))
    tm = tsb.train_step(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, LR,
                        r=IMG, bbox=torch.tensor(np.asarray(out[2])))
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    new = flax_to_torch(jsb.train_step(r=IMG)(jstate, jbatch, LR, rng)[0].params)
    for name, p in tstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), new[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
