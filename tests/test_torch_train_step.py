"""Port parity: one full train step of autoprog_tpu_torch against the JAX
package's `StepBuilder.train_step`, plus the optimizer pieces and the LR
schedules value for value.

The step runs volo_h2_l4 at 64 px, f32, dense token labels, MixToken with
the box JAX drew, DropPath and dropout off, AdamW (wd 0.05) and 4 EMA
decays, from the same converted parameters and the same numpy batch.
Tolerances:
  * loss, grads, BatchNorm stats: rtol 1e-4 / atol 1e-5 -- the same f32
    formulas summed in another order (see test_torch_model.py);
  * params and EMA trees after the step: atol 1e-6. Adam's first step
    moves a parameter by lr * g / (|g| + eps); with the default eps 1e-8
    that is ~lr * sign(g), so a near-zero gradient component whose last
    bits differ between the packages could move by a fraction of lr. The
    step test therefore runs Adam with eps 1e-3, where a parameter moves by
    at most lr / eps = 1x its gradient difference (AdamW at eps 1e-6 is
    checked on controlled inputs below);
  * AdamW and clipping on controlled inputs: rtol 1e-6 (one rounding).
"""

import argparse
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autoprog_tpu.losses import build_train_loss as jax_build_train_loss
from autoprog_tpu.registry import create_model as jax_create_model
from autoprog_tpu.train import optim as joptim
from autoprog_tpu.train.state import TrainState as JaxTrainState
from autoprog_tpu.train.steps import StepBuilder as JaxStepBuilder
from autoprog_tpu_torch import create_model
from autoprog_tpu_torch.convert import flax_to_torch
from autoprog_tpu_torch.losses import build_train_loss
from autoprog_tpu_torch.train import optim as toptim
from autoprog_tpu_torch.train.state import TrainState
from autoprog_tpu_torch.train.steps import StepBuilder

DECAYS = (0.998, 0.9986, 0.999, 0.9996)
IMG, NC, B, LR = 64, 10, 4, 1e-3


def make_args(**kw):
    d = dict(opt="adamw", opt_eps=None, opt_betas=None, momentum=0.9,
             weight_decay=0.05, clip_grad=None, clip_mode="norm", sched="cosine",
             lr=1e-3, min_lr=1e-5, warmup_lr=1e-6, epochs=10, warmup_epochs=2,
             cooldown_epochs=3, decay_epochs=3, decay_rate=0.1, token_label=True,
             token_label_data="synthetic", token_label_size=IMG // 16,
             dense_weight=0.5, cls_weight=1.0, ground_truth=False, smoothing=0.1,
             patience_epochs=2, eval_metric="top1", seed=42)
    d.update(kw)
    return argparse.Namespace(**d)


def make_batch(seed=0):
    rs = np.random.default_rng(seed)
    scores = rs.random((B, 5, 14, 14)).astype(np.float32)
    scores /= scores.sum(1, keepdims=True) * 1.25
    return {"image": rs.normal(size=(B, IMG, IMG, 3)).astype(np.float32),
            "label": rs.integers(0, NC, B).astype(np.int32),
            "label_scores": scores,
            "label_inds": rs.integers(0, NC, (B, 5, 14, 14)).astype(np.int32)}


@pytest.fixture(scope="module")
def stepped():
    """Both packages take one step from the same state and batch."""
    args = make_args(opt_eps=1e-3)
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
    # the step folds its step count (0) into rng; the same key gives the
    # same MixToken box here
    step_rng = jax.random.fold_in(rng, 0)
    target = jsb._build_target(jbatch, IMG)

    def loss_fn(p):
        out, _ = jsb._apply_train(p, bs, jbatch["image"], step_rng, None)
        return jsb.train_loss(out, target), out[2]

    (jloss, bbox), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    jstate = JaxTrainState.create(params=params, batch_stats=bs, tx=tx, ema_decays=DECAYS)
    jnew, jm = jsb.train_step(r=IMG)(jstate, jbatch, LR, rng)

    tmodel = create_model("volo_h2_l4").make(num_classes=NC, img_size=IMG,
                                             dtype=torch.float32)
    tmodel.load_state_dict(flax_to_torch(params, bs))
    tsb = StepBuilder(train_loss=build_train_loss(args), ema_decays=DECAYS,
                      num_classes=NC, token_label=True, has_token_label_data=True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbbox = torch.tensor(np.asarray(bbox))

    gmodel = copy.deepcopy(tmodel)
    out = gmodel(tbatch["image"], train=True, bbox=tbbox)
    tloss = tsb.train_loss(out, tsb.build_target(tbatch, IMG))
    tloss.backward()
    tgrads = {n: p.grad for n, p in gmodel.named_parameters()}

    tstate = TrainState.create(model=tmodel, optimizer=toptim.create_optimizer(args, tmodel),
                               ema_decays=DECAYS)
    tm = tsb.train_step(tstate, tbatch, LR, r=IMG, bbox=tbbox)
    return dict(jloss=float(jloss), jm=jm, jgrads=jgrads, jnew=jnew,
                tloss=float(tloss.detach()), tm=tm, tgrads=tgrads, tstate=tstate)


def assert_trees_close(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].detach().numpy(), want[name].numpy(),
                                   err_msg=name, **tol)


def test_loss_matches(stepped):
    assert stepped["tloss"] == pytest.approx(stepped["jloss"], rel=1e-5)
    assert float(stepped["tm"]["loss"]) == pytest.approx(float(stepped["jm"]["loss"]),
                                                         rel=1e-5)


def test_grads_match(stepped):
    assert_trees_close(stepped["tgrads"], flax_to_torch(stepped["jgrads"]),
                       rtol=1e-4, atol=1e-5)


def test_params_and_batch_stats_after_step_match(stepped):
    st, jn = stepped["tstate"], stepped["jnew"]
    assert st.step == int(jn.step) == 1
    assert_trees_close(st.params, flax_to_torch(jn.params), rtol=0, atol=1e-6)
    assert_trees_close(st.batch_stats, flax_to_torch({}, jn.batch_stats),
                       rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("i", range(len(DECAYS)))
def test_ema_trees_after_step_match(stepped, i):
    assert_trees_close(stepped["tstate"].ema_params[i],
                       flax_to_torch(stepped["jnew"].ema_params[i]), rtol=0, atol=1e-6)


def test_adamw_two_groups_match_optax_chain():
    """torch.optim.AdamW with the decay / no-decay groups against optax
    scale_by_adam -> add_decayed_weights(wd_mask) -> x(-lr), 5 steps."""
    rs = np.random.default_rng(0)
    shapes = {"pos_embed": (1, 2, 2, 4), "cls_token": (1, 1, 4),
              "fc": {"weight": (3, 4), "bias": (3,)}, "norm": {"weight": (4,)}}
    tree = jax.tree.map(lambda s: rs.normal(size=s).astype(np.float32), shapes,
                        is_leaf=lambda x: isinstance(x, tuple))
    args = make_args(opt_betas=[0.9, 0.95], opt_eps=1e-6)
    jparams = jax.tree.map(jnp.asarray, tree)
    tx = joptim.create_optimizer(args, jparams)
    opt_state = tx.init(jparams)

    module = torch.nn.Module()
    flat = flax_to_torch(tree)               # no "kernel" leaves: names as-is
    for name, v in flat.items():
        parent = module
        *path, leaf = name.split(".")
        for p in path:
            if not hasattr(parent, p):
                parent.add_module(p, torch.nn.Module())
            parent = getattr(parent, p)
        parent.register_parameter(leaf, torch.nn.Parameter(v.clone()))
    opt = toptim.create_optimizer(args, module)
    assert [len(g["params"]) for g in opt.param_groups] == [1, 4]
    for step in range(5):
        grads = jax.tree.map(lambda x: rs.normal(size=x.shape).astype(np.float32), tree)
        lr = 1e-2 * (step + 1)
        upd, opt_state = tx.update(jax.tree.map(jnp.asarray, grads), opt_state, jparams)
        jparams = optax.apply_updates(jparams, joptim.apply_lr(upd, lr))
        tgrads = flax_to_torch(grads)
        for name, p in module.named_parameters():
            p.grad = tgrads[name].clone()
        for g in opt.param_groups:
            g["lr"] = lr
        opt.step()
        assert_trees_close(dict(module.named_parameters()), flax_to_torch(jparams),
                           rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode,c", [("norm", 0.5), ("value", 0.1), ("agc", 0.01)])
def test_grad_clip_matches_optax(mode, c):
    rs = np.random.default_rng(1)
    shapes = {"fc": {"kernel": (5, 3), "bias": (3,)}, "conv": {"kernel": (3, 3, 2, 4)},
              "pos_embed": (1, 2, 2, 3), "cls_token": (1, 1, 3), "norm": {"scale": (3,)}}
    rnd = lambda s: rs.normal(size=s).astype(np.float32)
    params = jax.tree.map(rnd, shapes, is_leaf=lambda x: isinstance(x, tuple))
    grads = jax.tree.map(rnd, shapes, is_leaf=lambda x: isinstance(x, tuple))
    args = make_args(clip_grad=c, clip_mode=mode)
    clip = {"norm": optax.clip_by_global_norm(c), "value": optax.clip(c),
            "agc": optax.adaptive_grad_clip(c)}[mode]
    jg, _ = clip.update(jax.tree.map(jnp.asarray, grads), clip.init(params),
                        jax.tree.map(jnp.asarray, params))
    tparams = {n: torch.nn.Parameter(v) for n, v in flax_to_torch(params).items()}
    for n, g in flax_to_torch(grads).items():
        tparams[n].grad = g
    toptim.create_grad_clip(args)(list(tparams.items()))
    assert_trees_close({n: p.grad for n, p in tparams.items()}, flax_to_torch(jg),
                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kw", [
    dict(sched="cosine"),
    dict(sched="cosine", lr_cycle_mul=0.5, lr_cycle_limit=3),
    dict(sched="step", decay_epochs=3),
    dict(sched="tanh"),
    dict(sched="constant"),
    dict(sched="cosine", lr_noise=[0.3, 0.8], lr_noise_pct=0.67),
])
def test_lr_schedule_values_match_jax(kw):
    args = make_args(**kw)
    js, ts = joptim.create_scheduler(args), toptim.create_scheduler(args)
    assert ts.num_epochs == js.num_epochs
    for e in (0, 0.5, 1, 2, 3.5, 5, 7, 9, 10, 12):
        assert ts.fn(e) == pytest.approx(js.fn(e), rel=1e-12, abs=0)


def test_plateau_schedule_matches_jax():
    args = make_args(sched="plateau")
    js, ts = joptim.create_scheduler(args), toptim.create_scheduler(args)
    for epoch, metric in enumerate([1.0, 2.0, 1.5, 1.5, 1.5, 3.0, 2.0, 2.0, 2.0, 2.0]):
        assert ts.fn(epoch) == pytest.approx(js.fn(epoch), rel=1e-12)
        js.observe(metric)
        ts.observe(metric)
    assert ts.state_dict() == js.state_dict()
