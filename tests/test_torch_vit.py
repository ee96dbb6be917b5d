"""Port parity: DeiT in autoprog_tpu_torch against the Flax model.

Small DeiTs (32 px, patch 8, 2-3 layers, width 32, 2 heads, f32), plain and
distilled, with the Flax init converted by `autoprog_tpu_torch.convert`. Both
packages see the same numpy inputs. The CPU takes the unfused attention path
in both packages.

Tolerances:
  * outputs: rtol 1e-4 / atol 1e-4 on logits of magnitude ~1: the same f32
    formulas, summed in another order (see test_torch_model.py);
  * loss and grads of the train step: rtol 1e-4 / atol 1e-5; params and EMA
    trees after it: atol 1e-6 with Adam's eps at 1e-3 (the reason is in
    test_torch_train_step.py);
  * growth: atol 1e-6 (one rounding of the 1/scale division).
"""

import argparse
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoprog_tpu.losses import build_train_loss as jax_build_train_loss
from autoprog_tpu.models.factory import DeitArch as JaxDeitArch
from autoprog_tpu.models.factory import ModelDef as JaxModelDef
from autoprog_tpu.models.factory import _deit_cfg as jax_deit_cfg
from autoprog_tpu.prog import growth as jgrowth
from autoprog_tpu.registry import create_model as jax_create_model
from autoprog_tpu.registry import list_models as jax_list_models
from autoprog_tpu.train import optim as joptim
from autoprog_tpu.train.state import TrainState as JaxTrainState
from autoprog_tpu.train.steps import StepBuilder as JaxStepBuilder
from autoprog_tpu_torch import create_model
from autoprog_tpu_torch.convert import flax_to_torch
from autoprog_tpu_torch.losses import build_train_loss
from autoprog_tpu_torch.models.factory import DeitArch, ModelDef, _deit_cfg
from autoprog_tpu_torch.prog import growth as tgrowth
from autoprog_tpu_torch.registry import list_models
from autoprog_tpu_torch.train import optim as toptim
from autoprog_tpu_torch.train.state import TrainState
from autoprog_tpu_torch.train.steps import StepBuilder

RTOL = ATOL = 1e-4
IMG, PATCH, NC = 32, 8, 10
DECAYS, LR = (0.99, 0.999), 1e-3


def mdefs(dim=32, depth=2, heads=2, distilled=False):
    """The same small DeiT in both packages (patch 8, which no registered
    name has)."""
    kw = dict(embed_dim=dim, depth=depth, num_heads=heads, patch_size=PATCH,
              distilled=distilled)
    return (JaxModelDef("deit_test", JaxDeitArch(**kw), jax_deit_cfg()),
            ModelDef("deit_test", DeitArch(**kw), _deit_cfg()))


def jax_init(jdef, seed=0, img=IMG):
    model = jdef.make(num_classes=NC, img_size=img, dtype=jnp.float32)
    variables = jax.jit(lambda: model.init({"params": jax.random.PRNGKey(seed)},
                                           jnp.zeros((1, img, img, 3)), train=False))()
    return model, variables


def japply(model, variables, x, **kw):
    return jax.jit(functools.partial(model.apply, **kw))(variables, x)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "distilled"])
def pair(request):
    jdef, tdef = mdefs(depth=3, distilled=request.param)
    model, variables = jax_init(jdef)
    tmodel = tdef.make(num_classes=NC, img_size=IMG, dtype=torch.float32)
    tmodel.load_state_dict(flax_to_torch(variables["params"]), strict=True)
    images = np.random.default_rng(0).normal(size=(4, IMG, IMG, 3)).astype(np.float32)
    return model, variables, tmodel, images, request.param


def test_state_dict_covers_every_flax_leaf(pair):
    _, variables, tmodel, _, distilled = pair
    sd = tmodel.state_dict()
    assert len(jax.tree.leaves(variables["params"])) == len(sd)
    k = np.asarray(variables["params"]["patch_embed"]["kernel"])        # HWIO
    np.testing.assert_array_equal(sd["patch_embed.weight"].numpy(), k.transpose(3, 2, 0, 1))
    assert sd["pos_embed"].shape == (1, (IMG // PATCH) ** 2 + (2 if distilled else 1), 32)
    assert ("dist_token" in sd) == ("head_dist.weight" in sd) == distilled


def test_eval_forward_matches_flax(pair):
    model, variables, tmodel, images, _ = pair
    ref = japply(model, variables, jnp.asarray(images), train=False)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images), train=False)
    assert got.shape == (4, NC)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_train_forward_matches_flax(pair):
    """Train mode (no dropout): the distilled model returns the two heads."""
    model, variables, tmodel, images, distilled = pair
    ref = japply(model, variables, jnp.asarray(images), train=True)
    got = tmodel(torch.from_numpy(images), train=True)
    if not distilled:
        ref, got = (ref,), (got,)
    assert isinstance(got, tuple) and len(got) == len(ref) == (2 if distilled else 1)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


def test_eval_forward_with_keep_mask_matches_flax(pair):
    model, variables, tmodel, images, _ = pair
    keep = ((True, False, True),)
    ref = japply(model, variables, jnp.asarray(images), train=False, keep=keep)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images), train=False, keep=keep)
        full = tmodel(torch.from_numpy(images), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    assert not np.allclose(got.numpy(), full.numpy(), atol=1e-3)
    with pytest.raises(ValueError, match="keep mask length"):
        tmodel(torch.from_numpy(images), keep=((True, True),))


@pytest.mark.parametrize("r", [16, 48])
def test_resized_pos_embed_forward_matches_flax(pair, r):
    """Another resolution than the init one: the grid part of the pos-embed
    is resized bicubically, the prefix tokens' part is kept."""
    model, variables, tmodel, _, _ = pair
    images = np.random.default_rng(r).normal(size=(2, r, r, 3)).astype(np.float32)
    ref = japply(model, variables, jnp.asarray(images), train=False)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------- one step

def make_args(**kw):
    d = dict(opt="adamw", opt_eps=1e-3, opt_betas=None, momentum=0.9, weight_decay=0.05,
             clip_grad=None, clip_mode="norm", token_label=False, token_label_data="",
             token_label_size=1, dense_weight=0.5, cls_weight=1.0, ground_truth=False,
             smoothing=0.1)
    d.update(kw)
    return argparse.Namespace(**d)


def step_setup(distilled):
    args = make_args()
    jdef, tdef = mdefs(distilled=distilled)
    jmodel, variables = jax_init(jdef)
    params = variables["params"]
    tx = joptim.create_optimizer(args, params)
    jsb = JaxStepBuilder(model=jmodel, tx=tx, train_loss=jax_build_train_loss(args),
                         ema_decays=DECAYS, num_classes=NC, donate=False)
    rs = np.random.default_rng(1)
    batch = {"image": rs.normal(size=(4, IMG, IMG, 3)).astype(np.float32),
             "label": rs.integers(0, NC, 4).astype(np.int32)}
    tmodel = tdef.make(num_classes=NC, img_size=IMG, dtype=torch.float32)
    tmodel.load_state_dict(flax_to_torch(params))
    tsb = StepBuilder(train_loss=build_train_loss(args), ema_decays=DECAYS, num_classes=NC)
    tstate = TrainState.create(model=tmodel, optimizer=toptim.create_optimizer(args, tmodel),
                               ema_decays=DECAYS)
    return (jmodel, params, tx, jsb, {k: jnp.asarray(v) for k, v in batch.items()},
            tsb, tstate, {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("distilled", [False, True], ids=["plain", "distilled"])
def test_train_loss_and_grads_match_jax(distilled):
    """The training loss on the model's train-mode output (for the distilled
    model: on the cls head of the tuple) and its gradients."""
    jmodel, params, _, jsb, jbatch, tsb, tstate, tbatch = step_setup(distilled)
    target = jsb._build_target(jbatch, IMG)

    def loss_fn(p):
        return jsb.train_loss(jmodel.apply({"params": p}, jbatch["image"], train=True),
                              target)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    out = tstate.model(tbatch["image"], train=True)
    assert isinstance(out, tuple) == distilled
    tloss = tsb.train_loss(out, tsb.build_target(tbatch, IMG))
    tloss.backward()
    assert float(tloss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    want = flax_to_torch(jgrads)
    got = {n: p.grad if p.grad is not None else torch.zeros_like(p)
           for n, p in tstate.model.named_parameters()}
    assert set(got) == set(want)
    for name, v in want.items():
        np.testing.assert_allclose(got[name].numpy(), v.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    if distilled:                      # the loss does not see the dist head
        assert float(got["head_dist.weight"].abs().max()) == 0.0


def test_train_step_matches_jax():
    """One AdamW step with 2 EMA decays from the same parameters and batch.
    (Plain DeiT only: the JAX step hands the loss a nested tuple for the
    distilled model and raises, so that step has no reference; its loss and
    gradients are held above.)"""
    _, params, tx, jsb, jbatch, tsb, tstate, tbatch = step_setup(False)
    jstate = JaxTrainState.create(params=params, batch_stats={}, tx=tx, ema_decays=DECAYS)
    jnew, jm = jsb.train_step(r=IMG)(jstate, jbatch, LR, jax.random.PRNGKey(7))
    tm = tsb.train_step(tstate, tbatch, LR, r=IMG)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    want = flax_to_torch(jnew.params)
    assert set(want) == set(tstate.params)
    for name, v in want.items():
        np.testing.assert_allclose(tstate.params[name].detach().numpy(), v.numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
    for i in range(len(DECAYS)):
        for name, v in flax_to_torch(jnew.ema_params[i]).items():
            np.testing.assert_allclose(tstate.ema_params[i][name].numpy(), v.numpy(),
                                       rtol=0, atol=1e-6, err_msg=name)


def test_distilled_train_and_eval_steps_run():
    """The port's step takes the distilled model's tuple: a finite loss, moved
    parameters, and eval metrics on the mean of the two heads."""
    *_, tsb, tstate, tbatch = step_setup(True)
    before = {n: p.detach().clone() for n, p in tstate.params.items()}
    tm = tsb.train_step(tstate, tbatch, LR, r=IMG)
    assert np.isfinite(float(tm["loss"])) and tstate.step == 1
    assert any(not torch.equal(before[n], p) for n, p in tstate.params.items())
    ev = tsb.eval_step(tstate, tbatch)
    assert float(ev["count"]) == 4 and np.isfinite(float(ev["loss_sum"]))
    probe = tsb.loss_probe_step(tstate, tbatch, r=IMG)
    assert np.isfinite(float(probe))


# ----------------------------------------------------------------- growth

@pytest.mark.parametrize("mode", ["slice", "clone_rand", "zero", "clone", "clone_ema"])
@pytest.mark.parametrize("distilled", [False, True], ids=["plain", "distilled"])
def test_grow_params_matches_jax(mode, distilled):
    """deit 32 x 2 layers -> 64 x 3 layers (width and depth): every rule a
    DeiT tree meets (patch_embed conv and its bias, pos_embed, cls_token,
    dist_token, qkv with bias, head, head_dist)."""
    jsmall, _ = mdefs(dim=32, depth=2, heads=2, distilled=distilled)
    jbig, _ = mdefs(dim=64, depth=3, heads=4, distilled=distilled)
    _, vs = jax_init(jsmall, 0)
    _, vb = jax_init(jbig, 1)
    sp, bp = vs["params"], vb["params"]

    def perturbed(tree, seed):
        leaves, treedef = jax.tree.flatten(tree)
        rs = np.random.RandomState(seed)
        return jax.tree.unflatten(treedef, [x + 0.01 * jnp.asarray(rs.randn(*x.shape), x.dtype)
                                            for x in leaves])

    jkw, tkw, src = {}, {}, sp
    if mode == "clone_ema":
        emas = [perturbed(sp, s) for s in (1, 2, 3)]
        src = perturbed(sp, 4)
        jkw, tkw = dict(ema_trees=emas), dict(ema_trees=[flax_to_torch(e) for e in emas])
    layers = dict(src_layers=(2,), dst_layers=(3,))
    ref = flax_to_torch(jgrowth.grow_params(src, bp, mode=mode, **layers, **jkw))
    got = tgrowth.grow_params(flax_to_torch(src), flax_to_torch(bp), mode=mode, **layers,
                              **tkw)
    assert set(got) == set(ref)
    for name in ref:
        assert got[name].shape == ref[name].shape, name
        np.testing.assert_allclose(got[name].numpy(), ref[name].numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
    if distilled:
        assert {"dist_token", "head_dist.weight", "head_dist.bias"} <= set(got)


def test_grown_deit_runs_and_matches_flax():
    """The grown tree loads into the big model of both packages and gives the
    same logits."""
    jsmall, _ = mdefs(dim=32, depth=2, heads=2, distilled=True)
    jbig, tbig = mdefs(dim=64, depth=3, heads=4, distilled=True)
    _, vs = jax_init(jsmall, 0)
    jmodel, vb = jax_init(jbig, 1)
    layers = dict(src_layers=(2,), dst_layers=(3,))
    jgrown = jgrowth.grow_params(vs["params"], vb["params"], mode="clone", **layers)
    tgrown = tgrowth.grow_params(flax_to_torch(vs["params"]), flax_to_torch(vb["params"]),
                                 mode="clone", **layers)
    tmodel = tbig.make(num_classes=NC, img_size=IMG, dtype=torch.float32)
    tmodel.load_state_dict(tgrown, strict=True)
    images = np.random.default_rng(2).normal(size=(2, IMG, IMG, 3)).astype(np.float32)
    ref = japply(jmodel, {"params": jgrown}, jnp.asarray(images), train=False)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------- registry

def test_registered_deit_names_and_archs_are_the_jax_ones():
    names = [n for n in jax_list_models() if n.startswith("deit")]
    assert len(names) == 8 and set(names) <= set(list_models())
    for name in names + ["deit_h3_l12", "deit_h6_l4"]:
        j, t = jax_create_model(name), create_model(name)
        assert t.default_cfg == j.default_cfg, name
        for f in ("embed_dim", "depth", "num_heads", "patch_size", "mlp_ratio", "distilled",
                  "family", "layers", "embed_dims", "total_layers"):
            assert getattr(t.arch, f) == getattr(j.arch, f), (name, f)
    assert create_model("deit_base_patch16_384").default_cfg["input_size"] == (3, 384, 384)
