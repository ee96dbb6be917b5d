"""Port parity: a train step with a keep mask (the supernet epoch's step)
moves the skipped layers as the JAX package's does.

`jax.grad` gives zeros for the parameters the forward did not reach, and
optax steps them: their moments decay, the decoupled weight decay applies
and the global count goes on. The port fills those gradients with zeros
(`train/steps.py`), so its optimizers do the same. Both packages take two
steps from the same converted state: a full one, then one with
`elastic_keep_masks(2, 2, 4, "volo")` = ((True, False), (True, False)),
which skips `s0b1` and `s1b1`. Then every parameter, the skipped layers'
included, and the optimizer state are held against JAX.

volo_h2_l4 at 64 px, f32, token labels, MixToken with the boxes JAX drew,
DropPath off; AdamW at eps 1e-3 and wd 0.05 (f32 moments, and the bf16 first
moment of --adam-mu-bf16) and Nesterov SGD. Tolerances, as in
test_torch_train_step.py: parameters atol 1e-6; moments as the gradients
they are made of, rtol 1e-4 / atol 1e-5 scaled by the moment's factor of
the gradient (mu: 1e-6; nu, a square: rtol 2e-4 and atol 1e-10). The bf16
first moment is stored rounded to nearest after each step, and gradients
that agree to 1e-4 can round it to either neighbour: after two steps it
agrees within one bf16 ulp of the largest value of its tensor (atol
2^-7 * max |mu|), and the second step's parameters within the update that
one ulp of the first moment makes, lr * b1 * 2^-7 |m1| / bc1 / sqrt(v2_hat)
< lr * 2^-7 (atol 7.8e-6). The layers the keep step skipped move by more
than the tolerance, so the parent's fault (no move at all) shows.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoprog_tpu.losses import build_train_loss as jax_build_train_loss
from autoprog_tpu.prog.depth import elastic_keep_masks
from autoprog_tpu.registry import create_model as jax_create_model
from autoprog_tpu.train import optim as joptim
from autoprog_tpu.train.state import TrainState as JaxTrainState
from autoprog_tpu.train.steps import StepBuilder as JaxStepBuilder
from autoprog_tpu_torch import create_model
from autoprog_tpu_torch.convert import flax_to_torch, optax_to_torch_state
from autoprog_tpu_torch.losses import build_train_loss
from autoprog_tpu_torch.train import optim as toptim
from autoprog_tpu_torch.train import steps as tsteps
from autoprog_tpu_torch.train.state import TrainState
from autoprog_tpu_torch.train.steps import StepBuilder
from test_torch_train_step import IMG, LR, NC, assert_trees_close, make_args, make_batch

KEEP = elastic_keep_masks(2, 2, 4, "volo")
SKIPPED = ("s0b1.", "s1b1.")
OPTS = {"adamw": dict(opt="adamw", opt_eps=1e-3),
        "adam_mu_bf16": dict(opt="adamw", opt_eps=1e-3, adam_mu_bf16=True),
        "sgd": dict(opt="sgd")}


@pytest.fixture(scope="module")
def jax_init():
    """The JAX model, its initial variables, the two batches and the
    MixToken boxes JAX's steps 0 and 1 draw (the step folds its count into
    the key; the box depends on the key and the shape only)."""
    jmodel = jax_create_model("volo_h2_l4").make(num_classes=NC, img_size=IMG,
                                                 dtype=jnp.float32)
    variables = jax.jit(lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                                            jnp.zeros((1, IMG, IMG, 3)), train=False))()
    batches = [make_batch(0), make_batch(1)]
    rng = jax.random.PRNGKey(7)

    @jax.jit
    def boxes(params, bs, image):
        apply = lambda step, keep: jmodel.apply(
            {"params": params, "batch_stats": bs}, image, train=True, keep=keep,
            rngs={"dropout": jax.random.fold_in(jax.random.fold_in(rng, step), 1),
                  "mixtoken": jax.random.fold_in(jax.random.fold_in(rng, step), 2)},
            mutable=["batch_stats"])[0][2]
        return apply(0, None), apply(1, KEEP)
    bboxes = boxes(variables["params"], variables["batch_stats"],
                   jnp.asarray(batches[0]["image"]))
    return dict(jmodel=jmodel, params=variables["params"], bs=variables["batch_stats"],
                batches=batches, rng=rng,
                bboxes=[torch.tensor(np.asarray(b)) for b in bboxes])


@pytest.fixture(scope="module", params=list(OPTS))
def two_steps(request, jax_init):
    assert KEEP == ((True, False), (True, False))
    args = make_args(**OPTS[request.param])
    params, bs, batches = jax_init["params"], jax_init["bs"], jax_init["batches"]
    tx = joptim.create_optimizer(args, params)
    jsb = JaxStepBuilder(model=jax_init["jmodel"], tx=tx,
                         train_loss=jax_build_train_loss(args), num_classes=NC,
                         token_label=True, has_token_label_data=True, donate=False)
    jbatches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    rng, bboxes = jax_init["rng"], jax_init["bboxes"]
    jstate = JaxTrainState.create(params=params, batch_stats=bs, tx=tx, ema_decays=())
    jstate, _ = jsb.train_step(r=IMG)(jstate, jbatches[0], LR, rng)
    jstate, _ = jsb.train_step(r=IMG, keep=KEEP)(jstate, jbatches[1], LR, rng)

    tmodel = create_model("volo_h2_l4").make(num_classes=NC, img_size=IMG,
                                             dtype=torch.float32)
    tmodel.load_state_dict(flax_to_torch(params, bs))
    tsb = StepBuilder(train_loss=build_train_loss(args), num_classes=NC, token_label=True,
                      has_token_label_data=True)
    tstate = TrainState.create(model=tmodel, optimizer=toptim.create_optimizer(args, tmodel))
    fills, after_full = [], {}
    for batch, bbox, keep in zip(batches, bboxes, (None, KEEP)):
        before = tsteps.GRAD_FILLS["params"]
        tsb.train_step(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, LR,
                       r=IMG, keep=keep, bbox=bbox)
        fills.append(tsteps.GRAD_FILLS["params"] - before)
        after_full = after_full or {n: p.detach().clone() for n, p in tstate.params.items()
                                    if n.startswith(SKIPPED)}
    names = {id(p): n for n, p in tmodel.named_parameters()}
    tstate_by_name = {names[id(p)]: st for p, st in tstate.optimizer.state.items()}
    jopt = optax_to_torch_state(flax.serialization.to_state_dict(jstate.opt_state))
    return dict(opt=request.param, jstate=jstate, jopt=jopt, tstate=tstate,
                topt=tstate_by_name, fills=fills, after_full=after_full)


def test_every_parameter_matches_jax_after_a_keep_step(two_steps):
    st, jn = two_steps["tstate"], two_steps["jstate"]
    want = flax_to_torch(jn.params)
    skipped = [n for n in want if n.startswith(SKIPPED)]
    assert skipped and all(n in st.params for n in skipped)
    atol = LR * 2.0 ** -7 if two_steps["opt"] == "adam_mu_bf16" else 1e-6
    assert_trees_close(st.params, want, rtol=0, atol=atol)
    # the keep step moved the layers it skipped (the first step's moments)
    moved = max(float((want[n] - two_steps["after_full"][n]).abs().max()) for n in skipped)
    assert moved > 2 * atol


def test_optimizer_state_matches_jax_after_a_keep_step(two_steps):
    jopt, topt = two_steps["jopt"], two_steps["topt"]
    assert set(topt) == set(flax_to_torch(two_steps["jstate"].params))
    if two_steps["opt"] == "sgd":
        got = {n: st["momentum_buffer"] for n, st in topt.items()}
        assert_trees_close(got, jopt["momentum_buffer"], rtol=1e-4, atol=1e-5)
        return
    # one count for every parameter, the skipped ones' too
    assert jopt["count"] == 2
    assert {float(st["step"]) for st in topt.values()} == {2.0}
    mu = {n: st["exp_avg"].float() for n, st in topt.items()}
    if two_steps["opt"] == "adam_mu_bf16":
        assert all(st["exp_avg"].dtype == torch.bfloat16 for st in topt.values())
        for n, want in jopt["exp_avg"].items():
            np.testing.assert_allclose(mu[n].numpy(), want.numpy(), rtol=0, err_msg=n,
                                       atol=2.0 ** -7 * float(want.abs().max()) + 1e-12)
    else:
        assert_trees_close(mu, jopt["exp_avg"], rtol=1e-4, atol=1e-6)
    assert_trees_close({n: st["exp_avg_sq"] for n, st in topt.items()}, jopt["exp_avg_sq"],
                       rtol=2e-4, atol=1e-10)


def test_only_the_keep_step_fills_gradients(two_steps):
    """The full step reaches every parameter: the fill touches nothing.
    The keep step fills exactly the skipped layers' parameters."""
    n_skipped = sum(1 for n in two_steps["tstate"].params if n.startswith(SKIPPED))
    assert two_steps["fills"] == [0, n_skipped]
