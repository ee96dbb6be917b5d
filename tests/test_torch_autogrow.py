"""Port parity: `autoprog_tpu_torch/prog/autogrow.py` and the search probes
of `train/steps.py` against the JAX package.

  * the copied host functions (`candidate_window`, `fit_time_exponent`,
    `score_candidates`, `parse_cfg`) give the originals' values on the
    inputs of `tests/test_autogrow.py`, exactly;
  * `loss_probe_step` (train-mode forward, hard-label CE on the cls logits)
    equals the JAX probe on converted parameters, the same batch, the same
    keep mask and the MixToken box JAX drew: atol 1e-4 on a loss of ~2.3
    (the same f32 formulas summed in another order);
  * `probe_candidate`, `take_probe_batches` and the BatchNorm utilities
    behave as the search loop needs.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoprog_tpu.losses import build_train_loss as jax_build_train_loss
from autoprog_tpu.ops.interpolate import resize_bilinear as jax_resize_bilinear
from autoprog_tpu.prog import autogrow as jauto
from autoprog_tpu.prog.depth import elastic_keep_masks
from autoprog_tpu.registry import create_model as jax_create_model
from autoprog_tpu.train import optim as joptim
from autoprog_tpu.train.steps import StepBuilder as JaxStepBuilder
from autoprog_tpu_torch import create_model
from autoprog_tpu_torch.convert import flax_to_torch
from autoprog_tpu_torch.losses import build_train_loss
from autoprog_tpu_torch.models import volo as tvolo
from autoprog_tpu_torch.prog import autogrow as tauto
from autoprog_tpu_torch.train import bn as tbn
from autoprog_tpu_torch.train import optim as toptim
from autoprog_tpu_torch.train.state import TrainState
from autoprog_tpu_torch.train.steps import StepBuilder

IMG, NC, B = 64, 10, 4
SCHED = ((128, 160, 192, 224), (12, 12, 12, 12), (9, 12, 15, 18))


@pytest.mark.parametrize("current,stage", [((128, 12, 9), 0), ((160, 12, 12), 1),
                                           ((192, 12, 15), 2), ((224, 12, 18), 3)])
def test_candidate_window_matches(current, stage):
    assert tauto.candidate_window(*SCHED, *current, stage) == \
        jauto.candidate_window(*SCHED, *current, stage)


def test_parse_cfg_and_fit_time_exponent_match():
    assert tauto.parse_cfg("r128_l9") == jauto.parse_cfg("r128_l9") == (128, 9)
    times = np.array([1.0, 2.0, 4.0, 8.0])
    for losses in (3.0 * times ** -0.7, 3.0 * times ** 0.5):
        assert tauto.fit_time_exponent(times, losses) == \
            jauto.fit_time_exponent(times, losses)


def _rounds(kind):
    if kind == "fast_learner":
        return ["r128_l9", "r224_l18"], [
            {"r128_l9": {"loss": 5.0, "time": 1.0}, "r224_l18": {"loss": 6.0, "time": 3.0}},
            {"r128_l9": {"loss": 4.0}, "r224_l18": {"loss": 5.5}}], 0
    if kind == "time_tradeoff":
        return ["a_l1", "b_l2", "c_l3"], [
            {"a_l1": {"loss": 4.00, "time": 1.0}, "b_l2": {"loss": 3.80, "time": 2.0},
             "c_l3": {"loss": 3.75, "time": 8.0}}], 0
    rounds = []
    for i in range(5):
        r = {"r1_l1": {"loss": 5.0 - 0.5 * i}, "r2_l2": {"loss": 5.5 - 0.3 * i}}
        if i == 0:
            r["r1_l1"]["time"], r["r2_l2"]["time"] = 1.0, 2.0
        rounds.append(r)
    return ["r1_l1", "r2_l2"], rounds, 1


@pytest.mark.parametrize("kind", ["fast_learner", "time_tradeoff", "taylor"])
def test_score_candidates_matches(kind):
    cfgs, rounds, stage = _rounds(kind)
    assert tauto.score_candidates(rounds, cfgs, stage) == \
        jauto.score_candidates(rounds, cfgs, stage)


def make_args(**kw):
    d = dict(opt="adamw", opt_eps=None, opt_betas=None, momentum=0.9, weight_decay=0.05,
             clip_grad=None, clip_mode="norm", token_label=True,
             token_label_data="synthetic", token_label_size=IMG // 16, dense_weight=0.5,
             cls_weight=1.0, ground_truth=False, smoothing=0.1, seed=42,
             search_probe_steps=2, search_time_iters=2)
    d.update(kw)
    return types.SimpleNamespace(**d)


def make_batch(seed=0):
    rs = np.random.default_rng(seed)
    scores = rs.random((B, 5, 14, 14)).astype(np.float32)
    scores /= scores.sum(1, keepdims=True) * 1.25
    return {"image": rs.normal(size=(B, IMG, IMG, 3)).astype(np.float32),
            "label": rs.integers(0, NC, B).astype(np.int32),
            "label_scores": scores,
            "label_inds": rs.integers(0, NC, (B, 5, 14, 14)).astype(np.int32)}


@pytest.fixture(scope="module")
def pair():
    """volo_h2_l4 in both packages on the same parameters."""
    args = make_args()
    jmodel = jax_create_model("volo_h2_l4").make(num_classes=NC, img_size=IMG,
                                                 dtype=jnp.float32)
    variables = jax.jit(lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                                            jnp.zeros((1, IMG, IMG, 3)), train=False))()
    params, bs = variables["params"], variables["batch_stats"]
    jsb = JaxStepBuilder(model=jmodel, tx=joptim.create_optimizer(args, params),
                         train_loss=jax_build_train_loss(args), num_classes=NC,
                         token_label=True, has_token_label_data=True, donate=False)
    tmodel = create_model("volo_h2_l4").make(num_classes=NC, img_size=IMG,
                                             dtype=torch.float32)
    tmodel.load_state_dict(flax_to_torch(params, bs))
    tsb = StepBuilder(train_loss=build_train_loss(args), num_classes=NC, token_label=True,
                      has_token_label_data=True)
    state = TrainState.create(model=tmodel, optimizer=toptim.create_optimizer(args, tmodel),
                              ema_decays=(0.9,))
    return types.SimpleNamespace(args=args, jsb=jsb, params=params, bs=bs, tsb=tsb,
                                 state=state)


@pytest.mark.parametrize("r,l", [(64, 4), (32, 2)])
def test_loss_probe_step_matches_jax(pair, monkeypatch, r, l):
    keep = elastic_keep_masks(l, 2, 4, "volo")
    batch = make_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(11)
    ref = pair.jsb.loss_probe_step(r=r, keep=keep)(pair.params, pair.bs, jbatch, rng)
    out, _ = pair.jsb._apply_train(pair.params, pair.bs,
                                   jax_resize_bilinear(jbatch["image"], r), rng, keep)
    bbox = torch.tensor(np.asarray(out[2]))
    monkeypatch.setattr(tvolo, "rand_bbox", lambda gen, h, w: bbox)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    stats = {k: v.clone() for k, v in pair.state.batch_stats.items()}
    got = pair.tsb.loss_probe_step(pair.state, tbatch, r=r, keep=keep)
    assert float(got) == pytest.approx(float(ref), abs=1e-4)
    # an EMA tree in place of the parameters; the copy gives the same loss
    ema = pair.tsb.loss_probe_step(pair.state, tbatch, r=r, keep=keep,
                                   params=pair.state.ema_params[0])
    assert float(ema) == pytest.approx(float(got), abs=1e-6)
    # the probe leaves the BatchNorm running stats as they were
    for k, v in pair.state.batch_stats.items():
        assert torch.equal(v, stats[k]), k


def _ctx(pair):
    return types.SimpleNamespace(args=pair.args, sb=pair.tsb, state=pair.state,
                                 device=torch.device("cpu"))


def test_probe_candidate_returns_loss_and_positive_time(pair):
    batches = [{k: torch.from_numpy(v) for k, v in make_batch(s).items()} for s in (1, 2)]
    keep = elastic_keep_masks(2, 2, 4, "volo")
    before = {n: p.detach().clone() for n, p in pair.state.params.items()}
    out = tauto.probe_candidate(_ctx(pair), batches, r=32, keep=keep,
                                params=pair.state.ema_params[0], with_time=True)
    assert set(out) == {"loss", "time"}
    assert np.isfinite(out["loss"]) and out["time"] > 0
    again = tauto.probe_candidate(_ctx(pair), batches, r=32, keep=keep,
                                  params=pair.state.ema_params[0])
    assert set(again) == {"loss"}
    assert again["loss"] == out["loss"]          # same generators, same batches
    # no optimizer step, no gradient left behind
    for n, p in pair.state.params.items():
        assert torch.equal(p.detach(), before[n]) and p.grad is None, n
    with pytest.raises(ValueError, match="no probe batches"):
        tauto.probe_candidate(_ctx(pair), [], r=32, keep=keep, params=None)


class FakeLoader:
    def __init__(self, n):
        self.n, self.closed, self.epochs = n, 0, []

    def set_epoch(self, e):
        self.epochs.append(e)

    def __iter__(self):
        for i in range(self.n):
            yield {"image": np.full((2, 4, 4, 3), i, np.float32),
                   "label": np.full((2,), i, np.int32)}

    def close(self):
        self.closed += 1


def test_take_probe_batches_wraps_and_closes(pair):
    loader = FakeLoader(2)
    batches = tauto.take_probe_batches(_ctx(pair), loader, 5)
    assert [int(b["label"][0]) for b in batches] == [0, 1, 0, 1, 0]
    assert all(isinstance(b["image"], torch.Tensor) for b in batches)
    assert loader.closed == 1 and loader.epochs == [0]
    with pytest.raises(RuntimeError, match="no probe batches"):
        tauto.take_probe_batches(_ctx(pair), FakeLoader(0), 3)


def test_sync_decision_is_the_identity_in_one_process():
    assert tauto.sync_decision(160, 12) == (160, 12)


def test_recalibrate_bn_resets_and_reestimates(pair):
    model = pair.state.model
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    tbn.reset_batch_stats(model)
    stats = dict(model.named_buffers())
    assert all(float(v.abs().max()) == 0 for k, v in stats.items() if "mean" in k)
    assert all(torch.equal(v, torch.ones_like(v)) for k, v in stats.items() if "var" in k)
    images = make_batch(3)["image"]

    class Images(FakeLoader):
        def __iter__(self):
            for _ in range(self.n):
                yield {"image": images}

    loader = Images(2)
    ctx = _ctx(pair)
    tbn.recalibrate_bn(ctx, loader, r=32, max_steps=3)
    assert loader.closed == 1
    mean = stats["patch_embed.stem0.bn.running_mean"]
    assert float(mean.abs().max()) > 0
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), saved[n]), n
    model.load_state_dict(saved)
