"""`--remat full | dots` in the port: one train step with the blocks
recomputed in the backward against the same step without, from the same
parameters, batch and generator seeds, at drop-path 0.2 (with drop-path 0
a recompute that drew other DropPath masks would pass unseen). Tolerance:
the JAX package's own for its remat test (`tests/test_train_step.py`),
rtol 2e-5 and atol 2e-6 on the parameters after the step; the losses equal.
The recompute really runs (each block's forward is entered twice), and the
DropPath generator ends where the plain step leaves it, so the next step's
masks are not repeated.
"""

import argparse
import copy

import numpy as np
import pytest
import torch

from autoprog_tpu_torch import create_model
from autoprog_tpu_torch.losses import build_train_loss
from autoprog_tpu_torch.train import optim as toptim
from autoprog_tpu_torch.train.state import TrainState
from autoprog_tpu_torch.train.steps import StepBuilder

IMG, NC, B = 32, 10, 4


def _args(token_label):
    return argparse.Namespace(
        opt="adamw", opt_eps=None, opt_betas=None, momentum=0.9, weight_decay=0.05,
        token_label=token_label, token_label_size=IMG // 16, dense_weight=0.5,
        cls_weight=1.0, ground_truth=False, smoothing=0.1, jsd=False, aug_splits=0)


def _step(name, mode, base_state, batch, token_label):
    torch.manual_seed(0)
    model = create_model(name).make(num_classes=NC, img_size=IMG, dtype=torch.float32,
                                    drop_path_rate=0.2, remat=mode)
    model.load_state_dict(base_state)
    calls = []
    blocks = [m for n, m in model.named_children() if n.startswith("s")]
    for blk in blocks:
        blk.register_forward_pre_hook(lambda *a: calls.append(1))
    args = _args(token_label)
    state = TrainState.create(model=model, optimizer=toptim.create_optimizer(args, model))
    sb = StepBuilder(train_loss=build_train_loss(args), num_classes=NC,
                     token_label=token_label, has_token_label_data=token_label, seed=5)
    loss = float(sb.train_step(state, batch, 1e-3, r=IMG)["loss"])
    return loss, {n: p.detach().clone() for n, p in model.named_parameters()}, \
        len(calls) / len(blocks), sb.drop_gen.get_state()


@pytest.mark.parametrize("mode", ["full", "dots"])
@pytest.mark.parametrize("name", ["volo_h2_l4", "deit_h2_l2"])
def test_remat_step_equals_the_plain_step_at_drop_path(name, mode):
    token_label = name.startswith("volo")
    rs = np.random.default_rng(3)
    batch = {"image": torch.tensor(rs.normal(size=(B, IMG, IMG, 3)).astype(np.float32)),
             "label": torch.tensor(rs.integers(0, NC, B).astype(np.int32))}
    if token_label:
        batch["label_scores"] = torch.tensor(rs.random((B, 5, 2, 2)).astype(np.float32))
        batch["label_inds"] = torch.tensor(rs.integers(0, NC, (B, 5, 2, 2)).astype(np.int32))
    torch.manual_seed(1)
    base = copy.deepcopy(create_model(name).make(num_classes=NC, img_size=IMG,
                                                 dtype=torch.float32).state_dict())
    loss0, params0, calls0, gen0 = _step(name, "", base, batch, token_label)
    loss1, params1, calls1, gen1 = _step(name, mode, base, batch, token_label)
    assert (calls0, calls1) == (1, 2)
    assert torch.equal(gen0, gen1)
    assert loss1 == pytest.approx(loss0, rel=1e-6)
    moved = 0
    for n, p in params0.items():
        np.testing.assert_allclose(params1[n].numpy(), p.numpy(), rtol=2e-5, atol=2e-6,
                                   err_msg=n)
        moved += not torch.equal(p, base[n])
    assert moved == len(params0)


def test_remat_refuses_an_unknown_mode():
    model = create_model("deit_h2_l2").make(num_classes=NC, img_size=IMG,
                                            dtype=torch.float32, remat="some")
    with pytest.raises(ValueError, match="remat mode"):
        model(torch.zeros(1, IMG, IMG, 3), train=True)
    with torch.no_grad():      # nothing is recomputed where autograd records nothing
        assert model(torch.zeros(1, IMG, IMG, 3)).shape == (1, NC)
