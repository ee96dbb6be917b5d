"""The system under test: the port's train step, built as its trainer builds
it, with the benchmark's weights loaded into it. The only module of the
benchmark that imports the program (`autoprog_tpu_torch`), and only inside
these functions.

  * the model from the port's registry (`create_model(...).make`), built
    straight on the device, then given the benchmark's weights;
  * the state from `TrainState.create` with `create_optimizer` and the EMA
    decays; the loss from `build_train_loss`;
  * the step `StepBuilder.train_step`, called as the trainer calls it, with
    the batch's MixToken box handed in (`bbox`);
  * across chips, the same call on every rank under `parallel/mesh.py`
    (global-batch BatchNorm, MixToken's flip and the gradient all-reduce).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass
class Program:
    step_builder: object
    state: object
    lr: float
    img_size: int

    def step(self, batch: dict) -> torch.Tensor:
        """One train step on this rank's rows; the loss as a device scalar."""
        bbox = batch.get("bbox")
        box = None if bbox is None else torch.tensor(bbox, dtype=torch.int32)
        return self.step_builder.train_step(self.state, batch, self.lr, r=self.img_size,
                                            bbox=box)["loss"]

    def named_parameters(self):
        return self.state.model.named_parameters()

    def first_moment(self, p: torch.Tensor) -> torch.Tensor:
        """AdamW's first moment of `p`; zeros where the optimizer has not
        stepped it."""
        st = self.state.optimizer.state.get(p)
        return st["exp_avg"] if st else torch.zeros_like(p)

    def ema_trees(self):
        return self.state.ema_params


def init_distributed() -> None:
    """Join the process group that the environment describes (torchrun's
    variables, set by the benchmark for each rank)."""
    from autoprog_tpu_torch.parallel import mesh
    mesh.maybe_init_distributed()


def destroy_distributed() -> None:
    from autoprog_tpu_torch.parallel import mesh
    mesh.destroy()


def build_kernels() -> None:
    """Compile the port's CUDA libraries where they are missing (their
    cache is `build/kernels/` inside the checkout)."""
    from autoprog_tpu_torch import _build
    _build.build()


def build(cell, weights: Dict[str, torch.Tensor], device: torch.device, seed: int,
          rank: int = 0) -> Program:
    from autoprog_tpu_torch.losses import build_train_loss
    from autoprog_tpu_torch.registry import create_model
    from autoprog_tpu_torch.train.optim import create_optimizer
    from autoprog_tpu_torch.train.state import TrainState
    from autoprog_tpu_torch.train.steps import StepBuilder

    cfg, rec = cell.config, cell.traffic["recipe"]
    if cfg["compute_dtype"] != "bfloat16" or cfg["param_dtype"] != "float32":
        raise ValueError("the port trains with f32 parameters and bf16 compute")
    token_label = rec["loss"] == "token_label"
    with torch.device(device):
        net = create_model(cfg["program_model"]).make(
            num_classes=cfg["num_classes"], img_size=cell.traffic["img_size"],
            drop_path_rate=cfg["drop_path_rate"], dtype=torch.bfloat16)
    load_weights(net, weights)
    args = argparse.Namespace(
        opt=rec["optimizer"], opt_eps=rec["eps"], opt_betas=list(rec["betas"]), momentum=0.9,
        weight_decay=rec["weight_decay"], clip_grad=None, clip_mode="norm",
        token_label=token_label, token_label_data="synthetic",
        token_label_size=cfg.get("token_label_grid", 1), dense_weight=rec.get("dense_weight"),
        cls_weight=rec.get("cls_weight"), ground_truth=False, smoothing=rec["smoothing"],
        adam_mu_bf16=False)
    decays = tuple(rec["ema_decays"])
    state = TrainState.create(model=net, optimizer=create_optimizer(args, net),
                              ema_decays=decays)
    sb = StepBuilder(train_loss=build_train_loss(args), ema_decays=decays,
                     num_classes=cfg["num_classes"], smoothing=rec["smoothing"],
                     token_label=token_label, has_token_label_data=token_label,
                     device=device, seed=seed % (2 ** 31), rank=rank)
    return Program(sb, state, rec["lr"], cell.traffic["img_size"])


def load_weights(net: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy the benchmark's weights into the model; every parameter has to
    be given, at its shape, and nothing else."""
    params = dict(net.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"parameters differ from the reference's: program only "
                         f"{sorted(set(params) - set(weights))[:5]}, reference only "
                         f"{sorted(set(weights) - set(params))[:5]}")
    with torch.no_grad():
        for n, p in params.items():
            if tuple(p.shape) != tuple(weights[n].shape):
                raise ValueError(f"{n}: program {tuple(p.shape)}, reference "
                                 f"{tuple(weights[n].shape)}")
            p.copy_(weights[n])


def launches() -> dict:
    """K1's and K2's launch counts so far (shown on stderr: the fused path ran)."""
    from autoprog_tpu_torch.ops import launch_counts
    return launch_counts()
