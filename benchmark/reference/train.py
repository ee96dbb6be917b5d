"""The reference's three training steps: targets, losses, gradients by
autograd, AdamW and the EMA sweeps, in plain float32 PyTorch, and the
readings that `benchmark/correct.py` compares with the program's:

  * `loss`: the training loss of each step;
  * `grad`: the norm of each parameter's first gradient, and the gradient
    itself (`grad_t`);
  * `delta`: each parameter's change over the three steps;
  * `ema`: per EMA decay, each EMA leaf's change over them.

Targets, from the token-labeling recipe (Jiang et al., arXiv 2104.10858) as
the configuration's `semantics` state it: the stored top-K class scores of
each token are scattered into a dense map (equal class indices add),
clipped to [0, 1], label-smoothed and renormalised per token; the class
target is the smoothed mean of that map over the tokens, normalised, or
the one-hot label where the map holds under 5 % of a unit of mass; under
MixToken the class target is mixed with the mirrored image's by the share
of tokens outside the box. Without token labels the target is the
label-smoothed one-hot row. The soft cross-entropy is the mean over rows.

AdamW (Loshchilov and Hutter) with bias correction and decoupled decay
from the pre-update parameter, no decay on vectors, the position
embedding or the class token. Each EMA tree starts as the parameters and
moves as e = d e + (1 - d) p after every update.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference import deit, volo
from benchmark.reference.numerics import Numerics, float32_exact

FAMILIES = {"volo": volo, "deit": deit}
NO_DECAY = ("pos_embed", "cls_token", "dist_token")


def family(cfg: dict):
    return FAMILIES[cfg["family"]]


def param_shapes(cfg: dict):
    return family(cfg).param_shapes(cfg)


def token_label_target(batch: dict, cfg: dict, recipe: dict):
    """(class target [B, C], token target [B N, C])."""
    scores, inds, labels = batch["label_scores"].float(), batch["label_inds"], batch["label"]
    C, s = cfg["num_classes"], recipe["smoothing"]
    B, K, h, w = scores.shape
    if (h, w) != (cfg["token_label_grid"],) * 2:
        raise ValueError("the reference takes token labels stored at the token grid")
    dense = scores.new_zeros(B, h, w, C).scatter_add_(
        3, inds.permute(0, 2, 3, 1).long(), scores.permute(0, 2, 3, 1))
    dense = dense.clamp(0.0, 1.0)
    tok = (1 - s) * dense + s / C
    tok = tok / tok.sum(-1, keepdim=True).clamp_min(1e-6)
    mean_map = dense.mean((1, 2))
    mass = mean_map.sum(-1, keepdim=True)
    relabel = torch.where(mass > 0.05, mean_map / mass.clamp_min(1e-6),
                          F.one_hot(labels.long(), C).float())
    return (1 - s) * relabel + s / C, tok.reshape(B * h * w, C)


def soft_ce(logits, target):
    return torch.sum(-target * F.log_softmax(logits, dim=-1), dim=-1).mean()


def loss_of(out, batch: dict, cfg: dict, recipe: dict):
    C, s = cfg["num_classes"], recipe["smoothing"]
    if recipe["loss"] == "token_label":
        x_cls, x_aux = out
        t_cls, t_tok = token_label_target(batch, cfg, recipe)
        x1, y1, x2, y2 = (int(v) for v in batch["bbox"])
        lam = 1.0 - (x2 - x1) * (y2 - y1) / x_aux.shape[1]
        t_cls = lam * t_cls + (1.0 - lam) * t_cls.flip(0)
        return (recipe["cls_weight"] * soft_ce(x_cls, t_cls)
                + recipe["dense_weight"] * soft_ce(x_aux.reshape(-1, C), t_tok))
    if recipe["loss"] == "label_smoothing":
        target = F.one_hot(batch["label"].long(), C).float() * (1 - s) + s / C
        return soft_ce(out[0], target)
    raise ValueError(f"unknown loss {recipe['loss']!r}")


def decays(name: str, p: torch.Tensor) -> bool:
    return p.ndim > 1 and not any(part in NO_DECAY for part in name.split("."))


def run_steps(weights: Dict[str, torch.Tensor], batches: Sequence[dict], cfg: dict,
              recipe: dict, precision: str = "float32",
              checkpoint_blocks: bool = False) -> dict:
    """Train from `weights` (left untouched) on `batches`, one step each,
    and return the readings (host floats and host tensors)."""
    num = Numerics(precision)
    fam = family(cfg)
    names = list(weights)
    P = {n: weights[n].detach().clone().float().requires_grad_(True) for n in names}
    b1, b2 = recipe["betas"]
    eps, lr, wd = recipe["eps"], recipe["lr"], recipe["weight_decay"]
    m = {n: torch.zeros_like(P[n]) for n in names}
    v = {n: torch.zeros_like(P[n]) for n in names}
    ema = [{n: P[n].detach().clone() for n in names} for _ in recipe["ema_decays"]]
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    grad_t: Dict[str, torch.Tensor] = {}
    with float32_exact():
        for t, batch in enumerate(batches, start=1):
            out = fam.forward(P, batch["image"].float(), batch.get("bbox"), cfg, num,
                              checkpoint_blocks)
            loss = loss_of(out, batch, cfg, recipe)
            grads = torch.autograd.grad(loss, [P[n] for n in names])
            losses.append(float(loss.detach()))
            del out, loss
            with torch.no_grad():
                if t == 1:
                    grad_norms = {n: float(g.norm()) for n, g in zip(names, grads)}
                    grad_t = {n: g.cpu() for n, g in zip(names, grads)}
                bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
                for n, g in zip(names, grads):
                    p = P[n]
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    upd = (m[n] / bc1) / ((v[n] / bc2).sqrt() + eps)
                    if decays(n, p):
                        upd = upd + wd * p
                    p.sub_(lr * upd)
                for d, e in zip(recipe["ema_decays"], ema):
                    for n in names:
                        e[n].mul_(d).add_(P[n], alpha=1 - d)
            del grads
    with torch.no_grad():
        delta = {n: (P[n] - weights[n].float()).cpu() for n in names}
        ema_delta = [{n: (e[n] - weights[n].float()).cpu() for n in names} for e in ema]
    return {"loss": losses, "grad": grad_norms, "grad_t": grad_t, "delta": delta,
            "ema": ema_delta}
