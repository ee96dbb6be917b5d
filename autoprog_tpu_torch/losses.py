"""Loss functions, counterpart of `autoprog_tpu/losses.py`.

Token-label losses consume the VOLO training triple (x_cls, x_aux, bbox)
and reconstruct the MixToken lambda from the box. The other losses take the
cls logits: the first element where the model returns a tuple (VOLO's
triple, the distilled DeiT's (x_cls, x_dist)). Cross-entropy runs in f32
whatever the compute dtype. Target formats: soft rows [B, C], or the dense
token-label map [B, C, 2+N] (slot 0 ground truth, slot 1 cls target,
slots 2.. per-token targets). The sparse token-label targets and the JSD
loss (`--jsd` with `--aug-splits`) are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from autoprog_tpu_torch.ops.mixtoken import mix_lambda


def _soft_ce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean over rows of sum(-target * log_softmax(logits)); a target with
    fewer rows is tiled (batch-repeat broadcast)."""
    logits, target = logits.float(), target.float()
    if target.shape[0] != logits.shape[0]:
        target = target.repeat(logits.shape[0] // target.shape[0], 1)
    return torch.sum(-target * F.log_softmax(logits, dim=-1), dim=-1).mean()


def soft_target_cross_entropy(logits, target):
    return _soft_ce(logits, target)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Hard-label CE."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def _mix_cls_target(target_cls, bbox, num_tokens: int):
    """Flip-mix the cls target by lambda = 1 - box_area / N."""
    lam = mix_lambda(bbox, num_tokens)
    return lam * target_cls + (1.0 - lam) * torch.flip(target_cls, dims=(0,))


def _split_target(target, B, N, C):
    if target.ndim == 2:
        return target, target[:, None, :].expand(B, N, C).reshape(B * N, C)
    return target[:, :, 1], target[:, :, 2:].transpose(1, 2).reshape(-1, C)


def _check_dense(target):
    if isinstance(target, dict):
        raise NotImplementedError("sparse token-label targets "
                                  "(AUTOPROG_SPARSE_TL=1) are not ported yet")


def token_label_cross_entropy(outputs, target, *, dense_weight: float = 0.5,
                              cls_weight: float = 1.0) -> torch.Tensor:
    """TokenLabelCrossEntropy."""
    _check_dense(target)
    x_cls, x_aux, bbox = outputs
    B, N, C = x_aux.shape
    target_cls, target_aux = _split_target(target, B, N, C)
    target_cls = _mix_cls_target(target_cls, bbox, N)
    return (cls_weight * _soft_ce(x_cls, target_cls)
            + dense_weight * _soft_ce(x_aux.reshape(-1, C), target_aux))


def token_label_gt_cross_entropy(outputs, target, *, dense_weight: float = 0.5,
                                 cls_weight: float = 1.0) -> torch.Tensor:
    """TokenLabelGTCrossEntropy: the cls target is blended with the ground
    truth at 0.9 / 0.5 depending on whether their argmaxes agree."""
    _check_dense(target)
    x_cls, x_aux, bbox = outputs
    B, N, C = x_aux.shape
    target_cls, target_aux = _split_target(target, B, N, C)
    if target.ndim != 2:
        ground_truth = target[:, :, 0]
        agree = ground_truth.argmax(-1) == target_cls.argmax(-1)
        ratio = (0.9 - 0.4 * agree.float())[:, None]
        target_cls = target_cls * ratio + ground_truth * (1.0 - ratio)
    target_cls = _mix_cls_target(target_cls, bbox, N)
    return (cls_weight * _soft_ce(x_cls, target_cls)
            + dense_weight * _soft_ce(x_aux.reshape(-1, C), target_aux))


def token_label_soft_target_cross_entropy(logits, target) -> torch.Tensor:
    """TokenLabelSoftTargetCrossEntropy: soft CE that also takes relabel
    style [B, N, 2] targets."""
    if target.ndim == 3 and target.shape[-1] == 2:
        target = target[:, :, 1]
    return _soft_ce(logits, target)


def build_train_loss(args):
    """Pick the training loss from flags, as the JAX package does."""
    if getattr(args, "jsd", False) and getattr(args, "aug_splits", 0) > 1:
        raise NotImplementedError("--jsd with --aug-splits is not ported yet")
    if args.token_label:
        if args.token_label_size == 1:
            return lambda out, tgt: token_label_soft_target_cross_entropy(
                out[0] if isinstance(out, tuple) else out, tgt)
        fn = token_label_gt_cross_entropy if args.ground_truth \
            else token_label_cross_entropy
        dw, cw = args.dense_weight, args.cls_weight
        return lambda out, tgt: fn(out, tgt, dense_weight=dw, cls_weight=cw)
    return lambda out, tgt: soft_target_cross_entropy(
        out[0] if isinstance(out, tuple) else out, tgt)
