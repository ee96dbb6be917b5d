"""Loss functions, counterpart of `autoprog_tpu/losses.py`.

Token-label losses consume the VOLO training triple (x_cls, x_aux, bbox)
and reconstruct the MixToken lambda from the box. The other losses take the
cls logits: the first element where the model returns a tuple (VOLO's
triple, the distilled DeiT's (x_cls, x_dist)). Cross-entropy runs in f32
whatever the compute dtype. Target formats: soft rows [B, C], or the dense
token-label map [B, C, 2+N] (slot 0 ground truth, slot 1 cls target,
slots 2.. per-token targets), or the sparse token-label dict of
`data/token_label.sparse_token_label_target`. `--jsd` with `--aug-splits`
trains on the JSD consistency loss, which takes the integer labels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from autoprog_tpu_torch.data.token_label import smooth_one_hot
from autoprog_tpu_torch.ops.mixtoken import mix_lambda
from autoprog_tpu_torch.parallel.mesh import flip_batch


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
    return lam * target_cls + (1.0 - lam) * flip_batch(target_cls)


def _split_target(target, B, N, C):
    if target.ndim == 2:
        return target, target[:, None, :].expand(B, N, C).reshape(B * N, C)
    return target[:, :, 1], target[:, :, 2:].transpose(1, 2).reshape(-1, C)


def _sparse_aux_ce(x_aux: torch.Tensor, st: dict) -> torch.Tensor:
    """Aux-token soft CE against a sparse target dict, equal to
    `_soft_ce(x_aux.reshape(-1, C), dense_target)` by

      sum_c -t[c] * logp[c] = -(sum_k vals_k * logp[inds_k] + u * sum_c logp[c]):

    K' log-probabilities are gathered per token; no [B*N, C] target exists."""
    B, N, C = x_aux.shape
    x = x_aux.reshape(B * N, C).float()
    lse = torch.logsumexp(x, dim=-1)
    sum_logp = x.sum(-1) - C * lse
    v = st["vals"].reshape(B * N, -1)
    g = x.gather(-1, st["inds"].reshape(B * N, -1).long()) - lse[:, None]
    row = (v * g).sum(-1) + st["u"].reshape(B * N) * sum_logp
    return -row.mean()


def token_label_cross_entropy(outputs, target, *, dense_weight: float = 0.5,
                              cls_weight: float = 1.0) -> torch.Tensor:
    """TokenLabelCrossEntropy."""
    x_cls, x_aux, bbox = outputs
    B, N, C = x_aux.shape
    if isinstance(target, dict):
        return (cls_weight * _soft_ce(x_cls, _mix_cls_target(target["cls"], bbox, N))
                + dense_weight * _sparse_aux_ce(x_aux, target))
    target_cls, target_aux = _split_target(target, B, N, C)
    target_cls = _mix_cls_target(target_cls, bbox, N)
    return (cls_weight * _soft_ce(x_cls, target_cls)
            + dense_weight * _soft_ce(x_aux.reshape(-1, C), target_aux))


def token_label_gt_cross_entropy(outputs, target, *, dense_weight: float = 0.5,
                                 cls_weight: float = 1.0) -> torch.Tensor:
    """TokenLabelGTCrossEntropy: the cls target is blended with the ground
    truth at 0.9 / 0.5 depending on whether their argmaxes agree."""
    x_cls, x_aux, bbox = outputs
    B, N, C = x_aux.shape
    if isinstance(target, dict):
        target_cls = _blend_ground_truth(target["cls"], target["gt"])
        return (cls_weight * _soft_ce(x_cls, _mix_cls_target(target_cls, bbox, N))
                + dense_weight * _sparse_aux_ce(x_aux, target))
    target_cls, target_aux = _split_target(target, B, N, C)
    if target.ndim != 2:
        target_cls = _blend_ground_truth(target_cls, target[:, :, 0])
    target_cls = _mix_cls_target(target_cls, bbox, N)
    return (cls_weight * _soft_ce(x_cls, target_cls)
            + dense_weight * _soft_ce(x_aux.reshape(-1, C), target_aux))


def _blend_ground_truth(target_cls, ground_truth):
    agree = ground_truth.argmax(-1) == target_cls.argmax(-1)
    ratio = (0.9 - 0.4 * agree.float())[:, None]
    return target_cls * ratio + ground_truth * (1.0 - ratio)


def token_label_soft_target_cross_entropy(logits, target) -> torch.Tensor:
    """TokenLabelSoftTargetCrossEntropy: soft CE that also takes relabel
    style [B, N, 2] targets."""
    if target.ndim == 3 and target.shape[-1] == 2:
        target = target[:, :, 1]
    return _soft_ce(logits, target)


def jsd_cross_entropy(logits, labels, *, num_splits: int = 3, alpha: float = 12.0,
                      smoothing: float = 0.1, num_classes=None) -> torch.Tensor:
    """JSD consistency loss of AugMix-style aug splits (timm
    JsdCrossEntropy): smoothed hard CE on the clean split (the first) plus
    alpha * the mean KL(p_i || M), M the mean softmax over the splits."""
    logits = logits.float()
    C = num_classes or logits.shape[-1]
    chunks = torch.chunk(logits, num_splits, dim=0)
    target = smooth_one_hot(labels, C, smoothing)
    clean_ce = torch.sum(-target * F.log_softmax(chunks[0], dim=-1), dim=-1).mean()
    probs = [F.softmax(c, dim=-1) for c in chunks]
    log_m = (sum(probs) / num_splits).clamp(1e-7, 1.0).log()
    kl = sum(torch.sum(p * (p.clamp(1e-7, 1.0).log() - log_m), dim=-1)
             for p in probs) / num_splits
    return clean_ce + alpha * kl.mean()


def build_train_loss(args):
    """Pick the training loss from flags, as the JAX package does. The JSD
    loss is marked `wants_int_labels` (the step passes the labels as its
    target) and the token-label losses `supports_sparse_tl`."""
    if getattr(args, "jsd", False) and getattr(args, "aug_splits", 0) > 1:
        ns, sm, nc = args.aug_splits, args.smoothing, args.num_classes

        def jsd_loss(out, labels):
            return jsd_cross_entropy(out[0] if isinstance(out, tuple) else out, labels,
                                     num_splits=ns, smoothing=sm, num_classes=nc)
        jsd_loss.wants_int_labels = True
        return jsd_loss
    if args.token_label:
        if args.token_label_size == 1:
            return lambda out, tgt: token_label_soft_target_cross_entropy(
                out[0] if isinstance(out, tuple) else out, tgt)
        fn = token_label_gt_cross_entropy if args.ground_truth \
            else token_label_cross_entropy
        dw, cw = args.dense_weight, args.cls_weight

        def token_label_loss(out, tgt):
            return fn(out, tgt, dense_weight=dw, cls_weight=cw)
        token_label_loss.supports_sparse_tl = True
        return token_label_loss
    return lambda out, tgt: soft_target_cross_entropy(
        out[0] if isinstance(out, tuple) else out, tgt)
