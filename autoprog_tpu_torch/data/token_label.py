"""Token-labeling dense targets on the device, counterpart of
`autoprog_tpu/data/token_label.py` (the dense path, the default).

Builds the [B, C, 2+N] target the token-label losses index: slot 0 the
smoothed ground truth, slot 1 the crop-aware "relabel" cls target, slots
2.. the per-token class distributions at the stage's token grid. The
sparse path (AUTOPROG_SPARSE_TL=1) is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from autoprog_tpu_torch.ops.interpolate import resize_bilinear


def smooth_one_hot(labels: torch.Tensor, num_classes: int,
                   smoothing: float = 0.1) -> torch.Tensor:
    """Label-smoothed one-hot rows [B, C], f32."""
    on = 1.0 - smoothing + smoothing / num_classes
    off = smoothing / num_classes
    return F.one_hot(labels.long(), num_classes).float() * (on - off) + off


def dense_from_topk(scores: torch.Tensor, inds: torch.Tensor,
                    num_classes: int) -> torch.Tensor:
    """Scatter-add top-K maps [B, K, H, W] into a dense [B, H, W, C] map."""
    B, K, H, W = scores.shape
    dense = scores.new_zeros(B, H, W, num_classes)
    return dense.scatter_add_(3, inds.permute(0, 2, 3, 1).long(),
                              scores.permute(0, 2, 3, 1))


def build_token_label_target(labels: torch.Tensor, scores: torch.Tensor,
                             inds: torch.Tensor, *, num_classes: int,
                             smoothing: float, label_size: int,
                             gt_soft=None) -> torch.Tensor:
    """[B, C, 2+N] token-label target with N = label_size**2."""
    B = labels.shape[0]
    dense = dense_from_topk(scores.float(), inds, num_classes)
    dense = resize_bilinear(dense, label_size).clamp(0.0, 1.0)
    tok = (1.0 - smoothing) * dense + smoothing / num_classes
    # renormalize each token (top-K truncation can lose a little mass)
    tok = tok / tok.sum(-1, keepdim=True).clamp_min(1e-6)
    tok = tok.reshape(B, label_size * label_size, num_classes)
    gt = gt_soft if gt_soft is not None else smooth_one_hot(labels, num_classes,
                                                             smoothing)
    mean_map = dense.mean(dim=(1, 2))                        # [B, C]
    mass = mean_map.sum(-1, keepdim=True)
    # crop-aware cls target, falling back to the GT row when the crop
    # missed the object (near-zero relabel mass)
    relabel = torch.where(mass > 0.05, mean_map / mass.clamp_min(1e-6),
                          F.one_hot(labels.long(), num_classes).float())
    cls_target = (1.0 - smoothing) * relabel + smoothing / num_classes
    return torch.cat([gt[:, :, None], cls_target[:, :, None],
                      tok.transpose(1, 2)], dim=2)
