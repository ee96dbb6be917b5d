"""Token-labeling dense targets on the device, counterpart of
`autoprog_tpu/data/token_label.py` (the dense path, the default).

Builds the [B, C, 2+N] target the token-label losses index: slot 0 the
smoothed ground truth, slot 1 the crop-aware "relabel" cls target, slots
2.. the per-token class distributions at the stage's token grid.

`sparse_token_label_target` (AUTOPROG_SPARSE_TL=1) is the same target as a
dict of per-token top-K' entries plus a smoothing floor, which the losses
contract by gathering K' log-probabilities per token instead of reading a
dense [B, C, 2+N] map.
"""

from __future__ import annotations

import numpy as np
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


def _resize_taps(src: int, dst: int):
    """Bilinear taps of `resize_bilinear` (half-pixel centres, no
    antialiasing): output i samples x = (i + 0.5) * src / dst - 0.5, linear
    between floor and ceil, edge-clamped. (i0, i1, w0, w1) as numpy arrays."""
    if src == dst:
        idx = np.arange(src)
        return idx, idx, np.ones(src, np.float32), np.zeros(src, np.float32)
    x = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    i0 = np.floor(x).astype(np.int64)
    w1 = (x - i0).astype(np.float32)
    i1 = np.clip(i0 + 1, 0, src - 1)
    i0 = np.clip(i0, 0, src - 1)
    return i0, i1, 1.0 - w1, w1


def sparse_token_label_target(labels: torch.Tensor, scores: torch.Tensor,
                              inds: torch.Tensor, *, num_classes: int,
                              smoothing: float, label_size: int,
                              gt_soft=None) -> dict:
    """The target of `build_token_label_target` in sparse form:

      {"gt": [B, C], "cls": [B, C],
       "vals": [B, N, K'], "inds": [B, N, K'], "u": [B, N]}

    where a token's target is t[c] = sum_k vals[k] * [inds[k] == c] + u:
    vals carry the (1 - s) / Z renormalised top-K mass and u = s / (C * Z)
    is the smoothing floor. K' = K when the stored grid is the token grid,
    else 4K (the 2x2 bilinear taps; duplicate class indices add)."""
    B, K, H, W = scores.shape
    n = label_size
    scores = scores.float()
    if (H, W) == (n, n):
        v, ix = scores, inds
    else:
        h0, h1, wh0, wh1 = _resize_taps(H, n)
        w0, w1, ww0, ww1 = _resize_taps(W, n)

        def dev(a):   # non_blocking: a blocking copy would wait for the stream
            return torch.as_tensor(a).to(scores.device, non_blocking=True)
        vs, ixs = [], []
        for hi, hw in ((h0, wh0), (h1, wh1)):
            for wi, ww in ((w0, ww0), (w1, ww1)):
                hi_t, wi_t = dev(hi), dev(wi)
                vs.append(scores[:, :, hi_t][:, :, :, wi_t] * dev(hw[:, None] * ww[None, :]))
                ixs.append(inds[:, :, hi_t][:, :, :, wi_t])
        v, ix = torch.cat(vs, dim=1), torch.cat(ixs, dim=1)   # [B, 4K, n, n]
    Kp = v.shape[1]
    v = v.reshape(B, Kp, n * n).transpose(1, 2)               # [B, N, K']
    ix = ix.reshape(B, Kp, n * n).transpose(1, 2)

    # cls "relabel" row: the token mean of the (resized) dense map,
    # normalised, as the dense path's dense.mean((1, 2))
    mean_map = v.new_zeros(B, num_classes).scatter_add_(
        1, ix.reshape(B, -1).long(), v.reshape(B, -1)) / (n * n)
    mass = mean_map.sum(-1, keepdim=True)
    relabel = torch.where(mass > 0.05, mean_map / mass.clamp_min(1e-6),
                          F.one_hot(labels.long(), num_classes).float())
    cls_target = (1.0 - smoothing) * relabel + smoothing / num_classes
    gt = gt_soft if gt_soft is not None else smooth_one_hot(labels, num_classes,
                                                             smoothing)
    z = ((1.0 - smoothing) * v.sum(-1) + smoothing).clamp_min(1e-6)
    return {"gt": gt, "cls": cls_target, "vals": (1.0 - smoothing) * v / z[..., None],
            "inds": ix, "u": smoothing / num_classes / z}
