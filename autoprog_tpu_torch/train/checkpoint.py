"""Checkpoint saving, counterpart of the save side of
`autoprog_tpu/train/checkpoint.py`.

  * atomic write (tmp + os.replace) of a `torch.save` payload;
  * `last.ckpt` always current; a hard-linked `keep-<epoch>.ckpt` every
    `NO_DEL_INTERVAL` epochs;
  * top-`max_history` `checkpoint-<epoch>.ckpt` ranked by metric, and a
    `model_best.ckpt` link;
  * batch-level `save_recovery`.

The payload carries the architecture name and stage record, parameters,
BatchNorm stats, optimizer state, one EMA tree per decay, the resolved args
YAML, the epoch and the metric. Loading, resume and recovery are not ported
yet (`main.py` refuses `--resume`).
"""

from __future__ import annotations

import glob
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

CKPT_EXT = ".ckpt"
NO_DEL_INTERVAL = 10   # epochs between kept `keep-<epoch>` snapshots


def _cpu(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in tree.items()}


def save_checkpoint_file(path: str, payload: Dict[str, Any]) -> None:
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


class CheckpointSaver:
    def __init__(self, *, checkpoint_dir: str, decreasing: bool = False,
                 max_history: int = 10):
        self.checkpoint_dir = checkpoint_dir
        self.decreasing = decreasing
        self.max_history = max(1, max_history)
        self.checkpoint_files: List[Tuple[str, float]] = []   # best first
        self.best_metric: Optional[float] = None
        self.best_epoch: Optional[int] = None
        os.makedirs(checkpoint_dir, exist_ok=True)

    def _cmp(self, a: float, b: float) -> bool:
        return a < b if self.decreasing else a > b

    def save_checkpoint(self, payload: Dict[str, Any], epoch: int,
                        metric: Optional[float] = None, prefix: str = ""
                        ) -> Tuple[Optional[float], Optional[int]]:
        """Write last + ranked snapshot; returns (best_metric, best_epoch).
        `prefix` names a separate series (the supernet search's "-search")."""
        payload = dict(payload, epoch=epoch, metric=metric, version=2)
        last = os.path.join(self.checkpoint_dir, f"last{prefix}{CKPT_EXT}")
        save_checkpoint_file(last, payload)
        if epoch % NO_DEL_INTERVAL == 0:
            self._link(last, os.path.join(self.checkpoint_dir,
                                          f"keep-{epoch}{prefix}{CKPT_EXT}"))
        worse_than_all = (len(self.checkpoint_files) >= self.max_history
                          and metric is not None
                          and not self._cmp(metric, self.checkpoint_files[-1][1]))
        if not worse_than_all:
            snap = os.path.join(self.checkpoint_dir,
                                f"checkpoint-{epoch}{prefix}{CKPT_EXT}")
            self._link(last, snap)
            self.checkpoint_files.append((snap, metric if metric is not None
                                          else float("-inf")))
            self.checkpoint_files.sort(key=lambda t: t[1], reverse=not self.decreasing)
            while len(self.checkpoint_files) > self.max_history:
                path, _ = self.checkpoint_files.pop()
                try:
                    os.remove(path)
                except OSError:
                    pass
        if metric is not None and (self.best_metric is None
                                   or self._cmp(metric, self.best_metric)):
            self.best_metric, self.best_epoch = metric, epoch
            self._link(last, os.path.join(self.checkpoint_dir, f"model_best{CKPT_EXT}"))
        return self.best_metric, self.best_epoch

    def save_recovery(self, payload: Dict[str, Any], epoch: int, batch_idx: int) -> None:
        path = os.path.join(self.checkpoint_dir, f"recovery-{epoch}-{batch_idx}{CKPT_EXT}")
        save_checkpoint_file(path, dict(payload, epoch=epoch, batch_idx=batch_idx,
                                        version=2))
        for old in glob.glob(os.path.join(self.checkpoint_dir, f"recovery-*{CKPT_EXT}")):
            if old != path:
                try:
                    os.remove(old)
                except OSError:
                    pass

    @staticmethod
    def _link(src: str, dst: str) -> None:
        try:
            if os.path.exists(dst):
                os.remove(dst)
            os.link(src, dst)
        except OSError:
            shutil.copy2(src, dst)


def build_payload(*, state, args_text: str, arch_name: str,
                  stage_info: Dict[str, Any]) -> Dict[str, Any]:
    p: Dict[str, Any] = {
        "arch": arch_name,
        "stage_info": dict(stage_info),
        "state_dict": _cpu(state.params),
        "batch_stats": _cpu(state.batch_stats),
        "optimizer": state.optimizer.state_dict(),
        "step": state.step,
        "args_text": args_text,
    }
    for i, ema in enumerate(state.ema_params):
        p[f"state_dict_ema_{i}"] = _cpu(ema)
    return p
