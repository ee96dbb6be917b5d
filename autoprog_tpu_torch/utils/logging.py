"""Logging + CSV summary (reference: timm setup_default_logging /
update_summary, `main_prog.py:343,913-918`; SURVEY §5.5)."""

from __future__ import annotations

import csv
import logging
import os
from collections import OrderedDict
from typing import Dict


def setup_logging(log_path: str = "", level=logging.INFO) -> None:
    fmt = "%(asctime)s %(levelname)s %(name)s: %(message)s"
    handlers = [logging.StreamHandler()]
    if log_path:
        os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
        handlers.append(logging.FileHandler(log_path))
    logging.basicConfig(level=level, format=fmt, handlers=handlers,
                        force=True)


def update_summary(epoch: int, train_metrics: Dict, eval_metrics: Dict,
                   filename: str, write_header: bool = False) -> None:
    rowd = OrderedDict(epoch=epoch)
    rowd.update([("train_" + k, v) for k, v in train_metrics.items()])
    rowd.update([("eval_" + k, v) for k, v in eval_metrics.items()])
    mode = "w" if write_header else "a"
    with open(filename, mode, newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rowd.keys()))
        if write_header:
            w.writeheader()
        w.writerow(rowd)


def make_output_dir(base: str, model_name: str, suffix: str = "prog") -> str:
    """`output/train/<timestamp>-<model>-<suffix>` (`main_prog.py:336-342`)."""
    import datetime
    name = "-".join([datetime.datetime.now().strftime("%Y%m%d-%H%M%S"),
                     model_name, suffix])
    path = os.path.join(base or "./output", "train", name)
    os.makedirs(path, exist_ok=True)
    return path
