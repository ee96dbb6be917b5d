"""Finding a cell's files by name.

`BENCHMARK.json` at the root of the checkout lists the configurations,
cells and metrics. Everything that belongs to one of them sits in a file of
its own beside this module, found by its name:

  * `configs/<config>.json` (or the `file` BENCHMARK.json gives it): the
    model's sizes and the semantics the reference follows;
  * `workloads/<cell>.json`: the cell's traffic and recipe (image size,
    batch per chip, chips, loss, optimizer, EMAs, the batch pool) and the
    limits of its correctness check;
  * `metrics/<metric>.py`: a per-layer metric's reader, with its layer,
    unit, source and the end-to-end metric it moves, and `compute(ctx)`.

A cell, configuration or metric that is not listed, or whose file is
missing, is refused.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    traffic: dict                  # workloads/<cell>.json
    config: dict                   # the configuration file
    end_to_end: List[dict]         # BENCHMARK.json's entries this cell reports
    per_layer: List[dict]
    readers: Dict[str, ModuleType]  # per-layer metric name -> its module

    @property
    def model(self) -> dict:
        """The configuration at the cell's image size (what the program
        builds, the reference runs and the cost formulas count)."""
        return {**self.config, "img_size": self.traffic["img_size"]}

    @property
    def batch(self) -> int:
        return self.traffic["batch_per_chip"]

    @property
    def global_batch(self) -> int:
        return self.traffic["batch_per_chip"] * self.chips


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_reader(path: Path) -> ModuleType:
    """A metric's module, loaded from its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for attr in ("LAYER", "UNIT", "SOURCE", "MOVES", "BETTER", "compute"):
        if not hasattr(mod, attr):
            raise ValueError(f"metric file {path} has no {attr}")
    return mod


def load(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    here = root / "benchmark"
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; BENCHMARK.json lists {sorted(cells)}")
    entry = cells[name]
    traffic = json.loads((here / "workloads" / f"{name}.json").read_text())
    configs = {c["name"]: c for c in bench["configs"]}
    if entry["config"] not in configs:
        raise KeyError(f"cell {name} names an unlisted configuration {entry['config']!r}")
    config = json.loads((root / configs[entry["config"]]["file"]).read_text())
    for key, want in (("config", entry["config"]), ("chips", entry["chips"])):
        if traffic.get(key) != want:
            raise ValueError(f"workloads/{name}.json says {key}={traffic.get(key)!r}, "
                             f"BENCHMARK.json {want!r}")
    per_layer = [m for m in bench["per_layer"] if _reports(m, name)]
    readers = {}
    for m in per_layer:
        mod = load_reader(here / "metrics" / f"{m['name']}.py")
        for key in ("LAYER", "UNIT", "SOURCE", "MOVES", "BETTER"):
            if getattr(mod, key) != m[key.lower()]:
                raise ValueError(f"metrics/{m['name']}.py: {key} {getattr(mod, key)!r} "
                                 f"but BENCHMARK.json says {m[key.lower()]!r}")
        readers[m["name"]] = mod
    return Cell(name=name, chips=entry["chips"], traffic=traffic, config=config,
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=per_layer, readers=readers)
