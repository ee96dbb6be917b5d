"""Fixtures of the benchmark's CPU tests: a checkout-like root that holds a
`BENCHMARK.json` of tiny cells (the CPU sizes of the two model families)
beside the benchmark's own metric readers."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
REPO = BENCH.parent


#: the tiny cells' limits, set as the cells' own are (below the float8
#: control's readings, above the sound runs') from CPU readings at these
#: sizes: the gaps of a tiny model sit elsewhere than at full width
TINY_LIMITS = {
    "volo_tiny": {"loss_gap": 7e-5, "grad_gap": 0.02, "update_gap": 0.12, "ema_gap": 0.12},
    "deit_tiny": {"loss_gap": 4e-4, "grad_gap": 0.01, "update_gap": 0.01, "ema_gap": 0.013},
}


def tiny_cell(cell: str, config: str, batch: int, chips: int = 1) -> dict:
    """The traffic of a real cell, cut to a tiny config and batch."""
    source = {"volo_tiny": "volo_d1-b256", "deit_tiny": "deit_small-b512"}[config]
    t = json.loads((BENCH / "workloads" / f"{source}.json").read_text())
    t.update(config=config, chips=chips, img_size=32, batch_per_chip=batch, pool_batches=4,
             limits=TINY_LIMITS[config])
    return t


def make_root(tmp_path: Path, cells: dict) -> Path:
    """A root with BENCHMARK.json (the real metrics, the tiny cells) and
    the files it names; `cells` maps a cell name to its traffic dict."""
    root = tmp_path / "root"
    (root / "benchmark" / "workloads").mkdir(parents=True)
    (root / "benchmark" / "configs").mkdir()
    shutil.copytree(BENCH / "metrics", root / "benchmark" / "metrics")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = copy.deepcopy(bench)
    configs = {}
    for name in ("volo_tiny", "deit_tiny"):
        shutil.copy(HERE / "fixtures" / f"{name}.json", root / "benchmark" / "configs")
        configs[name] = {"name": name, "source": "test", "file": f"benchmark/configs/{name}.json",
                         "reduced": [], "why": "test"}
    bench["configs"] = list(configs.values())
    bench["workloads"] = []
    for name, traffic in cells.items():
        (root / "benchmark" / "workloads" / f"{name}.json").write_text(json.dumps(traffic))
        bench["workloads"].append({"name": name, "config": traffic["config"], "traffic": name,
                                   "chips": traffic["chips"], "why": "test"})
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [c for c in cells if cells[c]["config"] == "volo_tiny"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path, {"volo-t": tiny_cell("volo-t", "volo_tiny", 4),
                                "deit-t": tiny_cell("deit-t", "deit_tiny", 4)})
