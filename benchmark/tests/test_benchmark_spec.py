"""Finding cells, configurations and metrics by name, and the shape of
BENCHMARK.json."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark import spec
from conftest import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_every_listed_cell_loads_with_its_config_and_readers(cell):
    c = spec.load(cell)
    assert c.config["name"] == c.traffic["config"]
    assert c.traffic["limits"].keys() >= {"loss_gap", "grad_gap", "update_gap", "ema_gap"}
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "train_img_per_s"}
    assert c.per_layer and set(c.readers) == {m["name"] for m in c.per_layer}


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError, match="unknown workload"):
        spec.load("no-such-cell")


def test_a_missing_metric_file_is_refused(tmp_path):
    root = tmp_path / "r"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = _bench()
    bench["per_layer"].append({**bench["per_layer"][0], "name": "no_such_metric"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(FileNotFoundError):
        spec.load("volo_d1-b256", root)


def test_a_cell_and_metric_added_as_new_files_load_without_editing_any(tmp_path):
    """A later change adds a cell and a per-layer metric: new files, and
    their entries in BENCHMARK.json; no existing file of the benchmark is
    touched."""
    root = tmp_path / "r"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    traffic = json.loads((BENCH / "workloads" / "volo_d1-b256.json").read_text())
    traffic["batch_per_chip"] = 64
    (root / "benchmark" / "workloads" / "volo_d1-b64.json").write_text(json.dumps(traffic))
    (root / "benchmark" / "metrics" / "steps_per_s.py").write_text(
        'LAYER = "train step (train/steps.py, train/optim.py)"\nUNIT = "steps/s"\n'
        'SOURCE = "host_clock"\nMOVES = "train_img_per_s"\nBETTER = "higher"\n\n\n'
        'def compute(ctx):\n    w = ctx["window"]\n    return w["steps"] / w["wall_s"]\n')
    bench = _bench()
    bench["workloads"].append({"name": "volo_d1-b64", "config": "volo_d1",
                               "traffic": "volo_d1-b64", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "steps_per_s", "unit": "steps/s", "better": "higher",
                               "source": "host_clock",
                               "layer": "train step (train/steps.py, train/optim.py)",
                               "moves": "train_img_per_s", "workloads": ["volo_d1-b64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load("volo_d1-b64", root)
    assert cell.batch == 64 and "steps_per_s" in cell.readers
    assert cell.readers["steps_per_s"].compute({"window": {"steps": 10, "wall_s": 2.0}}) == 5
    assert "steps_per_s" not in spec.load("volo_d1-b256", root).readers
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_a_reader_that_disagrees_with_its_entry_is_refused(tmp_path):
    root = tmp_path / "r"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = _bench()
    bench["per_layer"][0]["unit"] = "s"
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError, match="UNIT"):
        spec.load("volo_d1-b256", root)


def test_benchmark_json_keeps_to_its_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in b["end_to_end"] + b["per_layer"])
    whys = [x["why"] for k in ("configs", "workloads") for x in b[k]]
    assert all(1 <= len(w) <= 200 and "\n" not in w and "\t" not in w for w in whys)
    fours = sum(w["chips"] == 4 for w in b["workloads"])
    assert fours <= max(1, len(b["workloads"]) // 4)
    for c in b["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert all(used in {w["config"] for w in b["workloads"]} for used in [c["name"]])


def test_a_four_card_cell_added_as_a_new_file_loads(tmp_path):
    """The four-card cell that waits in PERF.md's open questions comes as a
    new workload file and its entry; its file has to say the same chips."""
    root = tmp_path / "r"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    traffic = json.loads((BENCH / "workloads" / "volo_d1-b256.json").read_text())
    traffic["chips"] = 4
    (root / "benchmark" / "workloads" / "volo_d1-dp4-b128.json").write_text(json.dumps(traffic))
    bench = _bench()
    bench["workloads"].append({"name": "volo_d1-dp4-b128", "config": "volo_d1",
                               "traffic": "volo_d1-dp4-b128", "chips": 4, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load("volo_d1-dp4-b128", root)
    assert cell.chips == 4 and cell.global_batch == 1024
    bench["workloads"][-1]["chips"] = 1
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError, match="chips"):
        spec.load("volo_d1-dp4-b128", root)
