"""A run driven end to end on the CPU at tiny sizes (the harness's look for a
card skipped): the result line, the correctness check with sound and broken
steps underneath, the control, the import check, and the refusal to run
without a card. The test marked `cuda` runs a real cell on the card."""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import subprocess
import sys

import pytest
import torch

from benchmark import correct, faults, run, spec
from conftest import REPO, make_root, tiny_cell

SEED = 2 ** 31 + 12345          # larger than 32 signed bits hold


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("AUTOPROG_TORCH_DEVICE", "cpu")


def _run(root, cell, trace=False, seed=SEED, **kw):
    return run.run_rank(spec.load(cell, root), seed, 0.3, trace, device=torch.device("cpu"),
                        **kw)


@pytest.mark.parametrize("cell", ["volo-t", "deit-t"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_prints_a_correct_result(tiny_root, cell, trace):
    res = _run(tiny_root, cell, trace)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-2:] == ["checks", "forbidden"]
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    c = spec.load(cell, tiny_root)
    want = [m["name"] for m in (c.per_layer if trace else c.end_to_end)]
    got = list(res["metrics"])
    if trace:     # a reader that finds nothing returns nothing: no kernels on the CPU
        assert set(got) <= set(want)
        assert {"step_mfu_pct", "step_ms_p95", "device_idle_pct", "peak_mem_gib"} <= set(got)
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "busy_s" in res["device"] and res["device"]["window_s"] > 0
    else:
        assert got == want
        assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["checks"]) == set(correct.NUMBERS) | {"nonfinite_steps"}
    assert all(v["value"] <= v["limit"] for v in res["checks"].values())


def test_the_same_seed_gives_the_same_readings(tiny_root):
    a, b = (_run(tiny_root, "deit-t")["checks"] for _ in range(2))
    assert a == b


def test_a_number_without_a_limit_is_shown_and_not_compared():
    """A limit of None shows the number in `checks` and leaves it out of
    the verdict; the numbers with limits still decide it."""
    nums = {name: {"value": 0.5, "leaf": None} for name in correct.NUMBERS}
    nums["loss_gap"]["value"] = 5.0
    limits = {name: 1.0 for name in correct.NUMBERS}
    assert correct.judge(nums, limits, 0)["correct"] is False
    verdict = correct.judge(nums, {**limits, "loss_gap": None}, 0)
    assert verdict["checks"]["loss_gap"] == {"value": 5.0, "limit": None}
    assert verdict["correct"] is True
    assert correct.judge(nums, {**limits, "loss_gap": None, "grad_gap": 0.1}, 0)["correct"] is False
    assert correct.judge(nums, {**limits, "loss_gap": None}, 1)["correct"] is False


@pytest.mark.parametrize("cell", ["volo-t", "deit-t"])
@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
def test_a_broken_step_is_not_correct(tiny_root, cell, fault):
    with faults.planted(fault):
        res = _run(tiny_root, cell)
    assert res["correct"] is False
    over = [k for k, v in res["checks"].items() if v["value"] > v["limit"]]
    assert over, res["checks"]
    if fault == "frozen":
        assert res["checks"]["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", ["volo-t", "deit-t"])
def test_the_fp8_control_is_not_correct(tiny_root, cell):
    """The reference in float8 put in the program's place, at a test size,
    fails the cell's limits (on the card it is read at the cell's size by
    `benchmark.calibrate --control`)."""
    c = spec.load(cell, tiny_root)
    device = torch.device("cpu")
    for seed in (1, 2, 3):
        ref = run.reference_readings(c, seed, device)
        ctl = run.reference_readings(c, seed, device, "fp8")
        verdict = correct.judge(correct.numbers(ctl, ref), c.traffic["limits"], 0)
        assert verdict["correct"] is False, verdict["checks"]


def _dp_worker(root, cell, rank, world, port, fault, out):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      AUTOPROG_TORCH_DEVICE="cpu")
    torch.set_num_threads(1)
    import contextlib
    with faults.planted(fault) if fault else contextlib.nullcontext():
        res = run.run_rank(spec.load(cell, root), SEED, 0.3, False, rank, world,
                           device=torch.device("cpu"))
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)


def _dp_run(tmp_path, fault):
    root = make_root(tmp_path, {"volo-dp2": tiny_cell("volo-dp2", "volo_tiny", 2, chips=2)})
    out = str(tmp_path / "res.json")
    ctx = mp.get_context("spawn")
    port = run._free_port()
    procs = [ctx.Process(target=_dp_worker, args=(root, "volo-dp2", r, 2, port, fault, out))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
        assert not p.is_alive() and p.exitcode == 0
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("fault", [None, "no_allreduce", "half_batch"])
def test_data_parallel_run_over_two_ranks(tmp_path, fault):
    """Two gloo ranks on the CPU: the reference runs the global batch; a
    step without the gradient all-reduce, or on half the rows, is caught."""
    res = _dp_run(tmp_path, fault)
    assert res["device"]["count"] == 2
    assert res["correct"] is (fault is None), res["checks"]


def test_each_rank_takes_its_own_share_of_the_cores():
    code = ("import os, sys\n"
            "from benchmark import run\n"
            "run.pin_rank(int(sys.argv[1]), 2)\n"
            "print(sorted(os.sched_getaffinity(0)), 'torch' in sys.modules)\n")
    cores = sorted(os.sched_getaffinity(0))
    half = len(cores) // 2
    for rank in (0, 1):
        r = subprocess.run([sys.executable, "-c", code, str(rank)], cwd=REPO,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
        want = cores[rank * half:(rank + 1) * half] if half else cores
        assert r.stdout.split("]")[0] + "]" == str(want)
        assert r.stdout.strip().endswith("False")        # before PyTorch is loaded


@pytest.mark.parametrize("given", [None, "2x"])
def test_launch_queues_are_deepened_unless_the_caller_set_them(monkeypatch, given):
    monkeypatch.setenv("CUDA_SCALE_LAUNCH_QUEUES", given or "")   # restored afterwards
    if given is None:
        monkeypatch.delenv("CUDA_SCALE_LAUNCH_QUEUES")
    run.queue_env()
    assert os.environ["CUDA_SCALE_LAUNCH_QUEUES"] == (given or "4x")


def test_forbidden_modules_are_compared_by_whole_top_level_names(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jaxfoo", sys)
    monkeypatch.setitem(sys.modules, "autoprog_tpu_torch_extra", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "autoprog_tpu.config", sys)
    assert run.forbidden_modules() == ["autoprog_tpu"]
    assert run.emit({"forbidden": [], "checks": {}}) == 1
    cap = capsys.readouterr()
    assert cap.out == "" and "autoprog_tpu" in cap.err


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    code = (
        "import os, sys, torch; os.environ['AUTOPROG_TORCH_DEVICE'] = 'cpu'\n"
        "sys.path.insert(0, 'benchmark/tests')\n"
        "from pathlib import Path\n"
        "from conftest import make_root, tiny_cell\n"
        "from benchmark import run, spec\n"
        f"root = make_root(Path({str(tmp_path)!r}), {{'v': tiny_cell('v', 'volo_tiny', 2)}})\n"
        "run.run_rank(spec.load('v', root), 1, 0.2, True, device=torch.device('cpu'))\n"
        "print(run.forbidden_modules())\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_run_fails_and_prints_no_result():
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "volo_d1-b256",
                        "--seed", str(SEED), "--seconds", "1", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env={k: v for k, v in os.environ.items()
                            if k != "AUTOPROG_TORCH_DEVICE"})
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert r.returncode != 0 and r.stdout == ""


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "deit_small-b512",
                        "--seed", str(SEED), "--seconds", "3", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["correct"] is True
