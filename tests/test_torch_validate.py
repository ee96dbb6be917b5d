"""The port's validator (`python -m autoprog_tpu_torch.validate`) on the CPU.

  * on a checkpoint the JAX package's `main.py` wrote, against the JAX
    package's `validate.py`: top-1 / top-5 (multiples of 100/64 here) and
    the loss within 1e-4 (the JAX validator rounds to 4 places), `count`
    exact; plain, EMA, `--tta 2`, `--real-labels` and `--test-pool`;
  * on the port trainer's own checkpoint, against the trainer's eval row in
    summary.csv: equal, plain and EMA (both go through
    `StepBuilder.eval_step` in the same order);
  * bulk sweeps with a results CSV, and batch halving on an out-of-memory
    error that keeps whole TTA groups.
"""

import csv
import glob
import json
import os

import pytest
import torch

from autoprog_tpu import main as jax_main
from autoprog_tpu import validate as jax_validate
from autoprog_tpu_torch import main as port_main
from autoprog_tpu_torch import validate
from autoprog_tpu_torch.train.steps import StepBuilder

RUN = ["synthetic://", "--model", "volo_h2_l2", "--num-classes", "8", "--img-size", "32",
       "-b", "8", "--epochs", "1", "--warmup-epochs", "0", "--cooldown-epochs", "0", "--lr",
       "1e-3", "--workers", "0", "--fake-data-size", "16", "--no-bf16", "--token-label",
       "--token-label-data", "synthetic", "--model-ema", "--model-ema-decay", "0.9", "0.99"]
# the trainer evaluates max(fake_data_size // 4, 64) samples in batches of
# 8: the same batches
VAL = ["synthetic://", "--num-classes", "8", "--img-size", "32", "-b", "8", "--workers", "0",
       "--fake-data-size", "64", "--no-bf16"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Equal bits from two CPU runs at different times need a fixed
    reduction order: one intra-op thread (MKL hands a loaded machine's
    process fewer threads than asked, and so another order)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same command through the JAX package's trainer and the port's:
    their run directories."""
    out = tmp_path_factory.mktemp("runs")
    jax_main.main(RUN + ["--output", str(out / "jax")])
    os.environ["AUTOPROG_TORCH_DEVICE"] = "cpu"
    try:
        port_main.main(RUN + ["--output", str(out / "port")])
    finally:
        del os.environ["AUTOPROG_TORCH_DEVICE"]
    return {k: glob.glob(str(out / k / "train" / "*"))[0] for k in ("jax", "port")}


@pytest.fixture
def cpu_port(monkeypatch):
    monkeypatch.setenv("AUTOPROG_TORCH_DEVICE", "cpu")


def _real_labels(path):
    sets = [[k % 8, (3 * k) % 8] if k % 5 else [] for k in range(64)]
    with open(path, "w") as f:
        json.dump(sets, f)
    return str(path)


@pytest.mark.parametrize("case", ["plain", "ema", "tta", "real_labels", "test_pool"])
def test_port_validate_on_a_jax_checkpoint_matches_jax_validate(runs, case, tmp_path,
                                                                cpu_port):
    flags = {"plain": [], "ema": ["--use-ema", "--ema-idx", "1"], "tta": ["--tta", "2"],
             "real_labels": ["--real-labels", _real_labels(tmp_path / "real.json")],
             "test_pool": ["--test-pool"]}[case]
    argv = VAL + ["--checkpoint", os.path.join(runs["jax"], "model_best.ckpt")] + flags
    want = jax_validate.main(argv)[0]
    got = validate.main(argv)[0]
    assert got["model"] == want["model"] == "volo_h2_l2"
    assert got["count"] == want["count"] == 64
    for key in ("top1", "top5", "loss") + (("top1_real",) if case == "real_labels" else ()):
        assert got[key] == pytest.approx(want[key], abs=1e-4), key


def _summary_row(run):
    with open(os.path.join(run, "summary.csv")) as f:
        return list(csv.DictReader(f))[-1]


@pytest.mark.parametrize("ema", [None, 0, 1])
def test_port_validate_equals_the_port_trainer(runs, ema, cpu_port):
    row = _summary_row(runs["port"])
    flags = [] if ema is None else ["--use-ema", "--ema-idx", str(ema)]
    suffix = "" if ema is None else f"_EMA_{(0.9, 0.99)[ema]}"
    got = validate.main(VAL + ["--checkpoint", os.path.join(runs["port"], "last.ckpt")]
                        + flags)[0]
    assert got["model"] == "volo_h2_l2" and got["count"] == 64
    for key in ("top1", "top5", "loss"):
        assert got[key] == float(row[f"eval_{key}{suffix}"]), key


def test_bulk_sweep_writes_a_results_file(runs, tmp_path, cpu_port):
    results = str(tmp_path / "results.csv")
    got = validate.main(VAL + ["--checkpoint", runs["port"], "--results-file", results])
    names = sorted(os.path.basename(r["checkpoint"]) for r in got)
    assert names == sorted(os.path.basename(p)
                           for p in glob.glob(os.path.join(runs["port"], "*.ckpt")))
    assert [r["top1"] for r in got] == sorted((r["top1"] for r in got), reverse=True)
    with open(results) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == len(got) and float(rows[0]["top1"]) == got[0]["top1"]
    wild = validate.main(VAL + ["--checkpoint", os.path.join(runs["port"], "last*.ckpt")])
    assert len(wild) == 1 and wild[0]["top1"] == float(_summary_row(runs["port"])["eval_top1"])


def test_out_of_memory_halves_the_batch_keeping_tta_groups(runs, monkeypatch, cpu_port):
    seen = []
    step = StepBuilder.logits_eval_step

    def fake(self, state, batch, **kw):
        seen.append(int(batch["label"].shape[0]))
        if batch["label"].shape[0] > 6:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")
        return step(self, state, batch, **kw)

    argv = VAL + ["--checkpoint", os.path.join(runs["port"], "last.ckpt"), "--tta", "3",
                  "-b", "16"]
    want = validate.main(argv)[0]
    monkeypatch.setattr(StepBuilder, "logits_eval_step", fake)
    got = validate.main(argv)[0]
    # 15 (five groups of 3) -> 6 (two groups); every batch holds whole groups
    assert seen[0] == 15 and set(seen[1:]) == {6}
    assert got["count"] == want["count"] == 64
    assert got["top1"] == want["top1"] and got["top5"] == want["top5"]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)
