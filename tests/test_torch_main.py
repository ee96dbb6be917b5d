"""The port's trainer end to end on the CPU, its import hygiene and its
device policy.

`python -m autoprog_tpu_torch.main` runs in a subprocess with
AUTOPROG_TORCH_DEVICE=cpu (the counterpart of JAX_PLATFORMS=cpu); the GPU
drive is chip_smoke.py.
"""

import csv
import glob
import math
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "AUTOPROG_TORCH_DEVICE"}
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    return {**env, **extra}


def test_main_cli_trains_evaluates_and_saves_on_cpu(tmp_path):
    cmd = [sys.executable, "-m", "autoprog_tpu_torch.main", "synthetic://",
           "--model", "volo_h2_l4", "--img-size", "32", "-b", "16", "--epochs", "1",
           "--warmup-epochs", "0", "--cooldown-epochs", "0", "--lr", "1e-3",
           "--num-classes", "8", "--workers", "0", "--fake-data-size", "64",
           "--token-label", "--token-label-data", "synthetic", "--model-ema",
           "--model-ema-decay", "0.9", "0.99", "--drop-path", "0.1",
           "--output", str(tmp_path)]
    res = subprocess.run(cmd, cwd=REPO, env=_env(AUTOPROG_TORCH_DEVICE="cpu"),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "device: cpu" in res.stderr
    assert "Test_EMA_0.99: loss" in res.stderr
    run = glob.glob(str(tmp_path / "train" / "*"))[0]
    for name in ("last.ckpt", "model_best.ckpt", "checkpoint-0.ckpt", "args.yaml"):
        assert os.path.exists(os.path.join(run, name)), name
    with open(os.path.join(run, "summary.csv")) as f:
        row = next(csv.DictReader(f))
    assert math.isfinite(float(row["train_loss"]))
    assert 0.0 <= float(row["eval_top1_EMA_0.9"]) <= 100.0
    ckpt = torch.load(os.path.join(run, "last.ckpt"), weights_only=False)
    assert ckpt["arch"] == "volo_h2_l4" and ckpt["step"] == 4
    assert set(ckpt["state_dict_ema_1"]) == set(ckpt["state_dict"])
    assert "patch_embed.stem0.bn.running_var" in ckpt["batch_stats"]


def test_import_leaves_jax_out():
    """Importing every module of the port (and building a model) loads
    neither jax, flax, optax nor any module of the JAX package."""
    code = ("import importlib, pkgutil, sys\n"
            "import autoprog_tpu_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(autoprog_tpu_torch.__path__,\n"
            "                                               'autoprog_tpu_torch.')]\n"
            "assert len(names) > 30 and 'autoprog_tpu_torch.main_prog' in names, names\n"
            "for new in ('bench', 'models.vit', 'scripts.attn_variants',\n"
            "            'scripts.bench_attn', 'scripts.bench_attn_x', 'scripts.timing'):\n"
            "    assert 'autoprog_tpu_torch.' + new in names, new\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "from autoprog_tpu_torch import create_model\n"
            "create_model('volo_d1').make(num_classes=10)\n"
            "create_model('deit_small_distilled_patch16_224').make(num_classes=10)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'flax', 'optax', 'autoprog_tpu')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]


def test_no_source_file_imports_jax_or_the_jax_package():
    import re
    pat = re.compile(r"^\s*(from|import) +(autoprog_tpu\b[^_]|jax|flax|optax|scripts\b)", re.M)
    files = glob.glob(os.path.join(REPO, "autoprog_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 30
    bad = [f for f in files if pat.search(open(f).read())]
    assert not bad, bad


def test_default_device_raises_without_cuda(monkeypatch):
    from autoprog_tpu_torch.platform import default_device
    monkeypatch.delenv("AUTOPROG_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        default_device()
    monkeypatch.setenv("AUTOPROG_TORCH_DEVICE", "cpu")
    assert default_device() == torch.device("cpu")


@pytest.mark.parametrize("flags", [
    ["--resume", "x.ckpt"], ["--finetune", "x.ckpt"], ["--initial-checkpoint", "x"],
    ["--model-parallel", "2"], ["--remat"], ["--model-ema-bf16"], ["--adam-mu-bf16"],
    ["--uint8-pipe"], ["--aug-splits", "3"], ["--profile", "trace"],
    ["--dataset", "tfrecord"],
])
def test_main_refuses_flags_that_are_not_ported(flags):
    from autoprog_tpu_torch.main import main
    with pytest.raises(NotImplementedError, match="not ported"):
        main(["synthetic://", "--model", "volo_h2_l4"] + flags)
