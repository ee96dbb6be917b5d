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
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Equal bits from two CPU runs at different times need a fixed
    reduction order: one intra-op thread (MKL hands a loaded machine's
    process fewer threads than asked, and so another order)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    neither jax, flax, optax, sklearn nor any module of the JAX package or of
    the top-level scripts/."""
    code = ("import importlib, pkgutil, sys\n"
            "import autoprog_tpu_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(autoprog_tpu_torch.__path__,\n"
            "                                               'autoprog_tpu_torch.')]\n"
            "assert len(names) > 30 and 'autoprog_tpu_torch.main_prog' in names, names\n"
            "for new in ('bench', 'models.vit', 'scripts.attn_variants',\n"
            "            'scripts.bench_attn', 'scripts.bench_attn_x', 'scripts.timing',\n"
            "            'validate', 'finetune', 'train.flax_msgpack', 'parallel.mesh',\n"
            "            'parallel.tp', 'scripts.tp_parity', 'scripts.cost',\n"
            "            'scripts.bench_roofline', 'scripts.bench_loader', 'scripts.bench_eval',\n"
            "            'scripts.bench_remat', 'scripts.bench_family', 'scripts.bench_outlook',\n"
            "            'scripts.ab_bf16_state', 'scripts.ab_sparse_tl', 'scripts.real_data_digits',\n"
            "            'scripts.ab_procgen', 'scripts.analyze_rehearsal', 'scripts.ab_search_sync'):\n"
            "    assert 'autoprog_tpu_torch.' + new in names, new\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "from autoprog_tpu_torch import create_model\n"
            "create_model('volo_d1').make(num_classes=10)\n"
            "create_model('deit_small_distilled_patch16_224').make(num_classes=10)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'autoprog_tpu', 'sklearn',\n"
            "                                'scripts')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]


def test_no_source_file_imports_jax_or_the_jax_package():
    import re
    pat = re.compile(r"^\s*(from|import) +(autoprog_tpu\b[^_]|jax|flax|optax|scripts\b|sklearn)",
                     re.M)
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


TINY = ["--model", "deit_h2_l2", "--num-classes", "8", "--img-size", "32", "-b", "8",
        "--warmup-epochs", "0", "--cooldown-epochs", "0", "--workers", "0",
        "--fake-data-size", "16", "--no-bf16"]


@pytest.mark.parametrize("kind", ["tfds", "hfds"])
def test_main_reads_the_tfds_and_hfds_datasets(kind, tmp_path, monkeypatch):
    """`--dataset tfds/...` reaches the copied data pipeline's gate, an
    ImportError that names tensorflow_datasets (installed on neither
    machine); `--dataset hfds/...` trains an epoch and evaluates on a
    HuggingFace dataset saved to disk."""
    from autoprog_tpu_torch.main import main
    monkeypatch.setenv("AUTOPROG_TORCH_DEVICE", "cpu")
    argv = TINY + ["--epochs", "1", "--output", str(tmp_path / "out")]
    if kind == "tfds":
        try:
            import tensorflow_datasets  # noqa: F401
            pytest.skip("tensorflow_datasets is installed: the gate does not apply")
        except ImportError:
            pass
        with pytest.raises(ImportError, match="tensorflow_datasets"):
            main(["", "--dataset", "tfds/imagenet2012"] + argv)
        return
    from test_torch_datasets import write_hfds
    root = write_hfds(str(tmp_path / "hf"))
    assert main([root, "--dataset", "hfds/local"] + argv) is not None
    run = glob.glob(str(tmp_path / "out" / "train" / "*"))[0]
    with open(os.path.join(run, "summary.csv")) as f:
        row = next(csv.DictReader(f))
    assert math.isfinite(float(row["train_loss"])) and 0 <= float(row["eval_top1"]) <= 100
    log = open(os.path.join(run, "log.txt")).read()
    assert re.findall(r"Train: 0 \[\s*1/2\]", log), log[-2000:]


@pytest.mark.parametrize("data, dataset, workers, env, loads, expect", [
    ("/data/imagenet", "", 8, "", True, "built"),
    ("/data/records", "tfrecord", 2, "", True, "built"),
    ("/data/imagenet", "", 8, "", False, "raises"),
    ("/data/imagenet", "", 0, "", False, "nothing"),
    ("/data/imagenet", "", 8, "1", False, "nothing"),
    ("synthetic://", "", 8, "", False, "nothing"),
    ("/data/hf", "hfds/local", 8, "", False, "nothing"),
])
def test_trainer_start_checks_the_native_decoder(data, dataset, workers, env, loads, expect,
                                                 monkeypatch):
    """With loader workers on JPEG files or records, a trainer's start
    builds the native decoder and fails where it does not load (no quiet
    PIL); `--workers 0`, AUTOPROG_NO_NATIVE=1 and data that brings its own
    images check nothing."""
    import argparse
    from autoprog_tpu_torch import _build, main as port_main
    from autoprog_tpu_torch.data import native
    built = []
    monkeypatch.setattr(_build, "build_native_image",
                        lambda: built.append(1) or _build.NATIVE_DIR / "libfastimage.so")
    monkeypatch.setattr(native, "available", lambda: loads)
    monkeypatch.setenv("AUTOPROG_NO_NATIVE", env)
    args = argparse.Namespace(data_dir=data, dataset=dataset, workers=workers)
    if expect == "raises":
        with pytest.raises(RuntimeError, match="AUTOPROG_NO_NATIVE=1"):
            port_main.check_native_decoder(args)
    else:
        port_main.check_native_decoder(args)
    assert built == ([] if expect == "nothing" else [1])


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A one-epoch DeiT run of the port: its run directory."""
    from autoprog_tpu_torch.main import main
    out = tmp_path_factory.mktemp("tiny")
    os.environ["AUTOPROG_TORCH_DEVICE"] = "cpu"
    try:
        main(["synthetic://"] + TINY + ["--epochs", "1", "--output", str(out)])
    finally:
        del os.environ["AUTOPROG_TORCH_DEVICE"]
    return glob.glob(str(out / "train" / "*"))[0]


@pytest.mark.parametrize("flag", ["--resume", "--finetune", "--initial-checkpoint",
                                  "--dataset tfrecord"])
def test_main_runs_the_flags_it_used_to_refuse(flag, tiny_run, tmp_path, monkeypatch):
    """Each runs: a resume goes on at the next epoch after one eval pass;
    --finetune into 10 classes re-initialises the head; an initial
    checkpoint of the same model evaluates as its source run did;
    --dataset tfrecord trains on TFRecord shards."""
    from autoprog_tpu_torch.main import main
    from autoprog_tpu_torch.train.checkpoint import load_checkpoint_file
    from tfrecord_writer import write_tfrecords
    monkeypatch.setenv("AUTOPROG_TORCH_DEVICE", "cpu")
    ckpt = os.path.join(tiny_run, "last.ckpt")
    data, argv = ["synthetic://"], list(TINY) + ["--epochs", "1"]
    if flag == "--resume":
        argv = TINY + ["--epochs", "2", "--resume", ckpt]
    elif flag == "--finetune":
        argv += ["--finetune", ckpt, "--num-classes", "10"]
    elif flag == "--initial-checkpoint":
        argv += ["--initial-checkpoint", ckpt]
    else:
        data = [str(tmp_path / "records")]
        for split in ("train", "validation"):
            write_tfrecords(data[0], split)
        argv += ["--dataset", "tfrecord"]
    assert main(data + argv + ["--output", str(tmp_path / "out")]) is not None
    run = glob.glob(str(tmp_path / "out" / "train" / "*"))[0]
    log = open(os.path.join(run, "log.txt")).read()
    tests = re.findall(r"Test: loss (\S+)  Acc@1 (\S+)", log)
    last = load_checkpoint_file(os.path.join(run, "last.ckpt"))
    with open(os.path.join(tiny_run, "summary.csv")) as f:
        src = next(csv.DictReader(f))
    if flag == "--resume":
        assert len(tests) == 2 and last["epoch"] == 1 and last["step"] == 4
        assert tests[0] == ("%.4f" % float(src["eval_loss"]), "%.4f" % float(src["eval_top1"]))
    elif flag == "--finetune":
        assert len(tests) == 2 and "dropping head.weight" in log
        assert last["state_dict"]["head.weight"].shape == (10, 128)
    elif flag == "--initial-checkpoint":
        assert len(tests) == 2 and "dropping" not in log
        assert tests[0] == ("%.4f" % float(src["eval_loss"]), "%.4f" % float(src["eval_top1"]))
    else:
        assert len(tests) == 1 and last["step"] == 2
