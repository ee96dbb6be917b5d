"""The datasets the port's trainers now accept, against the JAX package's
loader on the same inputs: `procgen://`, `--dataset tfrecord` and `--dataset
hfds/...` batches are equal array for array (the port's data pipeline is a
copy), train and eval; the port's trainer takes an epoch on procgen and its
validator evaluates it. The TFRecord shards are written here with a minimal
tf.Example encoder and read back with CRC checks on; the HuggingFace dataset
is written to disk with `datasets` (`save_to_disk`), as
tests/test_iterable_data.py writes its own.
"""

import glob
import math
import os

import numpy as np
import pytest
import torch

from autoprog_tpu.data.dataset import create_dataset as jax_create_dataset
from autoprog_tpu.data.loader import create_loader as jax_create_loader
from autoprog_tpu_torch import main as port_main
from autoprog_tpu_torch import validate
from autoprog_tpu_torch.data.dataset import create_dataset
from autoprog_tpu_torch.data.loader import create_loader
from autoprog_tpu_torch.data.tfrecord import read_records
from tfrecord_writer import write_tfrecords

NC, IMG = 8, 32
TRAIN = ["--model", "deit_h2_l2", "--num-classes", str(NC), "--img-size", str(IMG), "-b", "8",
         "--epochs", "1", "--warmup-epochs", "0", "--cooldown-epochs", "0", "--workers", "0",
         "--fake-data-size", "16", "--no-bf16"]


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
def tfrecord_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tfrecord"))
    for split in ("train", "validation"):
        write_tfrecords(root, split, num_classes=NC)
    return root


def write_hfds(root: str, n: int = 16, num_classes: int = NC, seed: int = 0) -> str:
    """A HuggingFace DatasetDict (train, validation) of `n` random RGB images
    of odd sizes each, labels i % num_classes, saved to disk at `root`."""
    hfd = pytest.importorskip("datasets")
    from PIL import Image
    rs = np.random.default_rng(seed)
    splits = {}
    for split in ("train", "validation"):
        rows = {"image": [Image.fromarray(rs.integers(0, 256, (36 + i % 5, 44, 3), np.uint8))
                          for i in range(n)],
                "label": [i % num_classes for i in range(n)]}
        d = hfd.Dataset.from_dict(rows)
        splits[split] = d.cast_column("label", hfd.ClassLabel(num_classes=num_classes))
    hfd.DatasetDict(splits).save_to_disk(root)
    return root


@pytest.fixture(scope="module")
def hfds_root(tmp_path_factory):
    return write_hfds(str(tmp_path_factory.mktemp("hfds") / "local"))


def _batches(make_ds, make_loader, root, name, training):
    ds = make_ds(name, root, split="train" if training else "validation",
                 is_training=training, num_classes=NC, fake_size=16, image_size=IMG, seed=3)
    loader = make_loader(ds, input_size=IMG, batch_size=8, is_training=training,
                         num_workers=0, seed=3, auto_augment="rand-m9-mstd0.5-inc1"
                         if training else "", re_prob=0.25 if training else 0.0)
    try:
        return list(loader)
    finally:
        loader.close()


@pytest.mark.parametrize("source", ["procgen", "tfrecord", "hfds"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_batches_equal_the_jax_loaders(source, training, tfrecord_root, request):
    root, name = {"procgen": lambda: ("procgen://", ""),
                  "tfrecord": lambda: (tfrecord_root, "tfrecord"),
                  "hfds": lambda: (request.getfixturevalue("hfds_root"), "hfds/local")}[source]()
    want = _batches(jax_create_dataset, jax_create_loader, root, name, training)
    got = _batches(create_dataset, create_loader, root, name, training)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)


def test_written_records_pass_the_crc_check(tfrecord_root):
    files = sorted(glob.glob(os.path.join(tfrecord_root, "train-*")))
    assert sum(1 for f in files for _ in read_records(f, verify_crc=True)) == 16


def test_port_trainer_and_validator_on_procgen(tmp_path, monkeypatch):
    """(The trainer on --dataset tfrecord: tests/test_torch_main.py.)"""
    monkeypatch.setenv("AUTOPROG_TORCH_DEVICE", "cpu")
    best = port_main.main(["procgen://"] + TRAIN + ["--output", str(tmp_path)])
    assert best is not None and 0.0 <= best <= 100.0
    run = glob.glob(str(tmp_path / "train" / "*"))[0]
    log = open(os.path.join(run, "log.txt")).read()
    losses = [float(ln.split("Loss: ")[1].split()[0]) for ln in log.splitlines()
              if "Train: 0 [" in ln]
    assert losses and all(math.isfinite(v) for v in losses)
    res = validate.main(["procgen://", "--checkpoint", os.path.join(run, "last.ckpt"),
                         "--num-classes", str(NC), "--img-size", str(IMG), "-b", "8",
                         "--workers", "0", "--fake-data-size", "64", "--no-bf16"])[0]
    assert res["count"] == 64 and res["top1"] == best
