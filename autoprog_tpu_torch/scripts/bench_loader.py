"""Host input-pipeline throughput: native C++ decode against PIL,
counterpart of the JAX package's `scripts/bench_loader.py`.

    python -m autoprog_tpu_torch.scripts.bench_loader [--workers N] [--images N]
        [--repeats N] [--batch-size N] [--root DIR] [--tfrecord | --tfrecord-e2e]

It drives the port's own copy of the data pipeline (`data/`: the Loader's
spawned worker pool and prefetch thread, the full train augmentation at
224 px) and reports img/s, to set beside the train step's rate
(`python -m autoprog_tpu_torch.bench`): a loader slower than the step caps a
real run whatever the step gains. Three modes:

  (default)       a generated JPEG ImageFolder (500 x 400 noise images),
                  with and without RandAugment, the fused C++ decode + crop +
                  resize (`native/fastimage.cpp`) on and off; the four
                  configurations in interleaved repeats, best of;
  --tfrecord      the record-supply rate of TFRecord shards (raw JPEG bytes
                  and labels, decode excluded), records/s;
  --tfrecord-e2e  records -> decode -> RandAugment -> uint8 batches through
                  the Loader (the `--uint8-pipe` production path), native
                  and PIL (AUTOPROG_NO_NATIVE=1, the library's kill switch,
                  which the spawned workers inherit), best of the repeats.

The records are written here, without tensorflow: a minimal tf.Example
encoder framed with the masked CRC32-C of `data/tfrecord.py`, one process a
shard. The native legs build the library first where the host has no
libjpeg development files (`_build.build_native_image`), and assert that it
loaded (`data/native.py` otherwise falls back to PIL without a word, and two
PIL runs would be reported). The data goes to `--root` (default: a
temporary directory, removed at the end). The script touches no CUDA;
beside its rows it reports the host's cores and the card's name and power
limit from nvidia-smi ("cpu" under AUTOPROG_TORCH_DEVICE=cpu). The rows go
to stderr; the last line of stdout is one JSON object.
"""

from __future__ import annotations

import argparse
import io
import json
import multiprocessing as mp
import os
import shutil
import struct
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np

RANDAUG = "rand-m9-mstd0.5-inc1"
SIZE = (500, 400)


def make_jpeg_folder(root: str, n: int, classes: int = 8, size=SIZE) -> None:
    """`n` noise JPEGs (quality 90) under root/train/<class>/."""
    from PIL import Image
    if os.path.exists(os.path.join(root, "DONE")):
        return
    rs = np.random.RandomState(0)
    for i in range(n):
        d = os.path.join(root, "train", str(i % classes))
        os.makedirs(d, exist_ok=True)
        arr = rs.randint(0, 255, (size[1], size[0], 3), np.uint8)
        Image.fromarray(arr).save(os.path.join(d, f"{i}.jpg"), quality=90)
    open(os.path.join(root, "DONE"), "w").close()


def _require_native(use_native: bool) -> None:
    """A native leg runs only with the library loaded (`data/native.py`
    would otherwise decode with PIL without a word)."""
    if use_native:
        from autoprog_tpu_torch.data import native
        if native.load_library() is None:
            raise RuntimeError("the native image library (native/libfastimage.so) did not "
                               "load: a native leg would measure PIL")


def _rate(loader, closing: List[threading.Thread]) -> float:
    """img/s over one epoch after its first batch (the pool's spin-up).

    The pool's teardown (`Loader.close`: the workers killed, their queue
    locks freed, then a bounded join of up to 10 s on the pool's own
    terminate) runs on a thread that is
    appended to `closing`, so that it does not hold up the next
    configuration; the caller joins those threads before it exits. Until a
    teardown has begun its terminate, the pool's exit handler is still
    registered, and run at interpreter exit it can hang on the locks of the
    killed workers."""
    loader.set_epoch(0)
    it = iter(loader)
    next(it)
    n, t0 = 0, time.perf_counter()
    for batch in it:
        n += batch["label"].shape[0]
    dt = time.perf_counter() - t0
    closing.append(threading.Thread(target=loader.close, daemon=True))
    closing[-1].start()
    if not n:
        raise ValueError("one batch or less: give more --images than --batch-size")
    return n / dt


def drive(root: str, closing: List[threading.Thread], *, workers: int, use_native: bool,
          batch_size: int = 128, img: int = 224, auto_augment: str = RANDAUG) -> float:
    """The train Loader over the ImageFolder, native decode on or off
    (`closing`: see `_rate`)."""
    from autoprog_tpu_torch.data.dataset import ImageFolderDataset
    from autoprog_tpu_torch.data.loader import create_loader
    _require_native(use_native)
    ds = ImageFolderDataset(os.path.join(root, "train"))
    ds.use_native = use_native
    return _rate(create_loader(
        ds, input_size=img, batch_size=batch_size, is_training=True, scale=(0.08, 1.0),
        hflip=0.5, auto_augment=auto_augment, re_prob=0.25, num_workers=workers), closing)


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def example(jpeg: bytes, label: int) -> bytes:
    """tf.Example{image/encoded: bytes_list, image/class/label: int64_list}."""
    encoded = _field(1, b"image/encoded") + _field(2, _field(1, _field(1, jpeg)))
    cls = _field(1, b"image/class/label") + _field(2, _field(3, _field(1, _varint(label))))
    return _field(1, _field(1, encoded) + _field(1, cls))


def write_shard(path: str, count: int, seed: int, size=SIZE) -> None:
    """One TFRecord file of `count` records. The images are low-frequency
    noise upsampled: they compress to ~100-120 KB, like ImageNet photos
    (pure noise lands at ~235 KB)."""
    from PIL import Image
    from autoprog_tpu_torch.data.tfrecord import _masked_crc
    rs = np.random.RandomState(seed)
    with open(path, "wb") as f:
        for _ in range(count):
            small = rs.randint(0, 255, (size[1] // 8, size[0] // 8, 3), np.uint8)
            arr = np.asarray(Image.fromarray(small).resize(size, Image.BILINEAR))
            arr = np.clip(arr.astype(np.int16) + rs.randint(-8, 8, arr.shape), 0,
                          255).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, "JPEG", quality=90)
            rec = example(buf.getvalue(), int(rs.randint(0, 8)))
            hdr = struct.pack("<Q", len(rec))
            f.write(hdr + struct.pack("<I", _masked_crc(hdr)) + rec +
                    struct.pack("<I", _masked_crc(rec)))


def make_tfrecords(root: str, n: int, shards: int = 4) -> str:
    """`n` records in `shards` files under root/tfrecord, one process a shard."""
    out = os.path.join(root, "tfrecord")
    if os.path.exists(os.path.join(out, "DONE")):
        return out
    os.makedirs(out, exist_ok=True)
    jobs = [(os.path.join(out, f"train-{s:05d}-of-{shards:05d}"), n // shards, s)
            for s in range(shards)]
    with mp.get_context("spawn").Pool(shards) as pool:
        pool.starmap(write_shard, jobs)
    open(os.path.join(out, "DONE"), "w").close()
    return out


def drive_tfrecord(root: str, epochs: int = 3) -> float:
    """Record-supply rate (raw JPEG bytes and label, decode excluded)."""
    from autoprog_tpu_torch.data.dataset import TFRecordImageDataset
    ds = TFRecordImageDataset(root, split="train", is_training=True)
    for _ in ds.iter_samples(0, 0, 1):      # warm the page cache
        pass
    n, t0 = 0, time.perf_counter()
    for e in range(epochs):
        for _ in ds.iter_samples(e, 0, 1):
            n += 1
    return n / (time.perf_counter() - t0)


def drive_tfrecord_e2e(root: str, closing: List[threading.Thread], *, workers: int,
                       use_native: bool, batch_size: int = 128, img: int = 224,
                       auto_augment: str = RANDAUG) -> float:
    """Records -> decode -> full train augmentation -> uint8 batches through
    the Loader (the parent streams raw JPEG records, the workers decode and
    augment). A RawJpeg stream takes the native path whenever the library
    loads, so PIL is selected by the library's kill switch, which the
    spawned workers inherit with the environment."""
    from autoprog_tpu_torch.data.dataset import TFRecordImageDataset
    from autoprog_tpu_torch.data.loader import create_loader
    old = os.environ.get("AUTOPROG_NO_NATIVE")
    os.environ["AUTOPROG_NO_NATIVE"] = "" if use_native else "1"
    try:
        _require_native(use_native)
        ds = TFRecordImageDataset(root, split="train", is_training=True)
        loader = create_loader(
            ds, input_size=img, batch_size=batch_size, is_training=True, scale=(0.08, 1.0),
            hflip=0.5, auto_augment=auto_augment, re_prob=0.25, num_workers=workers)
        loader.transform.emit_uint8 = True
        return _rate(loader, closing)
    finally:
        if old is None:
            os.environ.pop("AUTOPROG_NO_NATIVE")
        else:
            os.environ["AUTOPROG_NO_NATIVE"] = old


def main(argv: Optional[List[str]] = None) -> Dict:
    from autoprog_tpu_torch.platform import ENV
    from autoprog_tpu_torch.scripts.timing import smi_card

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--images", type=int, default=2048)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--root", default=None, help="data directory (default: a temporary one)")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--tfrecord", action="store_true",
                      help="the TFRecord record-supply rate instead of the loader")
    mode.add_argument("--tfrecord-e2e", action="store_true",
                      help="records -> decode -> RandAugment -> uint8 batches")
    args = p.parse_args(argv)
    card = "cpu" if os.environ.get(ENV) == "cpu" else smi_card()
    if not args.tfrecord:
        # before the pipeline's first look for the library, which it caches
        from autoprog_tpu_torch._build import build_native_image
        build_native_image()
    root = args.root or tempfile.mkdtemp(prefix="bench_loader_")
    rows, closing = [], []
    try:
        if args.tfrecord:
            rate = drive_tfrecord(make_tfrecords(root, args.images))
            rows.append({"mode": "tfrecord", "records_per_s": rate})
            print(f"tfrecord supply: {rate:8.1f} records/s ({args.images} records)",
                  file=sys.stderr, flush=True)
        elif args.tfrecord_e2e:
            troot = make_tfrecords(root, args.images)
            for nat in (True, False):
                best = max(drive_tfrecord_e2e(troot, closing, workers=args.workers,
                                              use_native=nat, batch_size=args.batch_size)
                           for _ in range(args.repeats))
                name = "native C++" if nat else "PIL"
                rows.append({"mode": "tfrecord-e2e", "decoder": name, "aug": RANDAUG,
                             "img_per_s": best})
                print(f"tfrecord e2e {name:<10s} randaug workers={args.workers}: "
                      f"{best:7.1f} img/s (best of {args.repeats})", file=sys.stderr,
                      flush=True)
        else:
            make_jpeg_folder(root, args.images)
            # interleaved repeats, best of: the page cache, the pool's spin-up
            # and the host's drift otherwise set a single epoch's number
            configs = [(aug, nat) for aug in (RANDAUG, "") for nat in (False, True)]
            best = {c: 0.0 for c in configs}
            for _ in range(args.repeats):
                for aug, nat in configs:
                    best[aug, nat] = max(best[aug, nat], drive(
                        root, closing, workers=args.workers, use_native=nat,
                        auto_augment=aug, batch_size=args.batch_size))
            for (aug, nat), rate in best.items():
                name = "native C++" if nat else "PIL"
                rows.append({"mode": "folder", "decoder": name, "aug": aug or "no-randaug",
                             "img_per_s": rate})
                print(f"{name:<10s} {aug or 'no-randaug':<22s} workers={args.workers}: "
                      f"{rate:7.1f} img/s (best of {args.repeats})", file=sys.stderr,
                      flush=True)
    finally:
        for t in closing:
            t.join()
        if args.root is None:
            shutil.rmtree(root, ignore_errors=True)
    result = {"metric": "host_input_img_per_s", "images": args.images,
              "workers": args.workers, "repeats": args.repeats,
              "batch_size": args.batch_size, "cores": os.cpu_count(), "card": card,
              "rows": rows}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
