"""Dataset readers.

Replaces `prog/dataset.py` (`create_dataset` / `StoredImageDataset`) and
tlt's `create_token_label_dataset` (SURVEY §2.2):

  * `ImageFolderDataset` — class-per-directory layout with split
    auto-discovery like `_search_split` (`prog/dataset.py:66-77`);
  * `TokenLabelDataset` — ImageFolder plus per-image dense top-K label
    maps (.npz with 'scores' [K,H,W] f32 + 'indices' [K,H,W] int, or .npy
    stacked [2,K,H,W]);
  * `SyntheticDataset` — deterministic generated images for tests/benches
    (`synthetic://` data_dir);
  * `FixedAugDataset` — the *search* dataset: deterministic per-index
    augmentation seeds so candidate loss probes see identical batches
    across configs and epochs. (The reference's `StoredImageDataset`
    intended to cache transformed samples but never writes its storage,
    `prog/dataset.py:33-54`; deterministic seeds achieve the comparability
    goal without pinning GBs of pixels — SURVEY §7.4.)
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _find_split(root: str, split: str) -> str:
    """Split directory auto-discovery: try the name, then common aliases."""
    cand = [split]
    if split == "validation":
        cand += ["val", "valid", "validation"]
    if split == "train":
        cand += ["training"]
    for c in cand:
        p = os.path.join(root, c)
        if os.path.isdir(p):
            return p
    if os.path.isdir(root):
        return root
    raise FileNotFoundError(f"no split dir for {split!r} under {root}")


class ImageFolderDataset:
    #: decode JPEGs in the native C++ pipeline when the library is present
    use_native: bool = True

    def __init__(self, root: str, split: str = "train"):
        self.root = _find_split(root, split)
        classes = sorted(d for d in os.listdir(self.root)
                         if os.path.isdir(os.path.join(self.root, d)))
        if not classes:
            raise FileNotFoundError(f"no class dirs under {self.root}")
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(self.root, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(IMG_EXTENSIONS):
                    self.samples.append((os.path.join(cdir, fn),
                                         self.class_to_idx[c]))
        self.num_classes = len(classes)

    def __len__(self):
        return len(self.samples)

    def _load_image(self, path: str):
        if self.use_native and path.lower().endswith((".jpg", ".jpeg")):
            from autoprog_tpu_torch.data import native
            from autoprog_tpu_torch.data.raw import RawJpeg
            if native.available():
                with open(path, "rb") as f:
                    return RawJpeg(f.read())
        from PIL import Image
        with Image.open(path) as im:
            return im.convert("RGB")

    def load(self, i: int):
        path, label = self.samples[i]
        return self._load_image(path), label, None


class TokenLabelDataset(ImageFolderDataset):
    """ImageFolder + per-image dense label maps mirrored in `label_root`
    with the same relative paths (tlt layout, `main_prog.py:576-578`)."""

    def __init__(self, root: str, label_root: str, split: str = "train"):
        super().__init__(root, split)
        self.label_root = label_root

    def _label_path(self, img_path: str) -> Optional[str]:
        rel = os.path.relpath(img_path, self.root)
        base = os.path.splitext(os.path.join(self.label_root, rel))[0]
        for ext in (".npz", ".npy"):
            if os.path.isfile(base + ext):
                return base + ext
        return None

    def load(self, i: int):
        path, label = self.samples[i]
        img = self._load_image(path)
        lp = self._label_path(path)
        if lp is None:
            return img, label, None
        if lp.endswith(".npz"):
            z = np.load(lp)
            maps = (z["scores"].astype(np.float32),
                    z["indices"].astype(np.int32))
        else:
            arr = np.load(lp)
            maps = (arr[0].astype(np.float32), arr[1].astype(np.int32))
        return img, label, maps


class SyntheticDataset:
    """Deterministic generated images; index i always yields the same
    sample. Used for tests, benches and `synthetic://` runs."""

    def __init__(self, size: int = 1024, num_classes: int = 1000,
                 image_size: int = 224, token_label_hw: Optional[int] = None,
                 seed: int = 0):
        self.size = size
        self.num_classes = num_classes
        self.image_size = image_size
        self.token_label_hw = token_label_hw
        self.seed = seed

    def __len__(self):
        return self.size

    def load(self, i: int):
        from PIL import Image
        rng = np.random.default_rng(self.seed * 1_000_003 + i)
        label = int(rng.integers(self.num_classes))
        # class-dependent mean so learning is actually possible; noise is
        # drawn at 1/4 resolution (f32) and pixel-replicated — ~10x
        # cheaper per sample than full-res f64 gaussians, which made the
        # synthetic loader the bottleneck of on-chip runs at 224px
        s = max(self.image_size // 4, 1)
        base = rng.standard_normal((s, s, 3), dtype=np.float32) * 0.2 \
            + (0.45 + 0.1 * (label % 7 - 3) / 3.0)
        base = np.repeat(np.repeat(base, 4, 0), 4, 1)[
            :self.image_size, :self.image_size]
        if base.shape[0] < self.image_size:  # image_size not divisible by 4
            pad = self.image_size - base.shape[0]
            base = np.pad(base, ((0, pad), (0, pad), (0, 0)), mode="edge")
        img = Image.fromarray(
            (np.clip(base, 0, 1) * 255).astype(np.uint8))
        maps = None
        if self.token_label_hw:
            hw = self.token_label_hw
            scores = rng.random((5, hw, hw)).astype(np.float32)
            scores /= scores.sum(0, keepdims=True) * 1.25
            inds = rng.integers(0, self.num_classes,
                                (5, hw, hw)).astype(np.int32)
            inds[0] = label
            maps = (scores, inds)
        return img, label, maps


class FixedAugDataset:
    """Wrap a dataset so augmentation randomness is a pure function of the
    sample index (see module docstring)."""

    def __init__(self, dataset, seed: int = 1234):
        self.dataset = dataset
        self.seed = seed
        self.num_classes = getattr(dataset, "num_classes", None)

    def __len__(self):
        return len(self.dataset)

    def load(self, i: int):
        return self.dataset.load(i)

    def aug_rng(self, i: int, epoch: int) -> np.random.Generator:
        del epoch  # fixed across epochs by design
        return np.random.default_rng(self.seed * 7_777_777 + i)


# ------------------------- iterable (stream) datasets ----------------------


class TTADataset:
    """Test-time-augmentation expansion: each source sample appears
    `t` times at adjacent indices, carrying its variant id for
    `TTAEvalTransform` (data/transforms.py). The eval sampler iterates
    in order, so the `--tta N` group-averaging in validate.py sees the
    N views of one image as consecutive rows — the contract the
    reference assumes of its loader (`reference/main.py:961-964`)."""

    def __init__(self, dataset, t: int):
        self.dataset = dataset
        self.t = int(t)

    def __len__(self) -> int:
        return len(self.dataset) * self.t

    @property
    def samples(self):
        return getattr(self.dataset, "samples", [])

    def load(self, i: int):
        img, label, maps = self.dataset.load(i // self.t)
        return (img, i % self.t), label, maps


class IterableImageDataset:
    """Stream-style dataset protocol (the reference's tfds-iterable branch,
    `prog/dataset.py:79-94` via `timm.create_dataset`): no random access;
    `iter_samples(epoch, shard_index, shard_count)` yields
    (image-or-RawJpeg-bytes, int label, maps-or-None) for this host's
    shard. `__len__` returns the GLOBAL sample count (the Loader divides
    by shard count). ImageNet-scale input on TPU hosts usually arrives as
    TFRecord/ArrayRecord shards, not an ImageFolder tree — this is the
    path that serves it."""

    is_iterable = True

    def __len__(self) -> int:
        raise NotImplementedError

    def iter_samples(self, epoch: int, shard_index: int, shard_count: int):
        raise NotImplementedError


class TFRecordImageDataset(IterableImageDataset):
    """ImageNet-style TFRecord shards via the dependency-free direct
    reader (data/tfrecord.py): record framing + a minimal tf.Example
    field scanner, no TF import. Decode/augment stay in the Loader's
    worker pool, which receives the raw JPEG bytes.

    Expects tf.Example features `image/encoded` (JPEG bytes) and
    `image/class/label` (int64); `label_offset` handles the 1-based
    labels of the classic ImageNet TFRecords. Pickles cleanly (holds
    only file names + params)."""

    def __init__(self, root: str, split: str = "train",
                 is_training: bool = False, seed: int = 42,
                 num_samples: int = 0, label_offset: int = 0,
                 shuffle_buffer: int = 1024):
        # shuffle_buffer counts RECORDS (~100-200 KB of encoded JPEG
        # each): 8192 was a ~1-2 GB resident buffer whose fill/memory
        # pressure cut record supply ~6x (measured, scripts/bench_loader
        # --tfrecord); 1024 + file-order shuffling keeps randomness with a
        # ~100-200 MB buffer
        import glob as _glob
        pats = [os.path.join(root, f"{split}*"),
                os.path.join(root, split, "*")]
        files: List[str] = []
        for p in pats:
            files = sorted(f for f in _glob.glob(p) if os.path.isfile(f))
            if files:
                break
        if not files:
            raise FileNotFoundError(
                f"no TFRecord files matching {pats} under {root}")
        self.files = files
        self.split = split
        self.is_training = is_training
        self.seed = seed
        self.label_offset = label_offset
        self.shuffle_buffer = shuffle_buffer
        self._num_samples = num_samples
        self._file_counts: Optional[Dict[str, int]] = None

    def _ensure_counts(self) -> Dict[str, int]:
        """Per-file record counts (framing headers only, payloads seeked
        over; one-time, cached). Feeds both __len__ and the exact
        range-sharding in iter_samples."""
        if self._file_counts is None:
            from autoprog_tpu_torch.data.tfrecord import count_records
            self._file_counts = {f: count_records(f) for f in self.files}
        return self._file_counts

    def __len__(self) -> int:
        if not self._num_samples:
            self._num_samples = sum(self._ensure_counts().values())
        return self._num_samples

    def iter_samples(self, epoch: int, shard_index: int, shard_count: int):
        from autoprog_tpu_torch.data.raw import RawJpeg
        from autoprog_tpu_torch.data.tfrecord import read_records, scan_example

        files = list(self.files)
        rng = np.random.RandomState(self.seed + epoch)
        if self.is_training:
            rng.shuffle(files)
        if shard_count <= 1:
            def records():
                for f in files:
                    yield from read_records(f)
        elif not self._num_samples or self._file_counts is not None:
            # EXACT range sharding by global record index: host h reads
            # records [h*q, (h+1)*q) of the (epoch-shuffled) file
            # concatenation, q = floor(n / shard_count) — per-host counts
            # are exactly equal (lockstep SPMD train/eval deadlock on ANY
            # inequality, incl. unequal records per file, which file-
            # granularity sharding silently trusts the dataset prep to
            # avoid). IO stays minimal: the per-file counts (one seek-only
            # framing scan, cached by _ensure_counts) let each host open
            # only the files overlapping its own range. The n % shard_count
            # tail records are dropped.
            counts = self._ensure_counts()
            n = sum(counts.values())
            quota = n // shard_count
            start, stop = shard_index * quota, (shard_index + 1) * quota

            def records():
                pos = 0
                for f in files:
                    c = counts[f]
                    if pos + c <= start or pos >= stop:
                        pos += c
                        continue
                    for k, rec in enumerate(read_records(f)):
                        gi = pos + k
                        if gi >= stop:
                            break
                        if gi >= start:
                            yield rec
                    pos += c
        else:
            # counts unavailable (the user supplied num_samples to skip
            # the scan): shard at RECORD granularity in COMPLETE ROUNDS of
            # shard_count — every host gets exactly floor(n/shard_count)
            # records (the incomplete final round is dropped), at the cost
            # of a full read per host. Plain round-robin would leave
            # hosts' counts unequal by one, which still deadlocks lockstep
            # SPMD eval whenever the smaller shard is a batch-size
            # multiple.
            def records():
                round_buf = []
                for f in files:
                    for rec in read_records(f):
                        round_buf.append(rec)
                        if len(round_buf) == shard_count:
                            yield round_buf[shard_index]
                            round_buf.clear()

        def emit(rec):
            enc, lab = scan_example(rec)
            if enc is None:
                raise ValueError("record without image/encoded feature")
            lab = 0 if lab is None else int(lab)
            return RawJpeg(enc), lab + self.label_offset, None

        if not (self.is_training and self.shuffle_buffer):
            for rec in records():
                yield emit(rec)
            return
        # streaming shuffle: keep `shuffle_buffer` raw records resident
        # and emit a uniformly-chosen one per arrival (same contract as
        # tf.data's shuffle(buffer) at a fraction of the cost — buffers
        # are raw payload bytes, never feature tensors)
        buf: List[bytes] = []
        for rec in records():
            if len(buf) < self.shuffle_buffer:
                buf.append(rec)
                continue
            j = int(rng.randint(len(buf)))
            out, buf[j] = buf[j], rec
            yield emit(out)
        rng.shuffle(buf)
        for rec in buf:
            yield emit(rec)


class TFDSImageDataset(IterableImageDataset):
    """`tfds/<name>` datasets through tensorflow_datasets (the reference's
    dataset-name grammar routes tfds names the same way). Gated: raises a
    clear error when the tfds package is absent."""

    def __init__(self, name: str, root: str, split: str = "train",
                 is_training: bool = False, seed: int = 42):
        try:
            import tensorflow_datasets as tfds  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "--dataset tfds/... requires the tensorflow_datasets "
                "package (not installed in this environment)") from e
        self.name = name
        self.data_dir = root or None
        self.split = {"validation": "validation", "train": "train"}.get(
            split, split)
        self.is_training = is_training
        self.seed = seed
        self._builder = tfds.builder(name, data_dir=self.data_dir)
        self._num = self._builder.info.splits[self.split].num_examples

    def __len__(self) -> int:
        return self._num

    def iter_samples(self, epoch: int, shard_index: int, shard_count: int):
        import tensorflow_datasets as tfds
        from PIL import Image
        split = tfds.even_splits(self.split, shard_count)[shard_index]
        ds = self._builder.as_dataset(
            split=split, shuffle_files=self.is_training,
            read_config=tfds.ReadConfig(shuffle_seed=self.seed + epoch))
        if self.is_training:
            ds = ds.shuffle(8192, seed=self.seed + epoch)
        for ex in ds.as_numpy_iterator():
            img = ex["image"]
            yield Image.fromarray(img), int(ex["label"]), None


class HFDatasetWrapper:
    """`hfds/<path-or-name>` — a HuggingFace `datasets` dataset saved to
    disk (or hub-cached). Map-style: HF datasets are randomly accessible,
    so the full Loader path (sharding, fixed-aug search seeds) applies."""

    def __init__(self, spec: str, root: str, split: str = "train"):
        import datasets as hfd
        path = next((p for p in (root, spec) if p and os.path.isdir(p)),
                    None)
        if path is not None:
            d = hfd.load_from_disk(path)
        else:
            d = hfd.load_dataset(spec, split=split)
        if isinstance(d, hfd.DatasetDict):
            aliases = {"validation": ("validation", "valid", "val", "test"),
                       "train": ("train", "training")}.get(split, (split,))
            key = next((a for a in aliases if a in d), None)
            if key is None:
                raise KeyError(f"split {split!r} not in {list(d)}")
            d = d[key]
        self.ds = d
        cols = self.ds.column_names
        self.image_key = "image" if "image" in cols else "img"
        self.label_key = "label" if "label" in cols else "fine_label"
        feat = self.ds.features[self.label_key]
        self.num_classes = getattr(feat, "num_classes", None)

    def __len__(self):
        return len(self.ds)

    def load(self, i: int):
        row = self.ds[int(i)]
        img = row[self.image_key]
        if not hasattr(img, "convert"):  # raw array -> PIL
            from PIL import Image
            img = Image.fromarray(np.asarray(img))
        return img, int(row[self.label_key]), None


def create_dataset(name: str, root: str, split: str = "train",
                   is_training: bool = False, fixed_aug: bool = False,
                   token_label_root: str = "", num_classes: int = 1000,
                   fake_size: int = 1024, image_size: int = 224,
                   seed: int = 42, dataset_size: int = 0,
                   **_):
    """Dataset factory (`prog/dataset.py:79-94` + tlt dataset). The
    `name` grammar mirrors the reference's timm-style prefixes:
    '' / 'folder' -> ImageFolder, 'tfds/<n>' -> tensorflow_datasets,
    'tfrecord' -> raw TFRecord shards, 'hfds/<n>' -> HuggingFace datasets,
    'synthetic' -> generated."""
    if name == "synthetic" or root.startswith("synthetic://"):
        ds = SyntheticDataset(
            size=fake_size, num_classes=num_classes, image_size=image_size,
            token_label_hw=14 if token_label_root else None)
    elif name == "procgen" or root.startswith("procgen://"):
        from autoprog_tpu_torch.data.procgen import ProcGenDataset
        ds = ProcGenDataset(
            size=fake_size, num_classes=num_classes, image_size=image_size,
            split=split, token_label_hw=14 if token_label_root else None)
    elif name.startswith("tfds/"):
        ds = TFDSImageDataset(name[len("tfds/"):], root, split=split,
                              is_training=is_training, seed=seed)
    elif name == "tfrecord" or name.startswith("tfrecord"):
        ds = TFRecordImageDataset(root, split=split,
                                  is_training=is_training, seed=seed,
                                  num_samples=dataset_size)
    elif name.startswith("hfds/"):
        ds = HFDatasetWrapper(name[len("hfds/"):], root, split=split)
    elif token_label_root and is_training:
        ds = TokenLabelDataset(root, token_label_root, split)
    else:
        ds = ImageFolderDataset(root, split)
    if fixed_aug and not getattr(ds, "is_iterable", False):
        ds = FixedAugDataset(ds)
    return ds


def get_mean_and_std(dataset, max_samples: int = 256):
    """Per-channel mean/std of a dataset (reference `utils/utils.py:145`)."""
    import numpy as np
    acc = np.zeros(3)
    acc2 = np.zeros(3)
    n = 0
    for i in range(min(len(dataset), max_samples)):
        img = dataset.load(i)[0]
        if not hasattr(img, "mode"):  # RawJpeg bytes -> decode
            from io import BytesIO
            from PIL import Image
            img = Image.open(BytesIO(img)).convert("RGB")
        x = np.asarray(img, np.float64) / 255.0
        acc += x.mean(axis=(0, 1))
        acc2 += (x ** 2).mean(axis=(0, 1))
        n += 1
    mean = acc / n
    std = np.sqrt(np.maximum(acc2 / n - mean ** 2, 0))
    return mean, std
