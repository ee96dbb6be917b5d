"""TFRecord shards of small random JPEGs for the tests, written with a
minimal tf.Example encoder (no tensorflow): `image/encoded` as a bytes
list, `image/class/label` as an int64 list, framed with masked CRC32-C."""

import io
import os
import struct

import numpy as np
from PIL import Image

from autoprog_tpu_torch.data.tfrecord import _masked_crc


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _example(jpeg: bytes, label: int) -> bytes:
    """tf.Example{image/encoded: bytes_list, image/class/label: int64_list}."""
    encoded = _field(1, b"image/encoded") + _field(2, _field(1, _field(1, jpeg)))
    cls = _field(1, b"image/class/label") + _field(2, _field(3, _field(1, _varint(label))))
    return _field(1, _field(1, encoded) + _field(1, cls))


def write_tfrecords(root, split, n_files=2, per_file=8, num_classes=8):
    rs = np.random.default_rng(0)
    os.makedirs(root, exist_ok=True)
    for i in range(n_files):
        with open(os.path.join(root, f"{split}-{i:05d}-of-{n_files:05d}"), "wb") as f:
            for k in range(per_file):
                buf = io.BytesIO()
                Image.fromarray(rs.integers(0, 255, (40, 48, 3), dtype=np.uint8)).save(
                    buf, "JPEG", quality=90)
                rec = _example(buf.getvalue(), (i * per_file + k) % num_classes)
                hdr = struct.pack("<Q", len(rec))
                f.write(hdr + struct.pack("<I", _masked_crc(hdr)) + rec +
                        struct.pack("<I", _masked_crc(rec)))
    return n_files * per_file
