"""Dependency-free TFRecord reading: file framing + a minimal tf.Example
field scanner.

The record-supply path for ImageNet-scale input (the role of
`reference/prog/dataset.py:79-94`'s tfds branch). tf.data's
`parse_example` materializes every feature into fresh string tensors and
tops out ~3.1k records/s on this host single-threaded — below the bar
for feeding a chip consuming >1k img/s with headroom. A TFRecord file is
a trivial framing format (u64 length, u32 masked-crc, payload, u32
masked-crc) and we need exactly two fields out of the tf.Example proto,
so this module walks the proto wire format directly and slices the
JPEG bytes out of the record buffer — no TF import, no per-feature
tensor materialization (~3x faster than the tf.data pipeline, measured
in scripts/bench_loader.py --tfrecord).

CRC verification is skipped by default (TFRecord CRCs guard against
torn writes; storage below is already checksummed) — `verify_crc=True`
enables it for integrity sweeps.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Optional, Tuple

_CRC_TABLE: Optional[List[int]] = None


def _crc32c(data: bytes) -> int:
    """Software CRC32-C (Castagnoli), for verify_crc=True only."""
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        tbl = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            tbl.append(c)
        _CRC_TABLE = tbl
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def read_records(path: str, *, verify_crc: bool = False,
                 buffer_size: int = 1 << 22) -> Iterator[bytes]:
    """Yield raw record payloads (serialized tf.Example) from one file."""
    with open(path, "rb", buffering=buffer_size) as f:
        while True:
            hdr = f.read(12)
            if len(hdr) < 12:
                return
            (length,) = struct.unpack("<Q", hdr[:8])
            payload = f.read(length)
            if len(payload) < length:
                raise EOFError(f"truncated record in {path}")
            crc = f.read(4)
            if verify_crc:
                (want_len,) = struct.unpack("<I", hdr[8:12])
                if _masked_crc(hdr[:8]) != want_len:
                    raise IOError(f"length CRC mismatch in {path}")
                if _masked_crc(payload) != struct.unpack("<I", crc)[0]:
                    raise IOError(f"data CRC mismatch in {path}")
            yield payload


def count_records(path: str) -> int:
    """Record count of one file by framing headers only: 12 bytes read
    per record, payloads seeked over — ~10^3x less IO than a full read."""
    n = 0
    with open(path, "rb") as f:
        while True:
            hdr = f.read(12)
            if len(hdr) < 12:
                return n
            (length,) = struct.unpack("<Q", hdr[:8])
            f.seek(length + 4, 1)
            n += 1


def scan_example(buf: bytes, *, encoded_key: bytes = b"image/encoded",
                 label_key: bytes = b"image/class/label"
                 ) -> Tuple[Optional[bytes], Optional[int]]:
    """Extract (jpeg_bytes, int_label) from a serialized tf.Example.

    Minimal proto wire-format walk: Example.features(1) ->
    Features.feature map entries(1) -> {key(1), Feature(2)} ->
    bytes_list(1)/int64_list(3) -> value(1). Handles both packed
    (proto3 default) and unpacked int64 lists. Unknown keys/fields are
    skipped structurally, so extra features (height/width/colorspace/
    text labels in classic ImageNet TFRecords) cost only the skip."""
    mv = memoryview(buf)

    def varint(i: int) -> Tuple[int, int]:
        r = 0
        s = 0
        while True:
            b = mv[i]
            i += 1
            r |= (b & 0x7F) << s
            if not b & 0x80:
                return r, i
            s += 7

    def walk(lo: int, hi: int):
        """Yield (field_no, a, b): wt2 -> payload span [a, b);
        wt0 -> (value, None); wt1/wt5 -> skipped, (offset, None)."""
        i = lo
        while i < hi:
            tag, i = varint(i)
            fn, wt = tag >> 3, tag & 7
            if wt == 2:
                ln, i = varint(i)
                yield fn, i, i + ln
                i += ln
            elif wt == 0:
                v, i = varint(i)
                yield fn, v, None
            elif wt == 5:
                yield fn, i, None
                i += 4
            elif wt == 1:
                yield fn, i, None
                i += 8
            else:
                raise ValueError(f"bad wire type {wt} at offset {i}")

    enc: Optional[bytes] = None
    lab: Optional[int] = None
    for fn, lo, hi in walk(0, len(buf)):
        if fn != 1 or hi is None:
            continue
        for fn2, lo2, hi2 in walk(lo, hi):
            if fn2 != 1 or hi2 is None:
                continue
            key = None
            flo = fhi = None
            for fn3, a, b in walk(lo2, hi2):
                if fn3 == 1 and b is not None:
                    key = mv[a:b]
                elif fn3 == 2 and b is not None:
                    flo, fhi = a, b
            if flo is None or key is None:
                continue
            if key == encoded_key:
                for fn4, a, b in walk(flo, fhi):
                    if fn4 == 1 and b is not None:  # BytesList
                        for fn5, c, d in walk(a, b):
                            if fn5 == 1 and d is not None:
                                enc = bytes(mv[c:d])
            elif key == label_key:
                for fn4, a, b in walk(flo, fhi):
                    if fn4 == 3 and b is not None:  # Int64List
                        for fn5, c, d in walk(a, b):
                            if fn5 == 1:
                                # packed (wt2 block of varints) or plain
                                lab = varint(c)[0] if d is not None else c
            if enc is not None and lab is not None:
                return enc, lab
    return enc, lab
