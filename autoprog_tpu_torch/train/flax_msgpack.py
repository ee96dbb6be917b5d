"""Decoder of flax's msgpack checkpoints, in Python and numpy alone.

The JAX package writes its checkpoint tensors with
`flax.serialization.msgpack_serialize`; this module reads them back the way
`flax.serialization.msgpack_restore` does, without `msgpack`, `flax` or
`jax`:

  * the msgpack types: nil, bool, ints, float32 / float64, str, bin,
    arrays (as lists) and maps (as dicts, keys in stored order);
  * flax's ext types: 1 = ndarray, 3 = numpy scalar, whose payload is itself
    msgpack `(shape, dtype name, raw bytes)`, and 2 = Python complex,
    `(real, imag)`;
  * `__msgpack_chunked_array__` leaves (arrays over 2**30 bytes, which flax
    splits into flat chunks) are put back together.

numpy has no bfloat16: such leaves come back as float32 holding the same
values (bf16 widens exactly).
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"

_SIMPLE = {0xc0: None, 0xc2: False, 0xc3: True}
_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
          0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
          0xca: ">f", 0xcb: ">d"}
_LENGTH = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I",      # bin
           0xd9: ">B", 0xda: ">H", 0xdb: ">I",      # str
           0xdc: ">H", 0xdd: ">I",                  # array
           0xde: ">H", 0xdf: ">I",                  # map
           0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}      # ext
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class MsgpackError(ValueError):
    pass


def _bf16_as_f32(raw: bytes) -> np.ndarray:
    bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
    return bits.view(np.float32)


def _array(payload: bytes) -> np.ndarray:
    shape, dtype, raw = _Reader(payload, raw_str=True).read_all()
    name = dtype.decode() if isinstance(dtype, bytes) else dtype
    if name == "bfloat16":
        flat = _bf16_as_f32(raw)
    else:
        flat = np.frombuffer(raw, dtype=np.dtype(name))   # read-only, as flax's
    return flat.reshape(tuple(shape))


class _Reader:
    """One pass over a msgpack buffer. `raw_str` returns str as bytes (flax
    unpacks the ndarray payload with `raw=True`)."""

    def __init__(self, data: bytes, raw_str: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw_str = raw_str

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise MsgpackError(f"truncated msgpack data at byte {self.pos}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read_all(self):
        obj = self.read()
        if self.pos != len(self.buf):
            raise MsgpackError(f"{len(self.buf) - self.pos} bytes after the msgpack object")
        return obj

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.read() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self._str(b & 0x1f)
        if b in _SIMPLE:
            return _SIMPLE[b]
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if b in _LENGTH:
            n = self.unpack(_LENGTH[b])
            if b <= 0xc6:
                return bytes(self.take(n))
            if 0xd9 <= b <= 0xdb:
                return self._str(n)
            if b in (0xdc, 0xdd):
                return [self.read() for _ in range(n)]
            if b in (0xde, 0xdf):
                return self._map(n)
            return self._ext(n)
        if b in _FIXEXT:
            return self._ext(_FIXEXT[b])
        raise MsgpackError(f"byte 0x{b:02x} at {self.pos - 1} starts no msgpack object")

    def _str(self, n: int):
        raw = bytes(self.take(n))
        return raw if self.raw_str else raw.decode("utf-8")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int):
        code = self.unpack(">b")
        payload = self.take(n)
        if code == EXT_NDARRAY:
            return _array(payload)
        if code == EXT_NPSCALAR:
            return _array(payload)[()]
        if code == EXT_COMPLEX:
            re, im = _Reader(payload).read_all()
            return complex(re, im)
        raise MsgpackError(f"msgpack ext type {code} is not one of flax's")


def _tuple(d: dict) -> Tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(tree):
    """Reassemble flax's chunked array leaves, in place where possible."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(CHUNKED) is True:
        try:
            shape = _tuple(tree["shape"])
            return np.concatenate(_tuple(tree["chunks"])).reshape(shape)
        except (KeyError, TypeError, ValueError) as e:
            raise MsgpackError(f"malformed {CHUNKED} leaf: {e}") from e
    for k, v in tree.items():
        tree[k] = _unchunk(v)
    return tree


def msgpack_restore(data: bytes):
    """The tree that `flax.serialization.msgpack_restore(data)` returns."""
    return _unchunk(_Reader(data).read_all())
