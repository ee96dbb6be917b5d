"""ctypes binding for the native image pipeline (native/fastimage.cpp).

Fuses JPEG decode + random-resized-crop + bilinear resize (+ normalize +
hflip) in C++, replacing the PIL decode path in loader workers — the
TPU-side equivalent of the reference's native DataLoader worker stack
(SURVEY §2.3.6). Falls back to PIL transparently when the shared library
is missing or an image is not a JPEG.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB = None
_TRIED = False


def _lib_path() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "native",
        "libfastimage.so")


def load_library():
    global _LIB, _TRIED
    if os.environ.get("AUTOPROG_NO_NATIVE") == "1":
        return None  # A/B kill-switch (scripts/bench_loader.py)
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        # try a quiet build (toolchain is available in the image)
        import subprocess
        try:
            subprocess.run(["make", "-C", os.path.dirname(path)],
                           capture_output=True, timeout=120, check=True)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.fi_decode_jpeg.restype = ctypes.c_int
    lib.fi_decode_jpeg.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.fi_decode_crop_resize.restype = ctypes.c_int
    lib.fi_decode_crop_resize.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int]
    lib.fi_normalize.restype = None
    lib.fi_normalize.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.fi_affine_u8.restype = None
    lib.fi_affine_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.fi_enhance_u8.restype = None
    lib.fi_enhance_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float]
    _LIB = lib
    return _LIB


def available() -> bool:
    return load_library() is not None


def jpeg_size(data: bytes) -> Optional[Tuple[int, int]]:
    """(width, height) from the JPEG header, or None if not decodable."""
    lib = load_library()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.fi_decode_jpeg(data, len(data), None, 0,
                            ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    return w.value, h.value


def decode_crop_resize(data: bytes, box: Tuple[int, int, int, int],
                       size: int) -> Optional[np.ndarray]:
    """Decode + crop (left, top, w, h) + bilinear resize to [size,size,3]
    uint8. Returns None on failure (caller falls back to PIL)."""
    lib = load_library()
    if lib is None:
        return None
    out = np.empty((size, size, 3), np.uint8)
    left, top, w, h = box
    rc = lib.fi_decode_crop_resize(
        data, len(data), left, top, w, h,
        out.ctypes.data_as(ctypes.c_void_p), size, size)
    if rc != 0:
        return None
    return out


ENHANCE_MODES = {"Brightness": 0, "Color": 1, "Contrast": 2,
                 "Sharpness": 3}


def affine(rgb: np.ndarray, coeffs, fill=(128, 128, 128)
           ) -> Optional[np.ndarray]:
    """Inverse-mapped affine warp (PIL Image.transform(AFFINE) semantics):
    output (x, y) samples source (a x + b y + c, d x + e y + f), bilinear,
    constant fill. Returns None when the library is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    rgb = np.ascontiguousarray(rgb)
    h, w = rgb.shape[:2]
    out = np.empty_like(rgb)
    m = np.asarray(coeffs, np.float64)
    f = np.asarray(fill, np.uint8)
    lib.fi_affine_u8(rgb.ctypes.data_as(ctypes.c_void_p), h, w,
                     m.ctypes.data_as(ctypes.c_void_p),
                     f.ctypes.data_as(ctypes.c_void_p),
                     out.ctypes.data_as(ctypes.c_void_p))
    return out


def enhance(rgb: np.ndarray, mode: str, factor: float
            ) -> Optional[np.ndarray]:
    """PIL ImageEnhance.{Brightness,Color,Contrast,Sharpness} on an RGB8
    array (in a copy). Returns None when the library is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    out = np.ascontiguousarray(rgb).copy()
    h, w = out.shape[:2]
    lib.fi_enhance_u8(out.ctypes.data_as(ctypes.c_void_p), h, w,
                      ENHANCE_MODES[mode], float(factor))
    return out


def normalize(rgb: np.ndarray, mean, std, hflip: bool = False) -> np.ndarray:
    """uint8 [H,W,3] -> normalized float32 [H,W,3] (optionally h-flipped)."""
    lib = load_library()
    h, w = rgb.shape[:2]
    out = np.empty((h, w, 3), np.float32)
    if lib is None:
        x = rgb[:, ::-1] if hflip else rgb
        return ((x.astype(np.float32) / 255.0 - np.asarray(mean, np.float32))
                / np.asarray(std, np.float32))
    rgb = np.ascontiguousarray(rgb)
    m = np.asarray(mean, np.float32)
    s = np.asarray(std, np.float32)
    lib.fi_normalize(rgb.ctypes.data_as(ctypes.c_void_p), w, h,
                     m.ctypes.data_as(ctypes.c_void_p),
                     s.ctypes.data_as(ctypes.c_void_p), int(hflip),
                     out.ctypes.data_as(ctypes.c_void_p))
    return out
