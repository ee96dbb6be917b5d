"""Host-side image transforms (PIL + numpy).

Replaces the timm transform stack the reference's loaders assemble
(`timm.create_loader` with RandAugment / random-resized-crop / random-erase,
`main_prog.py:640-708`; SURVEY §2.2). Self-contained so the input pipeline
has no torch/timm dependency:

  * RandomResizedCrop with the (scale, ratio) sampling loop and selectable
    interpolation ('random' picks bilinear/bicubic per sample, matching
    `--train-interpolation random`);
  * RandAugment for `rand-m{M}-mstd0.5-inc{0,1}` policy strings — the only
    family the progressive schedule emits (`prog/progressive.py:23-26`);
  * per-pixel random erasing (timm `--remode pixel` semantics) applied on
    the normalized array;
  * eval center-crop at crop_pct (`validate.py` protocol, crop_pct 0.96
    for VOLO — `models/volo.py:36`).

Every transform consumes an explicit `np.random.Generator` so worker
determinism is seed-controlled, and the crop/flip parameters are returned
so token-label maps can be cropped consistently (tlt behavior).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

INTERP = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC,
          "nearest": Image.NEAREST}


def _pick_interp(name: str, rng: np.random.Generator):
    if name == "random":
        return INTERP["bilinear"] if rng.random() < 0.5 else INTERP["bicubic"]
    return INTERP.get(name, Image.BICUBIC)


@dataclass
class CropParams:
    top: int
    left: int
    height: int
    width: int
    hflip: bool
    vflip: bool
    src_h: int
    src_w: int


def sample_resized_crop(img_h: int, img_w: int, scale, ratio,
                        rng: np.random.Generator) -> Tuple[int, int, int, int]:
    """Sample a (top, left, h, w) crop box; falls back to a center crop at
    the clamped aspect ratio after 10 rejected draws."""
    area = img_h * img_w
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= img_w and 0 < h <= img_h:
            top = int(rng.integers(0, img_h - h + 1))
            left = int(rng.integers(0, img_w - w + 1))
            return top, left, h, w
    in_ratio = img_w / img_h
    if in_ratio < ratio[0]:
        w, h = img_w, int(round(img_w / ratio[0]))
    elif in_ratio > ratio[1]:
        h, w = img_h, int(round(img_h * ratio[1]))
    else:
        w, h = img_w, img_h
    return (img_h - h) // 2, (img_w - w) // 2, h, w


# --------------------------- RandAugment ----------------------------------

_MAX_LEVEL = 10.0


def _enhance(factor_cls):
    def op(img, mag):
        return factor_cls(img).enhance(1.0 + mag)
    return op


def _shear(axis):
    def op(img, mag):
        c = (1, mag, 0, 0, 1, 0) if axis == 0 else (1, 0, 0, mag, 1, 0)
        return img.transform(img.size, Image.AFFINE, c, Image.BILINEAR,
                             fillcolor=(128, 128, 128))
    return op


def _translate(axis):
    def op(img, mag):
        d = int(mag * (img.size[0] if axis == 0 else img.size[1]))
        c = (1, 0, d, 0, 1, 0) if axis == 0 else (1, 0, 0, 0, 1, d)
        return img.transform(img.size, Image.AFFINE, c, Image.BILINEAR,
                             fillcolor=(128, 128, 128))
    return op


def _solarize_add(img, add):
    lut = [min(255, i + int(add)) if i < 128 else i for i in range(256)]
    return img.point(lut * len(img.getbands()))


def _level_signed(level, rng, maxval):
    v = level / _MAX_LEVEL * maxval
    return -v if rng.random() < 0.5 else v


# ---- array implementations (uint8 [H,W,3]) of the same ops ----------------
# Point ops are plain numpy LUTs; geometric ops go through the native
# inverse-affine kernel (fi_affine_u8) and enhancement through
# fi_enhance_u8 — no PIL round-trip in loader workers. Each mirrors its
# PIL counterpart's math (truncation/rounding included) so the two paths
# agree within resampling rounding.

_RA_FILL = (128, 128, 128)


def _np_lut(x: np.ndarray, lut: np.ndarray) -> np.ndarray:
    return lut.astype(np.uint8)[x]


def _np_autocontrast(x: np.ndarray, _m) -> np.ndarray:
    out = np.empty_like(x)
    for c in range(x.shape[-1]):
        ch = x[..., c]
        h = np.bincount(ch.ravel(), minlength=256)
        nz = np.nonzero(h)[0]
        if nz.size == 0 or nz[0] == nz[-1]:
            out[..., c] = ch
            continue
        lo, hi = int(nz[0]), int(nz[-1])
        scale = 255.0 / (hi - lo)
        lut = np.clip((np.arange(256) * scale - lo * scale).astype(int),
                      0, 255)
        out[..., c] = _np_lut(ch, lut)
    return out


def _np_equalize(x: np.ndarray, _m) -> np.ndarray:
    # PIL ImageOps.equalize: per channel, step = (npixels - last_nonzero
    # bin) // 255; lut accumulates h with an n = step // 2 bias
    out = np.empty_like(x)
    for c in range(x.shape[-1]):
        ch = x[..., c]
        h = np.bincount(ch.ravel(), minlength=256)
        nz = h[np.nonzero(h)[0]]
        if nz.size <= 1:
            out[..., c] = ch
            continue
        step = (int(h.sum()) - int(nz[-1])) // 255
        if not step:
            out[..., c] = ch
            continue
        n = step // 2 + np.concatenate([[0], np.cumsum(h)[:-1]])
        lut = np.clip(n // step, 0, 255)
        out[..., c] = _np_lut(ch, lut)
    return out


def _np_invert(x: np.ndarray, _m) -> np.ndarray:
    return 255 - x


def _np_posterize(x: np.ndarray, m) -> np.ndarray:
    bits = max(1, int(m))
    return x & np.uint8(0xFF & (0xFF << (8 - bits)))


def _np_solarize(x: np.ndarray, m) -> np.ndarray:
    t = int(m)
    return np.where(x < t, x, 255 - x).astype(np.uint8)


def _np_solarize_add(x: np.ndarray, add) -> np.ndarray:
    add = int(add)
    bumped = np.minimum(x.astype(np.int16) + add, 255).astype(np.uint8)
    return np.where(x < 128, bumped, x)


def _np_affine(x: np.ndarray, coeffs):
    from autoprog_tpu_torch.data import native
    out = native.affine(x, coeffs, _RA_FILL)
    if out is not None:
        return out
    img = Image.fromarray(x).transform(
        (x.shape[1], x.shape[0]), Image.AFFINE, coeffs, Image.BILINEAR,
        fillcolor=_RA_FILL)
    return np.asarray(img)


def _np_rotate(x: np.ndarray, deg) -> np.ndarray:
    # PIL Image.rotate: inverse map built from -angle about the center
    a = -math.radians(deg)
    cos, sin = math.cos(a), math.sin(a)
    h, w = x.shape[:2]
    cx, cy = w / 2.0, h / 2.0
    c = cx - (cos * cx + sin * cy)
    f = cy - (-sin * cx + cos * cy)
    return _np_affine(x, (cos, sin, c, -sin, cos, f))


def _np_shear(axis):
    def op(x, mag):
        coeffs = (1, mag, 0, 0, 1, 0) if axis == 0 else (1, 0, 0, mag, 1, 0)
        return _np_affine(x, coeffs)
    return op


def _np_translate(axis):
    def op(x, mag):
        d = int(mag * (x.shape[1] if axis == 0 else x.shape[0]))
        coeffs = (1, 0, d, 0, 1, 0) if axis == 0 else (1, 0, 0, 0, 1, d)
        return _np_affine(x, coeffs)
    return op


def _np_enhance(name):
    def op(x, mag):
        from autoprog_tpu_torch.data import native
        out = native.enhance(x, name, 1.0 + mag)
        if out is not None:
            return out
        cls = getattr(ImageEnhance, name)
        return np.asarray(cls(Image.fromarray(x)).enhance(1.0 + mag))
    return op


_RA_OPS_ARRAY = {
    "AutoContrast": _np_autocontrast,
    "Equalize": _np_equalize,
    "Invert": _np_invert,
    "Rotate": _np_rotate,
    "Posterize": _np_posterize,
    "Solarize": _np_solarize,
    "SolarizeAdd": _np_solarize_add,
    "Color": _np_enhance("Color"),
    "Contrast": _np_enhance("Contrast"),
    "Brightness": _np_enhance("Brightness"),
    "Sharpness": _np_enhance("Sharpness"),
    "ShearX": _np_shear(0),
    "ShearY": _np_shear(1),
    "TranslateX": _np_translate(0),
    "TranslateY": _np_translate(1),
}


# (name, apply(img, magnitude), magnitude_fn(level, rng))
_RA_OPS = [
    ("AutoContrast", lambda im, m: ImageOps.autocontrast(im), lambda l, r: 0),
    ("Equalize", lambda im, m: ImageOps.equalize(im), lambda l, r: 0),
    ("Invert", lambda im, m: ImageOps.invert(im), lambda l, r: 0),
    ("Rotate", lambda im, m: im.rotate(m, Image.BILINEAR,
                                       fillcolor=(128, 128, 128)),
     lambda l, r: _level_signed(l, r, 30.0)),
    ("Posterize", lambda im, m: ImageOps.posterize(im, max(1, int(m))),
     lambda l, r: 8 - 4 * l / _MAX_LEVEL),            # increasing severity
    ("Solarize", lambda im, m: ImageOps.solarize(im, int(m)),
     lambda l, r: 256 - 256 * l / _MAX_LEVEL),        # increasing severity
    ("SolarizeAdd", _solarize_add, lambda l, r: 110 * l / _MAX_LEVEL),
    ("Color", _enhance(ImageEnhance.Color),
     lambda l, r: _level_signed(l, r, 0.9)),
    ("Contrast", _enhance(ImageEnhance.Contrast),
     lambda l, r: _level_signed(l, r, 0.9)),
    ("Brightness", _enhance(ImageEnhance.Brightness),
     lambda l, r: _level_signed(l, r, 0.9)),
    ("Sharpness", _enhance(ImageEnhance.Sharpness),
     lambda l, r: _level_signed(l, r, 0.9)),
    ("ShearX", _shear(0), lambda l, r: _level_signed(l, r, 0.3)),
    ("ShearY", _shear(1), lambda l, r: _level_signed(l, r, 0.3)),
    ("TranslateX", _translate(0), lambda l, r: _level_signed(l, r, 0.45)),
    ("TranslateY", _translate(1), lambda l, r: _level_signed(l, r, 0.45)),
]


@dataclass
class RandAugment:
    magnitude: float = 9.0
    mstd: float = 0.5
    num_layers: int = 2
    prob: float = 0.5

    @classmethod
    def from_policy(cls, policy: str) -> Optional["RandAugment"]:
        """Parse 'rand-m{M}-mstd{S}-inc1' (empty/None disables)."""
        if not policy:
            return None
        m = re.fullmatch(r"rand-m(\d+(?:\.\d+)?)(?:-mstd(\d+(?:\.\d+)?))?"
                         r"(?:-inc\d)?", policy)
        if not m:
            raise ValueError(f"unsupported RandAugment policy {policy!r}")
        return cls(magnitude=float(m.group(1)),
                   mstd=float(m.group(2) or 0.0))

    def __call__(self, img, rng: np.random.Generator):
        """Apply to a PIL image OR a uint8 [H,W,3] array (array in,
        array out — loader workers stay PIL-free on the native path).
        Both paths draw from `rng` in the same order, so a given seed
        produces the same op/magnitude sequence either way."""
        as_array = isinstance(img, np.ndarray)
        idx = rng.integers(0, len(_RA_OPS), size=self.num_layers)
        for i in idx:
            if rng.random() > self.prob:
                continue
            name, apply_fn, mag_fn = _RA_OPS[int(i)]
            level = self.magnitude
            if self.mstd > 0:
                level = level + rng.normal(0, self.mstd)
            level = float(np.clip(level, 0, _MAX_LEVEL))
            mag = mag_fn(level, rng)
            if as_array:
                img = _RA_OPS_ARRAY[name](img, mag)
            else:
                img = apply_fn(img, mag)
        return img


# --------------------------- random erasing -------------------------------

@dataclass
class RandomErasing:
    prob: float = 0.0
    mode: str = "pixel"
    count: int = 1
    area: Tuple[float, float] = (0.02, 1 / 3)
    aspect: Tuple[float, float] = (0.3, 10 / 3)

    def __call__(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """x: [H, W, C] normalized float array (erased in place)."""
        if self.prob <= 0 or rng.random() > self.prob:
            return x
        H, W, C = x.shape
        for _ in range(self.count):
            for _ in range(10):
                a = rng.uniform(*self.area) * H * W
                r = math.exp(rng.uniform(math.log(self.aspect[0]),
                                         math.log(self.aspect[1])))
                h = int(round(math.sqrt(a * r)))
                w = int(round(math.sqrt(a / r)))
                if h < H and w < W and h > 0 and w > 0:
                    top = int(rng.integers(0, H - h + 1))
                    left = int(rng.integers(0, W - w + 1))
                    if self.mode == "pixel":
                        patch = rng.normal(size=(h, w, C)).astype(x.dtype)
                    elif self.mode == "const":
                        patch = 0.0
                    else:  # 'rand': one random value per region
                        patch = rng.normal(size=(1, 1, C)).astype(x.dtype)
                    x[top:top + h, left:left + w] = patch
                    break
        return x


# --------------------------- pipelines ------------------------------------

@dataclass
class TrainTransform:
    size: int
    scale: Tuple[float, float] = (0.08, 1.0)
    ratio: Tuple[float, float] = (3 / 4, 4 / 3)
    hflip: float = 0.5
    vflip: float = 0.0
    color_jitter: float = 0.0
    rand_augment: Optional[RandAugment] = None
    re_prob: float = 0.0
    re_mode: str = "pixel"
    re_count: int = 1
    interpolation: str = "random"
    mean: Tuple[float, ...] = (0.485, 0.456, 0.406)
    std: Tuple[float, ...] = (0.229, 0.224, 0.225)
    #: skip normalize/erase and return uint8 (the device normalizes;
    #: 4x less host->device traffic — see ops/erase.py)
    emit_uint8: bool = False

    def __call__(self, img, rng: np.random.Generator
                 ) -> Tuple[np.ndarray, CropParams]:
        from autoprog_tpu_torch.data.raw import RawJpeg
        if isinstance(img, RawJpeg):
            out = self._call_native(img, rng)
            if out is not None:
                return out
            import io
            img = Image.open(io.BytesIO(img))  # fallback: PIL decode
        img = img.convert("RGB")
        src_w, src_h = img.size
        top, left, h, w = sample_resized_crop(src_h, src_w, self.scale,
                                              self.ratio, rng)
        img = img.resize((self.size, self.size),
                         _pick_interp(self.interpolation, rng),
                         box=(left, top, left + w, top + h))
        do_h = self.hflip > 0 and rng.random() < self.hflip
        do_v = self.vflip > 0 and rng.random() < self.vflip
        if do_h:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if do_v:
            img = img.transpose(Image.FLIP_TOP_BOTTOM)
        if self.color_jitter:
            for enh in (ImageEnhance.Brightness, ImageEnhance.Contrast,
                        ImageEnhance.Color):
                f = 1.0 + rng.uniform(-self.color_jitter, self.color_jitter)
                img = enh(img).enhance(max(f, 0.0))
        if self.rand_augment is not None:
            img = self.rand_augment(img, rng)
        params = CropParams(top, left, h, w, do_h, do_v, src_h, src_w)
        if self.emit_uint8:
            return np.asarray(img, np.uint8), params
        x = np.asarray(img, np.float32) / 255.0
        x = (x - np.asarray(self.mean, np.float32)) / np.asarray(
            self.std, np.float32)
        if self.re_prob > 0:
            x = RandomErasing(self.re_prob, self.re_mode, self.re_count)(x, rng)
        return x, params

    def _call_native(self, data: bytes, rng: np.random.Generator):
        """Fused C++ decode+crop+resize path (data/native.py); draws the
        same aug parameters in the same order as the PIL path."""
        from autoprog_tpu_torch.data import native
        dims = native.jpeg_size(data)
        if dims is None:
            return None
        src_w, src_h = dims
        top, left, h, w = sample_resized_crop(src_h, src_w, self.scale,
                                              self.ratio, rng)
        _pick_interp(self.interpolation, rng)  # keep rng stream aligned
        rgb = native.decode_crop_resize(data, (left, top, w, h), self.size)
        if rgb is None:
            return None
        flipped = self.hflip > 0 and rng.random() < self.hflip
        do_v = self.vflip > 0 and rng.random() < self.vflip
        if do_v:
            rgb = rgb[::-1]
        flip_in_normalize = flipped
        if self.color_jitter:
            # color jitter still round-trips PIL (rarely combined with
            # RandAugment; timm disables jitter when an aa policy is set)
            img = Image.fromarray(rgb[:, ::-1] if flipped else rgb)
            flip_in_normalize = False
            for enh in (ImageEnhance.Brightness, ImageEnhance.Contrast,
                        ImageEnhance.Color):
                f = 1.0 + rng.uniform(-self.color_jitter,
                                      self.color_jitter)
                img = enh(img).enhance(max(f, 0.0))
            rgb = np.asarray(img)
            if self.rand_augment is not None:
                rgb = self.rand_augment(np.ascontiguousarray(rgb), rng)
        elif self.rand_augment is not None:
            # array-native RandAugment: no PIL round-trip
            if flipped:
                rgb = rgb[:, ::-1]
                flip_in_normalize = False
            rgb = self.rand_augment(np.ascontiguousarray(rgb), rng)
        params = CropParams(top, left, h, w, flipped, do_v, src_h, src_w)
        if self.emit_uint8:
            if flip_in_normalize:
                rgb = rgb[:, ::-1]
            return np.ascontiguousarray(rgb), params
        x = native.normalize(rgb, self.mean, self.std,
                             hflip=flip_in_normalize)
        if self.re_prob > 0:
            x = RandomErasing(self.re_prob, self.re_mode, self.re_count)(x, rng)
        return x, params


@dataclass
class EvalTransform:
    size: int = 224
    crop_pct: float = 0.96
    interpolation: str = "bicubic"
    mean: Tuple[float, ...] = (0.485, 0.456, 0.406)
    std: Tuple[float, ...] = (0.229, 0.224, 0.225)
    emit_uint8: bool = False

    def __call__(self, img) -> np.ndarray:
        from autoprog_tpu_torch.data.raw import RawJpeg
        if isinstance(img, RawJpeg):
            # eval keeps the PIL bicubic path for protocol fidelity
            # (crop_pct + bicubic, `models/volo.py:36`); decode cost is
            # negligible at validation frequency
            import io
            img = Image.open(io.BytesIO(img))
        img = img.convert("RGB")
        scale_size = int(math.floor(self.size / self.crop_pct))
        w, h = img.size
        if w <= h:
            nw, nh = scale_size, int(round(scale_size * h / w))
        else:
            nw, nh = int(round(scale_size * w / h)), scale_size
        img = img.resize((nw, nh), INTERP.get(self.interpolation,
                                              Image.BICUBIC))
        left = (nw - self.size) // 2
        top = (nh - self.size) // 2
        img = img.crop((left, top, left + self.size, top + self.size))
        if self.emit_uint8:
            return np.asarray(img, np.uint8)
        x = np.asarray(img, np.float32) / 255.0
        return (x - np.asarray(self.mean, np.float32)) / np.asarray(
            self.std, np.float32)


@dataclass
class TTAEvalTransform(EvalTransform):
    """Deterministic test-time-augmentation variants of the eval protocol.

    The sample arrives as (image, variant) from `TTADataset`
    (validate.py); variant v selects (crop_pct cycle) x (horizontal
    flip): v=0 is the standard eval view, v=1 its mirror, v=2/3 a
    full-image resize and its mirror, then a tighter crop, ... The
    reference's `--tta N` only *averages* N adjacent loader rows
    (`reference/main.py:961-964`) and ships no pipeline that emits
    them; this provides one."""

    def __call__(self, sample) -> np.ndarray:
        img, v = sample
        flip = bool(v % 2)
        cycle = (self.crop_pct, 1.0, max(0.7, self.crop_pct - 0.1))
        crop = cycle[(v // 2) % len(cycle)]
        base = EvalTransform(size=self.size, crop_pct=crop,
                             interpolation=self.interpolation,
                             mean=self.mean, std=self.std,
                             emit_uint8=self.emit_uint8)
        if flip:
            from autoprog_tpu_torch.data.raw import RawJpeg
            if isinstance(img, RawJpeg):
                import io
                img = Image.open(io.BytesIO(img))
            img = img.convert("RGB").transpose(Image.FLIP_LEFT_RIGHT)
        return base(img)
