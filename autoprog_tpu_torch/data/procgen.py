"""Procedurally generated hard classification benchmark (`procgen://`).

The only *real* image corpus reachable in this environment is sklearn's
8x8 digits, which cannot support accuracy claims at the fidelity the
reference makes them (`reference/README.md:13-16`). This dataset
is the strongest substitute the environment allows: a fully
deterministic, procedurally generated shape-composition task that is
genuinely hard (needs rotation/scale/translation-invariant shape
recognition, not color statistics) yet perfectly reproducible across
processes and machines.

Each class is a fixed composition of 3-6 colored shapes (irregular
polygons / ellipses / bars) in a canonical frame, derived from a
class-seeded RNG. Each sample renders that composition through a random
similarity transform (rotation +-60 deg, scale 0.65-1.3, translation
+-25%), with per-shape position/color jitter, on top of a random
gradient + translucent-blob background, followed by pixel noise. Labels
are balanced by construction (sample i has class i % C). The val split
draws from a disjoint per-index stream of the same class prototypes, so
generalization is across nuisance transforms, exactly like a real
vision benchmark.

Replaces nothing in the reference (it trains on ImageNet); this exists
to carry the "no accuracy drop" A/B at non-toy resolution where
ImageNet is unreachable. See PERF.md "Accuracy evidence".
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_SPLIT_OFFSET = {"train": 0, "validation": 1_000_003, "val": 1_000_003,
                 "test": 2_000_003}


class ProcGenDataset:
    """Deterministic generated shape-composition classification."""

    def __init__(self, size: int = 20000, num_classes: int = 100,
                 image_size: int = 128, split: str = "train",
                 seed: int = 0, token_label_hw: Optional[int] = None):
        self.size = size
        self.num_classes = num_classes
        self.image_size = image_size
        self.split = split
        self.seed = seed
        self.token_label_hw = token_label_hw
        self._protos = {}

    def __len__(self):
        return self.size

    # ---------------- class prototypes (fixed per class) ----------------

    def _class_proto(self, label: int):
        proto = self._protos.get(label)
        if proto is not None:
            return proto
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, 777_000_111, label]))
        n_shapes = int(rng.integers(3, 7))
        shapes = []
        for _ in range(n_shapes):
            kind = rng.choice(["poly", "ellipse", "bar"])
            # canonical frame is [-1, 1]^2
            cx, cy = rng.uniform(-0.55, 0.55, 2)
            radius = rng.uniform(0.12, 0.42)
            color = rng.integers(40, 255, 3)
            if kind == "poly":
                k = int(rng.integers(3, 8))
                phase = rng.uniform(0, 2 * np.pi)
                # irregular radius per vertex makes the outline class-
                # specific beyond "a triangle" / "a square"
                rads = radius * rng.uniform(0.6, 1.0, k)
                ang = phase + np.linspace(0, 2 * np.pi, k, endpoint=False)
                pts = np.stack([cx + rads * np.cos(ang),
                                cy + rads * np.sin(ang)], 1)
            elif kind == "ellipse":
                a, b = radius, radius * rng.uniform(0.35, 1.0)
                phase = rng.uniform(0, 2 * np.pi)
                t = np.linspace(0, 2 * np.pi, 24, endpoint=False)
                x = a * np.cos(t)
                y = b * np.sin(t)
                c, s = np.cos(phase), np.sin(phase)
                pts = np.stack([cx + c * x - s * y, cy + s * x + c * y], 1)
            else:  # bar
                ln = rng.uniform(0.3, 0.9)
                w = rng.uniform(0.04, 0.12)
                phase = rng.uniform(0, 2 * np.pi)
                bx = np.array([-ln / 2, ln / 2, ln / 2, -ln / 2])
                by = np.array([-w / 2, -w / 2, w / 2, w / 2])
                c, s = np.cos(phase), np.sin(phase)
                pts = np.stack([cx + c * bx - s * by,
                                cy + s * bx + c * by], 1)
            shapes.append((pts, color))
        proto = shapes
        self._protos[label] = proto
        return proto

    # ---------------- per-sample rendering ------------------------------

    def load(self, i: int):
        from PIL import Image, ImageDraw
        S = self.image_size
        off = _SPLIT_OFFSET.get(self.split, 0)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, 333_000_331, off + i]))
        label = int(i) % self.num_classes

        # background: vertical/horizontal gradient + translucent blobs
        g0 = rng.integers(30, 200, 3).astype(np.float32)
        g1 = rng.integers(30, 200, 3).astype(np.float32)
        ramp = np.linspace(0, 1, S, dtype=np.float32)
        if rng.random() < 0.5:
            bg = g0[None, None] + (g1 - g0)[None, None] * ramp[:, None, None]
        else:
            bg = g0[None, None] + (g1 - g0)[None, None] * ramp[None, :, None]
        bg = np.ascontiguousarray(np.broadcast_to(bg, (S, S, 3)))
        img = Image.fromarray(bg.astype(np.uint8), "RGB")
        draw = ImageDraw.Draw(img, "RGBA")
        for _ in range(int(rng.integers(1, 4))):
            bx, by = rng.integers(0, S, 2)
            br = int(rng.integers(S // 6, S // 2))
            col = tuple(int(v) for v in rng.integers(0, 255, 3)) + (70,)
            draw.ellipse([bx - br, by - br, bx + br, by + br], fill=col)

        # global similarity transform for this sample
        theta = rng.uniform(-np.pi / 3, np.pi / 3)
        scale = rng.uniform(0.65, 1.3)
        tx, ty = rng.uniform(-0.25, 0.25, 2)
        c, s = np.cos(theta) * scale, np.sin(theta) * scale

        for pts, color in self._class_proto(label):
            # small per-shape, per-sample jitter on top of the global
            # transform: position +-4% of frame, color +-25 per channel
            jx, jy = rng.uniform(-0.04, 0.04, 2)
            col = np.clip(color + rng.integers(-25, 26, 3), 0, 255)
            x = pts[:, 0] + jx
            y = pts[:, 1] + jy
            wx = c * x - s * y + tx
            wy = s * x + c * y + ty
            px = (wx * 0.5 + 0.5) * (S - 1)
            py = (wy * 0.5 + 0.5) * (S - 1)
            draw.polygon(list(zip(px.tolist(), py.tolist())),
                         fill=tuple(int(v) for v in col) + (235,))

        arr = np.asarray(img, np.float32)
        # photometric jitter + pixel noise (f32 at 1/2 res, replicated —
        # same cost trick as SyntheticDataset)
        arr = arr * rng.uniform(0.75, 1.25) + rng.uniform(-20, 20)
        h = max(S // 2, 1)
        noise = rng.standard_normal((h, h, 3), dtype=np.float32) * 8.0
        noise = np.repeat(np.repeat(noise, 2, 0), 2, 1)[:S, :S]
        if noise.shape[0] < S:
            pad = S - noise.shape[0]
            noise = np.pad(noise, ((0, pad), (0, pad), (0, 0)), mode="edge")
        arr = np.clip(arr + noise, 0, 255)
        out = Image.fromarray(arr.astype(np.uint8), "RGB")

        maps = None
        if self.token_label_hw:
            hw = self.token_label_hw
            scores = rng.random((5, hw, hw)).astype(np.float32)
            scores /= scores.sum(0, keepdims=True) * 1.25
            inds = rng.integers(0, self.num_classes,
                                (5, hw, hw)).astype(np.int32)
            inds[0] = label
            maps = (scores, inds)
        return out, label, maps
