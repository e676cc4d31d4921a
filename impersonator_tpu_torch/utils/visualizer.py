"""Training observability (torch port of
``impersonator_tpu/utils/visualizer.py:24-78``): ``loss_log.jsonl`` (one
JSON record per log event), PNG image strips under
``{expr_dir}/visuals/`` and wall-clock phase timers. PNGs are written
with the standard library (zlib + struct), so no image package is
needed.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from collections import defaultdict
from contextlib import contextmanager

import numpy as np


def write_png(path: str, rgb: np.ndarray) -> None:
    """(H, W, 3) uint8 RGB -> an 8-bit truecolour PNG, no filtering."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


def _numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x)


class Visualizer:
    def __init__(self, expr_dir: str):
        self.expr_dir = expr_dir
        self.log_path = os.path.join(expr_dir, "loss_log.jsonl")
        self.visual_dir = os.path.join(expr_dir, "visuals")
        os.makedirs(self.visual_dir, exist_ok=True)
        self._timers = defaultdict(float)
        self._counts = defaultdict(int)

    # --- scalars ---------------------------------------------------------

    def log_scalars(self, step: int, epoch: int, scalars: dict,
                    phase: str = "train") -> dict:
        rec = {"t": time.time(), "step": int(step), "epoch": int(epoch),
               "phase": phase}
        rec.update({k: float(v) for k, v in scalars.items()})
        with open(self.log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec

    def print_current_errors(self, epoch, step, errors, t_per_sample):
        msg = (f"(epoch {epoch}, step {step}, t/smpl {t_per_sample:.3f}s) "
               + " ".join(f"{k}:{float(v):.4f}" for k, v in errors.items()))
        print(msg, flush=True)

    # --- images ----------------------------------------------------------

    def save_images(self, step: int, visuals: dict) -> list:
        """visuals: name -> (H, W, C) or (B, H, W, C) in [-1, 1], C 1 or
        3 (a batch becomes a horizontal strip). Returns the paths."""
        paths = []
        for name, img in visuals.items():
            arr = _numpy(img)
            if arr.ndim == 4:
                arr = np.concatenate(list(arr), axis=1)
            if arr.shape[-1] == 1:
                arr = np.repeat(arr, 3, axis=-1)
            out = ((arr + 1.0) / 2.0 * 255).clip(0, 255).astype(np.uint8)
            path = os.path.join(self.visual_dir, f"{step:08d}_{name}.png")
            write_png(path, out)
            paths.append(path)
        return paths

    # --- timers ----------------------------------------------------------

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._timers[name] += time.perf_counter() - t0
            self._counts[name] += 1

    def timer_summary(self) -> dict:
        return {k: {"total_s": v, "count": self._counts[k],
                    "mean_s": v / max(self._counts[k], 1)}
                for k, v in self._timers.items()}


def fim_enc_to_img(fim_enc, map_name: str) -> np.ndarray:
    """Conditioning map (H, W, C) -> a displayable (H, W, 3) float32 image
    (``impersonator_tpu/utils/visualizer.py:80-103``)."""
    enc = _numpy(fim_enc)
    if map_name == "uv":
        img = np.ones(enc.shape[:2] + (3,), np.float32)
        img[..., :2] = enc[..., :2]
    elif map_name in ("seg", "ids"):
        img = np.repeat(enc[..., :1], 3, axis=-1)
    elif map_name == "uv_seg":
        img = enc.copy()
    elif map_name == "par":
        lab = enc.argmax(axis=-1).astype(np.float32)
        lab /= max(lab.max(), 1.0)
        img = np.repeat(lab[..., None], 3, axis=-1)
    elif map_name == "binary":
        weights = 2.0 ** np.arange(enc.shape[-1])[::-1]
        val = (np.maximum(enc, 0) * weights).sum(-1)
        val /= max(val.max(), 1.0)
        img = np.repeat(val[..., None].astype(np.float32), 3, axis=-1)
    else:
        raise ValueError(map_name)
    return img.astype(np.float32)


# LSP-plus skeleton connectivity (0-indexed): HMR's j2d is cocoplus, 0..13
# the LSP joints, 14..18 the face / neck extras.
SKELETON_LIMBS = [(13, 12), (12, 9), (9, 10), (10, 11), (12, 8), (8, 7),
                  (7, 6), (12, 3), (12, 2), (3, 4), (4, 5), (2, 1), (1, 0),
                  (17, 15), (15, 14), (14, 16), (16, 18)]


def _line(out: np.ndarray, p0, p1, color) -> None:
    """An 8-connected one-pixel line from p0 to p1 (x, y), drawn left to
    right with OpenCV's LineIterator error rule: the major axis advances
    every step, the minor one after the error term went negative. Pixels
    outside the image are skipped."""
    (x0, y0), (x1, y1) = (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1]))
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, abs(y1 - y0)
    sy = 1 if y1 >= y0 else -1
    steep = dy > dx
    major, minor = (dy, dx) if steep else (dx, dy)
    err = major - 2 * minor
    x, y = x0, y0
    h, w = out.shape[:2]
    for _ in range(major + 1):
        if 0 <= x < w and 0 <= y < h:
            out[y, x] = color
        take_minor = err < 0
        err += -2 * minor + (2 * major if take_minor else 0)
        if steep:
            y += sy
            x += 1 if take_minor else 0
        else:
            x += 1
            y += sy if take_minor else 0


def _disc(out: np.ndarray, center, radius: int, color) -> None:
    """A filled disc by the midpoint circle walk of OpenCV's filled
    ``circle`` (LINE_8): horizontal spans at ±dy and ±dx rows, clipped to
    the image."""
    cx, cy = int(center[0]), int(center[1])
    h, w = out.shape[:2]

    def span(y, xa, xb):
        if 0 <= y < h:
            xa, xb = max(xa, 0), min(xb, w - 1)
            if xa <= xb:
                out[y, xa:xb + 1] = color

    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        span(cy - dy, cx - dx, cx + dx)
        span(cy + dy, cx - dx, cx + dx)
        span(cy - dx, cx - dy, cx + dy)
        span(cy + dx, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def draw_skeleton(img, kps, color=(0.0, 1.0, 0.0),
                  radius: int = 2) -> np.ndarray:
    """Overlay 2D keypoints and limbs on an image
    (``impersonator_tpu/utils/visualizer.py:114-134``, in numpy).

    img: (S, S, 3) in [-1, 1]; kps: (K, 2) in [-1, 1] image coordinates
    (HMR's j2d). Returns a copy in [-1, 1]. As in the JAX package, the
    colour's channels are written in reverse order (it hands OpenCV a BGR
    colour for an RGB image)."""
    img = _numpy(img)
    s = img.shape[0]
    out = ((img + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
    out = np.ascontiguousarray(out)
    pts = ((_numpy(kps)[:, :2] + 1.0) * 0.5 * (s - 1)).astype(int)
    col = np.array([int(c * 255) for c in color[::-1]], np.uint8)
    k = pts.shape[0]
    for a, b in SKELETON_LIMBS:
        if a < k and b < k:
            _line(out, pts[a], pts[b], col)
    for p in pts:
        _disc(out, p, radius, col)
    return out.astype(np.float32) / 127.5 - 1.0
