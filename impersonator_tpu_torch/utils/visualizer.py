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
