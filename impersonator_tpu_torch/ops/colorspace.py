"""RGB <-> planar YUV 4:2:0 (I420) on the device (torch port of
``impersonator_tpu/ops/colorspace.py``).

:func:`rgb_to_i420` packs predictions for readback and the video
encoder (1.5 bytes a pixel against u8 RGB's 3); :func:`i420_to_rgb_device`
unpacks a decoder's raw yuv420p frames for HMR (ingest);
:func:`i420_to_rgb` is the host inverse for JPEG export and tests. BT.601
limited range ("studio swing"), what ffmpeg assumes for rawvideo
``-pix_fmt yuv420p``. Rounding is half to even (``torch.round`` /
``np.round``), as ``jnp.round``.
"""

from __future__ import annotations

import numpy as np
import torch

# BT.601 limited range, R/G/B in [0,1]:
#   Y  = 16  +  65.481 R + 128.553 G +  24.966 B
#   Cb = 128 -  37.797 R -  74.203 G + 112.000 B
#   Cr = 128 + 112.000 R -  93.786 G -  18.214 B
_FWD = np.array([[65.481, 128.553, 24.966],
                 [-37.797, -74.203, 112.0],
                 [112.0, -93.786, -18.214]], np.float32)
_OFF = np.array([16.0, 128.0, 128.0], np.float32)


def _u8(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x).clamp(0, 255).to(torch.uint8)


def rgb_to_u8(preds: torch.Tensor) -> torch.Tensor:
    """Float in [-1, 1] -> uint8 RGB, ``round((x + 1) * 127.5)`` clipped,
    on the tensor's device (the JAX package's readback quantise)."""
    return _u8((preds.float() + 1.0) * 127.5)


def rgb_to_i420(preds: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) float in [-1, 1] -> packed I420 (N, H*3//2, W) uint8
    on the same device: the Y plane (H rows), then the (H/2, W/2) U plane
    in H/4 rows of width W, then V; ``arr.tobytes()`` of one frame is a
    rawvideo yuv420p frame. Chroma is the mean of each 2x2 block. Every
    step is an elementwise float32 operation in a fixed order (no matmul
    or reduction), so the card and the CPU give the same bits."""
    n, h, w = preds.shape[0], preds.shape[1], preds.shape[2]
    if h % 4 or w % 2:
        raise ValueError(f"I420 needs H % 4 == 0 and W % 2 == 0, got {h}x{w}")
    rgb01 = ((preds.float() + 1.0) * 0.5).clamp(0.0, 1.0)
    r, g, b = rgb01[..., 0], rgb01[..., 1], rgb01[..., 2]
    ycc = [r * float(c[0]) + g * float(c[1]) + b * float(c[2]) + float(o)
           for c, o in zip(_FWD, _OFF)]

    def sub(c):   # 2x2 block mean, (N, H/2, W/2)
        q = c.reshape(n, h // 2, 2, w // 2, 2)
        return ((q[:, :, 0, :, 0] + q[:, :, 0, :, 1])
                + (q[:, :, 1, :, 0] + q[:, :, 1, :, 1])) * 0.25

    return torch.cat([_u8(ycc[0]),
                      _u8(sub(ycc[1])).reshape(n, h // 4, w),
                      _u8(sub(ycc[2])).reshape(n, h // 4, w)], dim=1)


def _planes(packed):
    n, h32, w = packed.shape
    h = h32 * 2 // 3
    return (n, h, w, packed[:, :h, :],
            packed[:, h:h + h // 4, :].reshape(n, h // 2, w // 2),
            packed[:, h + h // 4:, :].reshape(n, h // 2, w // 2))


def i420_to_rgb_device(packed: torch.Tensor) -> torch.Tensor:
    """Packed I420 (N, H*3//2, W) uint8 -> (N, H, W, 3) float32 in
    [-1, 1] on the same device: the BT.601 limited-range inverse with
    nearest-neighbour chroma upsampling, as the host :func:`i420_to_rgb`."""
    n, h, w, y, u, v = _planes(packed)
    up = lambda c: c.float().repeat_interleave(2, 1).repeat_interleave(2, 2)  # noqa: E731
    c = 1.164383 * (y.float() - 16.0)
    d, e = up(u) - 128.0, up(v) - 128.0
    rgb = torch.stack([c + 1.596027 * e,
                       c - 0.391762 * d - 0.812968 * e,
                       c + 2.017232 * d], dim=-1)
    return (rgb / 127.5 - 1.0).clamp(-1.0, 1.0)


def i420_to_rgb(packed: np.ndarray) -> np.ndarray:
    """Host inverse: packed (N, H*3//2, W) uint8 -> (N, H, W, 3) uint8
    RGB (nearest-neighbour chroma upsampling)."""
    n, h, w, y, u, v = _planes(np.asarray(packed))
    up = lambda c: np.repeat(np.repeat(c, 2, axis=1), 2,  # noqa: E731
                             axis=2).astype(np.float32)
    c = 1.164383 * (y.astype(np.float32) - 16.0)
    d, e = up(u) - 128.0, up(v) - 128.0
    rgb = np.stack([c + 1.596027 * e,
                    c - 0.391762 * d - 0.812968 * e,
                    c + 2.017232 * d], axis=-1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)
