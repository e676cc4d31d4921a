"""Host-side image IO and camera algebra (port of
``impersonator_tpu/utils/cv_utils.py`` without OpenCV): read / save /
resize / normalise (:10-47) on the port's codec (``data.native``), the
HMR crop-camera transforms (:176-245) and global-rotation edits
(:356-376) with Rodrigues in numpy.

:func:`resize_img_hwc` is ``transform_img``: bring an image to [0, 1]
if it is in [0, 255], resize it bilinearly and map it to [-1, 1]. The
resize is ``F.interpolate(bilinear, align_corners=False,
antialias=False)``: half-pixel centres, edge samples clamped, no
antialiasing — what ``cv2.resize``'s INTER_LINEAR computes for float
input.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from impersonator_tpu_torch.data import native
from impersonator_tpu_torch.utils.visualizer import write_png


def resize_img_hwc(img: np.ndarray, image_size: int) -> np.ndarray:
    """uint8/float HWC -> float32 HWC at image_size², then ``* 2 - 1``.
    Values above 1.5 anywhere mean a [0, 255] image, which is divided by
    255 first; any other float image is taken as [0, 1], so an image
    already in [-1, 1] comes out in [-3, 1], as in the JAX package."""
    if img.dtype != np.float32:
        img = img.astype(np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    if img.shape[0] != image_size or img.shape[1] != image_size:
        x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)
        x = F.interpolate(x[None], size=(image_size, image_size),
                          mode="bilinear", align_corners=False,
                          antialias=False)
        img = x[0].permute(1, 2, 0).numpy()
    return img * 2.0 - 1.0


def read_img(path: str, device="cuda") -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB (``cv_utils.read_cv2_img``),
    decoded by the codec of ``device``'s type (``data.native``)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return native.read_image(path, device)


def _to_u8(img, normalize: bool) -> np.ndarray:
    out = np.asarray(img)
    if normalize:
        return ((out + 1.0) / 2.0 * 255).clip(0, 255).astype(np.uint8)
    if out.dtype != np.uint8:
        return out.clip(0, 255).astype(np.uint8)
    return out


def save_img(img, path: str, normalize: bool = True,
             image_size: int | None = None, device="cuda") -> str:
    """float HWC in [-1, 1] (or uint8 with ``normalize=False``) -> a PNG
    (zlib) or, for ``.jpg`` / ``.jpeg``, a JPEG at quality 95, 4:2:0 from
    the codec of ``device``'s type (``save_cv2_img``, :40-47).
    ``image_size`` resizes the uint8 frame first with the loader's
    bilinear (within one level of ``cv2.resize``)."""
    out = _to_u8(img, normalize)
    if image_size is not None:
        out = native.resize_u8(out, image_size, device)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.lower().endswith((".jpg", ".jpeg")):
        data = native.encode_jpeg(out, device=device)
        with open(path, "wb") as f:
            f.write(data)
    else:
        write_png(path, out)
    return path


def load_image_batch(paths, image_size: int, device="cuda") -> np.ndarray:
    """Decode + resize a frame list -> (N, S, S, 3) in [-1, 1]."""
    return np.stack([resize_img_hwc(read_img(p, device), image_size)
                     for p in paths])


# --------------------------------------------------------------------------
# HMR crop-camera algebra (cv_utils.py:176-245)
# --------------------------------------------------------------------------

def cam_init2orig(cam, scale, start_pt, N: int = 224):
    """HMR crop cam -> original-image cam (cv_utils.py:176-200)."""
    cam = np.asarray(cam, np.float64)
    start_pt = np.asarray(start_pt, np.float64)
    cam_crop = np.hstack([N * cam[0] * 0.5, cam[1:] + (2.0 / cam[0]) * 0.5])
    cam_orig = np.hstack([
        cam_crop[0] / scale,
        cam_crop[1:] + (start_pt - N) / cam_crop[0],
    ])
    return cam_orig.astype(np.float32)


def cam_orig2crop(cam, scale, start_pt, N: int = 256, normalize: bool = True):
    """Original-image cam -> (normalized) crop cam (cv_utils.py:203-226)."""
    cam = np.asarray(cam, np.float64)
    start_pt = np.asarray(start_pt, np.float64)
    cam_recrop = np.hstack([
        cam[0] * scale,
        cam[1:] + (N - start_pt) / (scale * cam[0]),
    ])
    if normalize:
        cam_recrop = np.hstack([
            cam_recrop[0] * (2.0 / N),
            cam_recrop[1:] - N / (2 * cam_recrop[0]),
        ])
    return cam_recrop.astype(np.float32)


def cam_process(cam_init, scale_150, start_pt_150, scale_proc, start_pt_proc,
                image_size):
    """Chain of the two transforms above (cv_utils.py:229-245)."""
    cam_orig = cam_init2orig(cam_init, scale_150, start_pt_150, N=224)
    return cam_orig2crop(cam_orig, scale_proc, start_pt_proc, N=image_size)


def euler2matrix(rt, deg: bool = True) -> np.ndarray:
    """Euler -> R (cv_utils.py:333-353): R = Rz @ Ry @ Rx."""
    rt = np.asarray(rt, np.float64)
    if deg:
        rt = np.deg2rad(rt)
    x, y, z = rt
    rx = np.array([[1, 0, 0], [0, math.cos(x), -math.sin(x)],
                   [0, math.sin(x), math.cos(x)]])
    ry = np.array([[math.cos(y), 0, math.sin(y)], [0, 1, 0],
                   [-math.sin(y), 0, math.cos(y)]])
    rz = np.array([[math.cos(z), -math.sin(z), 0],
                   [math.sin(z), math.cos(z), 0], [0, 0, 1]])
    return (rz @ ry @ rx).astype(np.float32)


def _rodrigues_matrix(aa) -> np.ndarray:
    """Axis-angle (3,) -> rotation (3, 3), float64 (``cv2.Rodrigues`` of a
    vector)."""
    r = np.asarray(aa, np.float64).reshape(3)
    theta = float(np.linalg.norm(r))
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    k = r / theta
    kx = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]],
                   [-k[1], k[0], 0.0]])
    c, s = math.cos(theta), math.sin(theta)
    return c * np.eye(3) + (1.0 - c) * np.outer(k, k) + s * kx


def _rodrigues_vector(rot) -> np.ndarray:
    """Rotation (3, 3) -> axis-angle (3,), float64 (``cv2.Rodrigues`` of a
    matrix: the nearest orthogonal matrix by SVD first, and the angle-π
    case from the diagonal of (R + I) / 2)."""
    u, _, vt = np.linalg.svd(np.asarray(rot, np.float64))
    r = u @ vt
    v = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    s = math.sqrt((v ** 2).sum() * 0.25)
    c = float(np.clip((np.trace(r) - 1.0) * 0.5, -1.0, 1.0))
    theta = math.acos(c)
    if s < 1e-5:
        if c > 0:
            return np.zeros(3)
        t = (r[0, 0] + 1.0) * 0.5, (r[1, 1] + 1.0) * 0.5, (r[2, 2] + 1.0) * 0.5
        out = np.sqrt(np.maximum(t, 0.0))
        if r[0, 1] < 0:
            out[1] = -out[1]
        if r[0, 2] < 0:
            out[2] = -out[2]
        if (abs(out[0]) < abs(out[1]) and abs(out[0]) < abs(out[2])
                and (r[1, 2] > 0) != (out[1] * out[2] > 0)):
            out[2] = -out[2]
        return out * (theta / np.linalg.norm(out))
    return v * (theta / (2.0 * s))


def rotate_global_pose(pose72: np.ndarray, R: np.ndarray) -> np.ndarray:
    """Compose a rotation into the global axis-angle (cv_utils.py:356-376),
    with Rodrigues in numpy."""
    pose = np.asarray(pose72, np.float32).copy()
    orig_r = _rodrigues_matrix(pose[..., :3])
    new_r = np.asarray(R, np.float64) @ orig_r
    pose[..., :3] = _rodrigues_vector(new_r).reshape(3)
    return pose
