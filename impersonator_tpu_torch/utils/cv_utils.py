"""Host-side image helpers (port of ``impersonator_tpu/utils/cv_utils.py``
without OpenCV, which the GPU hosts do not have).

:func:`resize_img_hwc` is ``transform_img``: bring an image to [0, 1]
if it is in [0, 255], resize it bilinearly and map it to [-1, 1]. The
resize is ``F.interpolate(bilinear, align_corners=False,
antialias=False)``: half-pixel centres, edge samples clamped, no
antialiasing — what ``cv2.resize``'s INTER_LINEAR computes for float
input.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


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
