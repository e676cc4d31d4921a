"""Person masks for the background at personalisation (torch port of
``impersonator_tpu/utils/detectors.py``).

* :class:`SilhouetteDetector` — the body mask from the SMPL conditioning
  map: its background channel eroded by ``ks``, inverted;
* :class:`MaskRCNNDetector` — torchvision's Mask R-CNN in the JAX
  package. Its ``pretrained=True`` weights need a download, which this
  repository never makes, so building it raises;
* :func:`build_detector` — ``--has_detector``: Mask R-CNN when it can be
  built, else, loudly, the silhouette detector. That fallback is what the
  JAX package does wherever Mask R-CNN cannot be built, and the tasks then
  keep no detector (their masks come from the conditioning map as
  without one).
"""

from __future__ import annotations

import numpy as np
import torch

from impersonator_tpu_torch.ops import morphology

MASKRCNN_ITEM = ("the MaskRCNN detector needs torchvision's pretrained=True "
                 "weights, a download this repository never makes (carried "
                 "in ROADMAP with the other downloads)")


class SilhouetteDetector:
    """The body mask from the SMPL conditioning map (no model)."""

    def __init__(self, ks: int = 13):
        self.ks = ks

    def inference_from_cond(self, cond: torch.Tensor):
        """cond (1, H, W, C), NHWC with the background on its last
        channel -> (bbox (4,) int32 numpy [x_min, x_max, y_min, y_max] of
        the mask's pixels above 0.5, the whole frame when there is none;
        body_mask (1, H, W, 1) float, NHWC like cond, on cond's
        device)."""
        bg_mask = morphology.morph(cond[..., -1:], ks=self.ks, mode="erode")
        body_mask = 1.0 - bg_mask
        m = body_mask[0, :, :, 0].cpu().numpy()
        ys, xs = np.nonzero(m > 0.5)
        if len(ys) == 0:
            bbox = np.array([0, m.shape[1], 0, m.shape[0]], np.int32)
        else:
            bbox = np.array([xs.min(), xs.max(), ys.min(), ys.max()],
                            np.int32)
        return bbox, body_mask


class MaskRCNNDetector:
    """torchvision's maskrcnn_resnet50_fpn in the JAX package (the
    largest person instance, dilated by ``ks``); not buildable here."""

    def __init__(self, ks: int = 13, threshold: float = 0.5):
        raise RuntimeError(MASKRCNN_ITEM)


def build_detector(has_detector: bool, ks: int = 13):
    """Mask R-CNN for ``has_detector`` when it can be built; otherwise
    (and always here) print the fallback and return a
    :class:`SilhouetteDetector`, as the JAX package does."""
    if not has_detector:
        return SilhouetteDetector(ks)
    try:
        return MaskRCNNDetector(ks)
    except RuntimeError as e:
        print(f"detectors: --has_detector requested but MaskRCNN is "
              f"unavailable ({type(e).__name__}: {e}); falling back to "
              f"the SMPL-silhouette mask")
        return SilhouetteDetector(ks)
