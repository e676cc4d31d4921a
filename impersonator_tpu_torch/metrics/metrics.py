"""Paired image-quality metrics (torch port of
``impersonator_tpu/metrics/metrics.py``).

* :func:`ssim`: structural similarity with the skimage / Wang parameters
  the reference uses (Gaussian window σ 1.5, 11 taps, K1 .01, K2 .03,
  L = the data range), as a depthwise ``F.conv2d`` in NCHW;
* :func:`psnr`;
* :func:`perceptual_distance`: an LPIPS-style normalised deep-feature
  distance over any feature net (a consistent relative metric without
  LPIPS' lin heads);
* :func:`sspe_score`: the scale / shape / pose absolute error of two θ
  batches;
* :class:`PairedMetricRunner`: the frame-weighted accumulator of those,
  with the face and re-id embedding hooks.

Images are NHWC float32 tensors (or arrays) in [-1, 1]; the metrics run
on the tensors' device in full float32 (no TF32), so a score does not
move with the card it runs on.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from impersonator_tpu_torch.utils.precision import full_fp32

TYPES_QUALITIES = {
    "ssim": "higher",
    "psnr": "higher",
    "lps": "lower",
}


def _gaussian_kernel(size: int = 11, sigma: float = 1.5,
                     device=None) -> torch.Tensor:
    ax = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    g = torch.exp(-(ax ** 2) / (2 * sigma ** 2))
    k = g[:, None] * g[None, :]
    return k / torch.sum(k)


def _as_tensor(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def ssim(a, b, data_range: float = 2.0) -> torch.Tensor:
    """Mean SSIM over a batch. a, b: (B, H, W, C) in [-1, 1] (range 2).

    The reference's convention: it maps images to [-1, 1] and calls
    skimage with the dtype-inferred data_range 2, so scores differ from
    canonical SSIM on [0, 1] pixels, but its published numbers were
    computed this way."""
    a = _as_tensor(a).permute(0, 3, 1, 2)
    b = _as_tensor(b, a.device).permute(0, 3, 1, 2)
    c = a.shape[1]
    kernel = _gaussian_kernel(device=a.device).expand(c, 1, 11, 11)

    def filt(x):
        return F.conv2d(x, kernel, groups=c)

    with full_fp32():
        mu_a, mu_b = filt(a), filt(b)
        mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
        s_aa = filt(a * a) - mu_aa
        s_bb = filt(b * b) - mu_bb
        s_ab = filt(a * b) - mu_ab
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    num = (2 * mu_ab + c1) * (2 * s_ab + c2)
    den = (mu_aa + mu_bb + c1) * (s_aa + s_bb + c2)
    return torch.mean(num / den)


def psnr(a, b, data_range: float = 2.0) -> torch.Tensor:
    a = _as_tensor(a)
    mse = torch.mean((a - _as_tensor(b, a.device)) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))


def perceptual_distance(net, a, b,
                        lin_weights: Sequence | None = None) -> torch.Tensor:
    """LPIPS-style distance between two NHWC batches: ``net`` maps NCHW
    images to a list of NCHW features; each is unit-normalised across
    channels, squared differences are summed over channels (weighted by
    ``lin_weights[i]`` when given, else averaged) and averaged over
    positions and the batch, then summed over the features."""
    a = _as_tensor(a)
    b = _as_tensor(b, a.device)
    with torch.no_grad(), full_fp32():
        fa = net(a.permute(0, 3, 1, 2))
        fb = net(b.permute(0, 3, 1, 2))
    total = 0.0
    for i, (x, y) in enumerate(zip(fa, fb)):
        xn = x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                             min=1e-10)
        yn = y / torch.clamp(torch.linalg.vector_norm(y, dim=1, keepdim=True),
                             min=1e-10)
        d = (xn - yn) ** 2
        if lin_weights is not None:
            w = _as_tensor(lin_weights[i], d.device)[None, :, None, None]
            total = total + torch.mean(torch.sum(d * w, dim=1))
        else:
            total = total + torch.mean(torch.sum(d, dim=1) / d.shape[1])
    return total


def sspe_score(pred_smpls, ref_smpls) -> float:
    """Scale-shape-pose absolute error between two (B, 85) θ batches
    (``ssp_abs_err_score_func``): mean |Δscale| + mean Σ|Δshape| + mean
    Σ|Δ(cam + pose)|, in float64 on the host."""
    p = np.asarray(torch.as_tensor(pred_smpls).detach().cpu(), np.float64)
    r = np.asarray(torch.as_tensor(ref_smpls).detach().cpu(), np.float64)
    scale_err = np.mean(np.abs(p[:, 0] - r[:, 0]))
    shape_err = np.mean(np.sum(np.abs(p[:, -10:] - r[:, -10:]), axis=1))
    pose_err = np.mean(np.sum(np.abs(p[:, 0:-10] - r[:, 0:-10]), axis=1))
    return float(scale_err + shape_err + pose_err)


def _paired_cosine(a, b) -> float:
    from impersonator_tpu_torch.metrics.unpaired import matched_cosine
    return matched_cosine(a, b)


class PairedMetricRunner:
    """Frame-paired evaluation: accumulates ssim / psnr / lps, plus the
    reference's embedding-paired face-CS / OS-CS-reid and SSPE, over
    (pred, ref) batches.

    Accumulation is frame-weighted (Σ batch_mean · batch_size / Σ size),
    so videos of different lengths weigh by their frames.

    * ``lps`` needs ``lpips_apply(a, b) -> (B,)`` (``metrics.zoo.LPIPS``),
      or falls back to ``vgg`` (a net returning a feature list) for the
      unweighted distance of :func:`perceptual_distance`;
    * ``SSPE`` needs ``hmr_fn(imgs) -> (B, 85)`` θs;
    * ``face-CS`` needs ``face_fn(imgs[, bboxes])``: head boxes passed
      through :meth:`update` make the embeddings head crops;
    * ``OS-CS-reid`` needs ``reid_fn(imgs) -> (B, D)``."""

    def __init__(self, metric_types=("ssim", "psnr"), vgg=None,
                 lpips_apply=None, hmr_fn=None, face_fn=None, reid_fn=None):
        self.metric_types = list(metric_types)
        self.vgg = vgg
        self.lpips_apply = lpips_apply
        self.hmr_fn = hmr_fn
        self.face_fn = face_fn
        self.reid_fn = reid_fn
        self._sums = {m: 0.0 for m in self.metric_types}
        self._frames = 0

    def _face_embed(self, imgs, bboxes):
        from impersonator_tpu_torch.metrics.unpaired import accepts_bboxes
        if bboxes is not None and accepts_bboxes(self.face_fn):
            return self.face_fn(imgs, _as_tensor(bboxes, imgs.device))
        return self.face_fn(imgs)

    def update(self, preds, refs, pred_bboxes=None, ref_bboxes=None,
               pred_body_bboxes=None, ref_body_bboxes=None):
        """preds, refs (N, H, W, 3) in [-1, 1], tensors or arrays (refs
        go to the preds' device). ``pred_body_bboxes`` /
        ``ref_body_bboxes``: (N, 4) fractional person boxes; when given,
        OS-CS-reid embeds person crops at the re-id net's 256×128 patch
        (the reference's YOLOv3-cropped convention)."""
        preds = _as_tensor(preds)
        refs = _as_tensor(refs, preds.device)
        n = preds.shape[0]

        def reid_embed(imgs, boxes):
            if boxes is not None:
                from impersonator_tpu_torch.models.losses import (
                    crop_resize_fractional)
                imgs = crop_resize_fractional(
                    imgs, _as_tensor(boxes, imgs.device), 256, 128)
            return self.reid_fn(imgs)

        for m in self.metric_types:
            if m == "ssim":
                v = float(ssim(preds, refs))
            elif m == "psnr":
                v = float(psnr(preds, refs))
            elif m == "lps":
                if self.lpips_apply is not None:
                    v = float(torch.mean(self.lpips_apply(preds, refs)))
                else:
                    v = float(perceptual_distance(self.vgg, preds, refs))
            elif m == "SSPE":
                v = sspe_score(self.hmr_fn(preds), self.hmr_fn(refs))
            elif m == "face-CS":
                v = _paired_cosine(self._face_embed(preds, pred_bboxes),
                                   self._face_embed(refs, ref_bboxes))
            elif m == "OS-CS-reid":
                v = _paired_cosine(reid_embed(preds, pred_body_bboxes),
                                   reid_embed(refs, ref_body_bboxes))
            else:
                raise ValueError(m)
            self._sums[m] += v * n
        self._frames += n

    def merge(self, other: "PairedMetricRunner") -> None:
        """Fold another runner's sums in, so a per-video runner feeds the
        aggregate without recomputing any metric."""
        assert self.metric_types == other.metric_types
        for m in self.metric_types:
            self._sums[m] += other._sums[m]
        self._frames += other._frames

    def evaluate(self) -> dict:
        return {m: self._sums[m] / max(self._frames, 1)
                for m in self.metric_types}
