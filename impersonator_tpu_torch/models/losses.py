"""The loss stack of test-time personalisation and training (torch port of
``impersonator_tpu/models/losses.py``).

Images and masks at these functions are NHWC, as in the JAX package; the
networks (:class:`Vgg19`, the face nets of ``models/facenet.py``, HMR)
take NCHW and the transpose happens at their call. Every "stop gradient"
of the JAX functions is a ``detach`` here.

* :class:`Vgg19`, :func:`vgg_loss`, :func:`style_loss`;
* :func:`head_bbox_from_kps`, :func:`body_bbox_from_kps`,
  :func:`crop_resize_fractional`;
* :func:`face_loss_from_feats`, :func:`face_loss`;
* :func:`lsgan_loss`, :func:`tv_smooth`, :func:`l1`, :func:`bce`,
  :func:`mse`, :func:`hmr_loss`.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from impersonator_tpu_torch.models.facenet import SENet50
from impersonator_tpu_torch.ops.sampler import (grid_sample,
                                                resize_bilinear_align)

NECK_IDS = 12  # cocoplus neck index

# torchvision vgg19.features up to conv5_1's ReLU (index 29)
_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
            512, 512, 512, 512, "M", 512]
# the features the JAX package's Vgg19 returns, by conv count: the ReLUs
# of convs 1, 3, 5 and 9. (Its slice list also names conv 13, which the
# first 30 layers, convs 0..12, do not reach; the layers after conv 9
# keep their weights but add nothing to the output.)
_VGG_SLICE_CONVS = (1, 3, 5, 9)


class Vgg19(nn.Module):
    """The first 30 layers of torchvision's vgg19.features (keys
    ``features.{i}``, as ``tools/convert_weights.convert_vgg19`` reads
    them): ``forward`` returns the features after the ReLUs of
    conv1_2, conv2_2, conv3_2 and conv4_2."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for item in _VGG_CFG:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, item, 3, 1, 1), nn.ReLU()]
                cin = item
        self.features = nn.Sequential(*layers)

    def forward(self, x) -> list:
        feats, n_conv = [], 0
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.ReLU):
                if n_conv in _VGG_SLICE_CONVS:
                    feats.append(x)
                    if len(feats) == len(_VGG_SLICE_CONVS):
                        break
                n_conv += 1
        return feats


VGG_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


def vgg_loss(feats_x: Sequence, feats_y: Sequence):
    """Σ w_i · L1(x_i, y_i), y detached."""
    total = 0.0
    for w, fx, fy in zip(VGG_WEIGHTS, feats_x, feats_y):
        total = total + w * (fx - fy.detach()).abs().mean()
    return total


def _gram(feat):
    """(B, C, H, W) -> (B, C, C)."""
    m = feat.flatten(2)
    return m @ m.transpose(1, 2)


def style_loss(feats_x: Sequence, feats_y: Sequence):
    """Gram-matrix L1 over NCHW features, each divided by its spatial
    size. (Callers resize the images to 224² first.)"""
    total = 0.0
    for fx, fy in zip(feats_x, feats_y):
        h, w = fx.shape[2], fx.shape[3]
        total = total + (_gram(fx) - _gram(fy)).abs().mean() / (h * w)
    return total


FACE_H, FACE_W = 112, 96  # Sphere20a's input


def head_bbox_from_kps(kps):
    """cocoplus keypoints (B, 19, 2) in [-1, 1] -> fractional head boxes
    (B, 4 = [min_x, max_x, min_y, max_y]) in [0, 1]."""
    k = (kps + 1.0) / 2.0
    head = k[:, NECK_IDS:, :]
    min_x = (head[..., 0].amin(1) - 0.05).clamp(0.0, 1.0)
    max_x = (head[..., 0].amax(1) + 0.05).clamp(0.0, 1.0)
    min_y = (head[..., 1].amin(1) - 0.05).clamp(0.0, 1.0)
    max_y = head[..., 1].amax(1).clamp(0.0, 1.0)
    return torch.stack([min_x, max_x, min_y, max_y], dim=1)


def body_bbox_from_kps(kps, factor: float = 1.2):
    """Fractional body boxes around all keypoints, each side scaled by
    ``factor`` about its middle."""
    k = (kps + 1.0) / 2.0
    min_x, max_x = k[..., 0].amin(1), k[..., 0].amax(1)
    min_y, max_y = k[..., 1].amin(1), k[..., 1].amax(1)
    mid_x, w = (min_x + max_x) / 2, (max_x - min_x) * factor
    mid_y, h = (min_y + max_y) / 2, (max_y - min_y) * factor
    return torch.stack([(mid_x - w / 2).clamp(0.0, 1.0),
                        (mid_x + w / 2).clamp(0.0, 1.0),
                        (mid_y - h / 2).clamp(0.0, 1.0),
                        (mid_y + h / 2).clamp(0.0, 1.0)], dim=1)


def crop_resize_fractional(imgs, bbox, out_h: int, out_w: int):
    """Bilinear crops of fractional boxes (B, 4 = [x0, x1, y0, y1] in
    [0, 1]) from imgs (B, H, W, C), resized to (B, out_h, out_w, C)."""
    b = imgs.shape[0]
    x0, x1, y0, y1 = bbox.unbind(1)

    def grid_axis(a0, a1, n):
        t = torch.arange(n, dtype=torch.float32,
                         device=imgs.device) / max(n - 1, 1)
        return (a0[:, None] + t[None, :] * (a1 - a0)[:, None]) * 2.0 - 1.0

    gx = grid_axis(x0, x1, out_w)
    gy = grid_axis(y0, y1, out_h)
    grid = torch.stack([gx[:, None, :].expand(b, out_h, out_w),
                        gy[:, :, None].expand(b, out_h, out_w)], dim=-1)
    return grid_sample(imgs, grid)


def face_loss_from_feats(feats1: Sequence, feats2: Sequence):
    """Σ L1(f1_i, f2_i), f2 detached."""
    total = 0.0
    for f1, f2 in zip(feats1, feats2):
        total = total + (f1 - f2.detach()).abs().mean()
    return total


def face_loss(face_net, imgs1, imgs2, bbox1=None, bbox2=None, kps1=None,
              kps2=None):
    """Head crops (by keypoints, boxes, or the whole image resized) of
    imgs1 and imgs2 (B, H, W, 3) through the face net, L1 over its
    features. A :class:`SENet50` takes 224² crops and its stage
    features; Sphere20a 112×96 crops and all five outputs."""
    is_senet = isinstance(face_net, SENet50)
    fh, fw = (224, 224) if is_senet else (FACE_H, FACE_W)
    if kps1 is not None:
        bbox1 = head_bbox_from_kps(kps1)
    if kps2 is not None:
        bbox2 = head_bbox_from_kps(kps2)
    heads = [crop_resize_fractional(im, bb, fh, fw) if bb is not None
             else resize_bilinear_align(im, fh, fw)
             for im, bb in ((imgs1, bbox1), (imgs2, bbox2))]
    f1, f2 = (face_net(h.permute(0, 3, 1, 2)) for h in heads)
    if is_senet:
        f1, f2 = f1[0], f2[0]
    return face_loss_from_feats(f1, f2)


def lsgan_loss(pred, target: float):
    """mean((pred - target)²)."""
    return ((pred - target) ** 2).mean()


def tv_smooth(mat):
    """Total variation of an NHWC mask: mean |dx| + mean |dy|."""
    return ((mat[:, :, :-1, :] - mat[:, :, 1:, :]).abs().mean()
            + (mat[:, :-1, :, :] - mat[:, 1:, :, :]).abs().mean())


def l1(a, b):
    return (a - b).abs().mean()


def bce(pred, target, eps: float = 1e-7):
    """Binary cross-entropy of probabilities, clipped to [eps, 1 - eps]."""
    p = pred.clamp(eps, 1.0 - eps)
    return -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p)
             ).mean()


def mse(a, b):
    return ((a - b) ** 2).mean()


def hmr_loss(hmr, x, y):
    """L1 between HMR's θ of two image batches (B, 224, 224, 3), the
    second detached."""
    return (hmr(x) - hmr(y).detach()).abs().mean()
