"""MTCNN face detector (P / R / O-net cascade), torch port of
``impersonator_tpu/metrics/mtcnn.py``, with the reference's released
weights (``impersonator_tpu/weights/mtcnn_pro.msgpack``, read by
:func:`load_mtcnn`).

The three nets are NCHW modules run on the device in float32 without
TF32; the cascade between them (image pyramid, NMS, box algebra) is host
NumPy, copied from the JAX package: detection runs offline at metric time
on a few frames, and the box bookkeeping has dynamic shapes.

Quirks kept so the released weights load exactly:

* every conv is unpadded and every pool ceil-mode;
* per-channel PReLU everywhere, after the dense layers too;
* RNet / ONet flatten their conv features in torch's
  ``permute(0, 3, 2, 1)`` order, (B, C, H, W) -> (B, W, H, C);
* PNet's prob head softmaxes over the channels.

State-dict keys are facenet-pytorch's (``conv1``, ``prelu1``,
``conv4_1``, ``dense5_1``, …).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from impersonator_tpu_torch.models.facenet import PReLU
from impersonator_tpu_torch.utils.precision import full_fp32


def _pool(x, k: int, s: int):
    return F.max_pool2d(x, k, s, ceil_mode=True)


class PNet(nn.Module):
    """Proposal net: a fully convolutional 12×12 scanner. (B, 3, H, W)
    normalised -> (reg (B, 4, h, w), prob (B, 2, h, w) softmaxed)."""

    def __init__(self):
        super().__init__()
        self.conv1, self.prelu1 = nn.Conv2d(3, 10, 3), PReLU(10)
        self.conv2, self.prelu2 = nn.Conv2d(10, 16, 3), PReLU(16)
        self.conv3, self.prelu3 = nn.Conv2d(16, 32, 3), PReLU(32)
        self.conv4_1 = nn.Conv2d(32, 2, 1)
        self.conv4_2 = nn.Conv2d(32, 4, 1)

    def forward(self, x):
        x = _pool(self.prelu1(self.conv1(x)), 2, 2)
        x = self.prelu3(self.conv3(self.prelu2(self.conv2(x))))
        return self.conv4_2(x), torch.softmax(self.conv4_1(x), dim=1)


def _flatten_wh(x):
    """torch's (B, C, H, W).permute(0, 3, 2, 1) flatten."""
    return x.permute(0, 3, 2, 1).reshape(x.shape[0], -1)


class RNet(nn.Module):
    """Refine net: (B, 3, 24, 24) -> (reg (B, 4), prob (B, 2))."""

    def __init__(self):
        super().__init__()
        self.conv1, self.prelu1 = nn.Conv2d(3, 28, 3), PReLU(28)
        self.conv2, self.prelu2 = nn.Conv2d(28, 48, 3), PReLU(48)
        self.conv3, self.prelu3 = nn.Conv2d(48, 64, 2), PReLU(64)
        self.dense4, self.prelu4 = nn.Linear(576, 128), PReLU(128)
        self.dense5_1 = nn.Linear(128, 2)
        self.dense5_2 = nn.Linear(128, 4)

    def forward(self, x):
        x = _pool(self.prelu1(self.conv1(x)), 3, 2)
        x = _pool(self.prelu2(self.conv2(x)), 3, 2)
        x = _flatten_wh(self.prelu3(self.conv3(x)))
        x = self.prelu4(self.dense4(x))
        return self.dense5_2(x), torch.softmax(self.dense5_1(x), dim=-1)


class ONet(nn.Module):
    """Output net: (B, 3, 48, 48) -> (reg (B, 4), landmarks (B, 10),
    prob (B, 2))."""

    def __init__(self):
        super().__init__()
        self.conv1, self.prelu1 = nn.Conv2d(3, 32, 3), PReLU(32)
        self.conv2, self.prelu2 = nn.Conv2d(32, 64, 3), PReLU(64)
        self.conv3, self.prelu3 = nn.Conv2d(64, 64, 3), PReLU(64)
        self.conv4, self.prelu4 = nn.Conv2d(64, 128, 2), PReLU(128)
        self.dense5, self.prelu5 = nn.Linear(1152, 256), PReLU(256)
        self.dense6_1 = nn.Linear(256, 2)
        self.dense6_2 = nn.Linear(256, 4)
        self.dense6_3 = nn.Linear(256, 10)

    def forward(self, x):
        x = _pool(self.prelu1(self.conv1(x)), 3, 2)
        x = _pool(self.prelu2(self.conv2(x)), 3, 2)
        x = _pool(self.prelu3(self.conv3(x)), 2, 2)
        x = _flatten_wh(self.prelu4(self.conv4(x)))
        x = self.prelu5(self.dense5(x))
        return (self.dense6_2(x), self.dense6_3(x),
                torch.softmax(self.dense6_1(x), dim=-1))


# ---------------------------------------------------------------------------
# Host-side cascade helpers (NumPy; detect_face.py formulas)
# ---------------------------------------------------------------------------


def area_resize(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """torch ``F.interpolate(mode='area')`` (adaptive average pooling) of
    (B, H, W, C) floats: output (i, j) averages input rows [floor(i·H/oh),
    ceil((i+1)·H/oh)) × the matching columns, through float64 integral
    images (a float32 cumsum over a 255-scale image quantises at ~0.06,
    enough to move PNet scores at the threshold)."""
    b, h, w, c = img.shape
    if (h, w) == (oh, ow):
        return img
    csum = np.zeros((b, h + 1, w + 1, c), np.float64)
    csum[:, 1:, 1:] = img.astype(np.float64).cumsum(1).cumsum(2)
    y0 = (np.arange(oh) * h) // oh
    y1 = -((-(np.arange(oh) + 1) * h) // oh)   # ceil((i+1)*h/oh)
    x0 = (np.arange(ow) * w) // ow
    x1 = -((-(np.arange(ow) + 1) * w) // ow)
    area = ((y1 - y0)[:, None] * (x1 - x0)[None, :]).astype(np.float64)
    out = (csum[:, y1[:, None], x1[None, :]] - csum[:, y1[:, None], x0[None, :]]
           - csum[:, y0[:, None], x1[None, :]] + csum[:, y0[:, None], x0[None, :]])
    return (out / area[None, ..., None]).astype(img.dtype)


def _nms(boxes: np.ndarray, scores: np.ndarray, thr: float,
         method: str = "union") -> np.ndarray:
    """Greedy NMS with +1 box widths ("union" IoU or "min" overlap)."""
    if boxes.size == 0:
        return np.zeros((0,), np.int64)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = np.argsort(scores)
    keep = []
    while order.size > 0:
        i = order[-1]
        keep.append(i)
        rest = order[:-1]
        iw = np.maximum(
            0.0, np.minimum(x2[i], x2[rest]) - np.maximum(x1[i], x1[rest]) + 1)
        ih = np.maximum(
            0.0, np.minimum(y2[i], y2[rest]) - np.maximum(y1[i], y1[rest]) + 1)
        inter = iw * ih
        if method == "min":
            o = inter / np.minimum(area[i], area[rest])
        else:
            o = inter / (area[i] + area[rest] - inter)
        order = rest[o <= thr]
    return np.asarray(keep, np.int64)


def _batched_nms(boxes, scores, idxs, thr, method="union"):
    """Per-group NMS by offsetting each group's coordinates apart."""
    if boxes.size == 0:
        return np.zeros((0,), np.int64)
    off = idxs.astype(boxes.dtype) * (boxes.max() + 1)
    return _nms(boxes + off[:, None], scores, thr, method)


def _bbreg(boxes, reg):
    """Apply the nets' box regression."""
    w = boxes[:, 2] - boxes[:, 0] + 1
    h = boxes[:, 3] - boxes[:, 1] + 1
    out = boxes.copy()
    out[:, 0] = boxes[:, 0] + reg[:, 0] * w
    out[:, 1] = boxes[:, 1] + reg[:, 1] * h
    out[:, 2] = boxes[:, 2] + reg[:, 2] * w
    out[:, 3] = boxes[:, 3] + reg[:, 3] * h
    return out


def _rerec(boxes):
    """Expand boxes to squares about their centres."""
    h = boxes[:, 3] - boxes[:, 1]
    w = boxes[:, 2] - boxes[:, 0]
    side = np.maximum(w, h)
    out = boxes.copy()
    out[:, 0] = boxes[:, 0] + w * 0.5 - side * 0.5
    out[:, 1] = boxes[:, 1] + h * 0.5 - side * 0.5
    out[:, 2] = out[:, 0] + side
    out[:, 3] = out[:, 1] + side
    return out


def _pad(boxes, w, h):
    """Truncate and clamp crop coordinates, 1-based."""
    b = np.trunc(boxes[:, :4]).astype(np.int64)
    x, y, ex, ey = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    return (np.clip(y, 1, None), np.clip(ey, None, h),
            np.clip(x, 1, None), np.clip(ex, None, w))


def _normalize(x):
    return (x - 127.5) * 0.0078125


class MTCNNDetector:
    """The cascade over ``nets`` = {"pnet", "rnet", "onet"} modules, which
    run on their parameters' device.

    Stage-2 / 3 batches are padded to multiples of 16, so the nets see a
    few fixed shapes. As in the JAX package, boxes whose padded crop
    collapses to zero pixels are dropped (the reference's loop skips the
    crop but keeps the box row, misaligning crops and scores)."""

    def __init__(self, nets: dict, min_face_size: int = 20,
                 thresholds=(0.6, 0.7, 0.7), factor: float = 0.709):
        self.nets = {k: nets[k].eval().requires_grad_(False)
                     for k in ("pnet", "rnet", "onet")}
        self.device = next(self.nets["pnet"].parameters()).device
        self.min_face_size = min_face_size
        self.thresholds = tuple(thresholds)
        self.factor = factor

    def _run(self, name, data: np.ndarray):
        """NHWC float32 host batch -> the net's outputs as host arrays
        (NCHW maps back to NHWC)."""
        x = torch.from_numpy(np.ascontiguousarray(data)).to(self.device)
        with torch.no_grad(), full_fp32():
            outs = self.nets[name](x.permute(0, 3, 1, 2))
        return tuple((o.permute(0, 2, 3, 1) if o.ndim == 4 else o)
                     .float().cpu().numpy() for o in outs)

    # -- stages ----------------------------------------------------------

    def _scales(self, h, w):
        m = 12.0 / self.min_face_size
        minl = min(h, w) * m
        scales, s = [], m
        while minl >= 12:
            scales.append(s)
            s *= self.factor
            minl *= self.factor
        return scales

    def _stage1(self, imgs):
        b, h, w, _ = imgs.shape
        boxes, image_inds, group = [], [], []
        for gi, scale in enumerate(self._scales(h, w)):
            sh, sw = int(h * scale + 1), int(w * scale + 1)
            reg, prob = self._run("pnet",
                                  _normalize(area_resize(imgs, sh, sw)))
            prob = prob[..., 1]
            # generateBoundingBox: stride 2, cell 12, 1-based corners
            bi, yi, xi = np.nonzero(prob >= self.thresholds[0])
            if bi.size == 0:
                continue
            score = prob[bi, yi, xi]
            r = reg[bi, yi, xi]                      # (n, 4)
            cell = np.stack([xi, yi], axis=1).astype(np.float64)
            q1 = np.floor((2.0 * cell + 1.0) / scale)
            q2 = np.floor((2.0 * cell + 12.0) / scale)
            boxes.append(np.concatenate(
                [q1, q2, score[:, None], r], axis=1).astype(np.float32))
            image_inds.append(bi)
            group.append(bi + gi * b)     # (scale, image) NMS groups
        if not boxes:
            return (np.zeros((0, 5), np.float32),
                    np.zeros((0,), np.int64))
        boxes = np.concatenate(boxes)
        image_inds = np.concatenate(image_inds).astype(np.int64)
        group = np.concatenate(group).astype(np.int64)

        pick = _batched_nms(boxes[:, :4], boxes[:, 4], group, 0.5)
        boxes, image_inds = boxes[pick], image_inds[pick]
        pick = _batched_nms(boxes[:, :4], boxes[:, 4], image_inds, 0.7)
        boxes, image_inds = boxes[pick], image_inds[pick]

        # fold PNet's regression in
        regw = boxes[:, 2] - boxes[:, 0]
        regh = boxes[:, 3] - boxes[:, 1]
        out = np.stack([boxes[:, 0] + boxes[:, 5] * regw,
                        boxes[:, 1] + boxes[:, 6] * regh,
                        boxes[:, 2] + boxes[:, 7] * regw,
                        boxes[:, 3] + boxes[:, 8] * regh,
                        boxes[:, 4]], axis=1)
        return _rerec(out), image_inds

    def _crops(self, imgs, boxes, image_inds, size):
        """Crop and area-resize each padded box; returns (data, keep)."""
        _, h, w, _ = imgs.shape
        y, ey, x, ex = _pad(boxes, w, h)
        keep = (ey > y - 1) & (ex > x - 1)
        data = np.zeros((int(keep.sum()), size, size, 3), np.float32)
        for j, k in enumerate(np.nonzero(keep)[0]):
            crop = imgs[image_inds[k], y[k] - 1:ey[k], x[k] - 1:ex[k]]
            data[j] = area_resize(crop[None].astype(np.float32),
                                  size, size)[0]
        return data, keep

    def _run_padded(self, name, data):
        """The net on the box batch padded to a multiple of 16."""
        n = data.shape[0]
        npad = -n % 16
        if npad:
            data = np.concatenate(
                [data, np.zeros((npad,) + data.shape[1:], data.dtype)])
        return tuple(o[:n] for o in self._run(name, _normalize(data)))

    # -- public API --------------------------------------------------------

    def detect(self, imgs: np.ndarray):
        """imgs (B, H, W, 3) RGB uint8 (or float in [0, 255]) -> per image
        an (n, 5) float32 array of [x1, y1, x2, y2, score] and an (n, 5,
        2) landmark array (the reference's detect_face contract)."""
        imgs = np.asarray(imgs)
        if imgs.ndim == 3:
            imgs = imgs[None]
        b = imgs.shape[0]
        imgs_f = imgs.astype(np.float32)

        boxes, image_inds = self._stage1(imgs_f)
        points = np.zeros((0, 5, 2), np.float32)

        if len(boxes) > 0:                         # stage 2 (RNet)
            data, keep = self._crops(imgs_f, boxes, image_inds, 24)
            boxes, image_inds = boxes[keep], image_inds[keep]
            reg, prob = self._run_padded("rnet", data)
            score = prob[:, 1]
            ipass = score > self.thresholds[1]
            boxes = np.concatenate(
                [boxes[ipass, :4], score[ipass, None]], axis=1)
            image_inds, reg = image_inds[ipass], reg[ipass]
            pick = _batched_nms(boxes[:, :4], boxes[:, 4], image_inds, 0.7)
            boxes, image_inds, reg = boxes[pick], image_inds[pick], reg[pick]
            boxes = _rerec(_bbreg(boxes, reg))

        if len(boxes) > 0:                         # stage 3 (ONet)
            data, keep = self._crops(imgs_f, boxes, image_inds, 48)
            boxes, image_inds = boxes[keep], image_inds[keep]
            reg, pts, prob = self._run_padded("onet", data)
            score = prob[:, 1]
            ipass = score > self.thresholds[2]
            pts = pts[ipass]
            boxes = np.concatenate(
                [boxes[ipass, :4], score[ipass, None]], axis=1)
            image_inds, reg = image_inds[ipass], reg[ipass]
            # landmarks in image coordinates
            w_i = boxes[:, 2] - boxes[:, 0] + 1
            h_i = boxes[:, 3] - boxes[:, 1] + 1
            px = w_i[:, None] * pts[:, :5] + boxes[:, 0:1] - 1
            py = h_i[:, None] * pts[:, 5:10] + boxes[:, 1:2] - 1
            points = np.stack([px, py], axis=2)
            boxes = _bbreg(boxes, reg)
            pick = _batched_nms(boxes[:, :4], boxes[:, 4], image_inds,
                                0.7, method="min")
            boxes, image_inds, points = (boxes[pick], image_inds[pick],
                                         points[pick])

        return ([boxes[image_inds == i].copy() for i in range(b)],
                [points[image_inds == i].copy() for i in range(b)])

    def head_bboxes(self, imgs: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) uint8 -> (B, 4) fractional [x0, x1, y0, y1] head
        boxes (the crop helpers' layout); an image with no detection gets
        the whole frame, as the reference runner falls back."""
        imgs = np.asarray(imgs)
        b, h, w, _ = imgs.shape
        boxes, _ = self.detect(imgs)
        out = np.tile(np.asarray([0.0, 1.0, 0.0, 1.0], np.float32), (b, 1))
        for i, bx in enumerate(boxes):
            if len(bx):
                best = bx[np.argmax(bx[:, 4])]
                out[i] = [max(best[0] / w, 0.0), min(best[2] / w, 1.0),
                          max(best[1] / h, 0.0), min(best[3] / h, 1.0)]
        return out


def load_mtcnn(path: str, device="cuda", **kw) -> MTCNNDetector:
    """An MTCNN msgpack of the JAX package ({'pnet', 'rnet', 'onet'}, each
    {'params'}) -> a detector with its nets on ``device``."""
    from impersonator_tpu_torch.utils.checkpoint import read_flax_msgpack
    from impersonator_tpu_torch.utils.convert import (
        mtcnn_state_dicts_from_jax)
    nets = {"pnet": PNet(), "rnet": RNet(), "onet": ONet()}
    sds = mtcnn_state_dicts_from_jax(read_flax_msgpack(path))
    for name, sd in sds.items():
        nets[name].load_state_dict(sd, strict=True)
        nets[name].to(device)
    return MTCNNDetector(nets, **kw)
