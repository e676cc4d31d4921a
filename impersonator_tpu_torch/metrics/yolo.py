"""YOLOv3-SPP person detector, the reference evaluator's body localiser
(torch port of ``impersonator_tpu/metrics/yolo.py``).

* :func:`parse_darknet_cfg` / :func:`build_layers` turn a darknet cfg
  into a static layer spec (the reference's ``config/yolov3-spp.cfg``,
  or any cfg of the same layer types);
* :func:`load_darknet_weights` reads the darknet ``.weights`` binary
  (5 int32 header words, then per conv layer [bn_bias, bn_gamma,
  bn_mean, bn_var] or a bias, and the OIHW kernel, all float32) with
  BatchNorm folded into the convs: ``w' = w·g/sqrt(var + eps)``,
  ``b' = beta - mean·g/sqrt(var + eps)``;
* :func:`darknet_apply` runs the spec on the device (NCHW, float32
  without TF32) and decodes the YOLO heads there;
* :func:`non_max_suppression` (the reference's weighted-merge NMS) and
  :class:`YoloHumanDetector`'s largest-person pick are host NumPy.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from impersonator_tpu_torch.utils.precision import full_fp32


# ---------------------------------------------------------------------------
# cfg parsing -> static layer spec
# ---------------------------------------------------------------------------


def parse_darknet_cfg(path: str) -> list[dict]:
    """Darknet cfg -> list of {type, **options} dicts; the leading [net]
    block is layers[0]."""
    blocks: list[dict] = []
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith("["):
                blocks.append({"type": line.strip("[]").strip()})
                if blocks[-1]["type"] == "convolutional":
                    blocks[-1]["batch_normalize"] = "0"
            else:
                k, v = line.split("=", 1)
                blocks[-1][k.strip()] = v.strip()
    return blocks


def build_layers(defs: list[dict]) -> list[dict]:
    """Parsed blocks -> a typed static spec with resolved channel counts;
    defs[0] must be the [net] block."""
    net, body = defs[0], defs[1:]
    channels = [int(net.get("channels", 3))]
    layers = []
    for i, d in enumerate(body):
        t = d["type"]
        ld = {"type": t, "index": i}
        if t == "convolutional":
            ld.update(bn=int(d["batch_normalize"]),
                      filters=int(d["filters"]), size=int(d["size"]),
                      stride=int(d["stride"]),
                      pad=(int(d["size"]) - 1) // 2,
                      leaky=d["activation"] == "leaky",
                      in_ch=channels[-1])
            channels.append(ld["filters"])
        elif t == "maxpool":
            ld.update(size=int(d["size"]), stride=int(d["stride"]))
            channels.append(channels[-1])
        elif t == "upsample":
            ld.update(stride=int(d["stride"]))
            channels.append(channels[-1])
        elif t == "route":
            idx = [int(x) for x in d["layers"].split(",")]
            ld.update(layers=idx)
            channels.append(sum(channels[1:][j] for j in idx))
        elif t == "shortcut":
            ld.update(frm=int(d["from"]))
            channels.append(channels[1:][int(d["from"])])
        elif t == "yolo":
            mask = [int(x) for x in d["mask"].split(",")]
            a = [int(x) for x in d["anchors"].split(",")]
            anchors = [(a[j], a[j + 1]) for j in range(0, len(a), 2)]
            ld.update(anchors=tuple(anchors[j] for j in mask),
                      classes=int(d["classes"]))
            channels.append(channels[-1])
        else:
            raise ValueError(f"unknown darknet layer type {t!r}")
        layers.append(ld)
    return layers


# ---------------------------------------------------------------------------
# darknet binary -> folded conv weights
# ---------------------------------------------------------------------------


def load_darknet_weights(layers: list[dict], path: str,
                         eps: float = 1e-5) -> dict:
    """A darknet ``.weights`` file -> {conv{i}: {"weight" OIHW, "bias"}}
    float32 host arrays with BatchNorm folded in (torch BN eps 1e-5)."""
    with open(path, "rb") as f:
        np.fromfile(f, dtype=np.int32, count=5)         # header
        w = np.fromfile(f, dtype=np.float32)
    params, ptr = {}, 0

    def take(n):
        nonlocal ptr
        out = w[ptr:ptr + n]
        if out.size != n:
            raise ValueError(f"darknet weights file truncated at {ptr}")
        ptr += n
        return out

    for ld in layers:
        if ld["type"] != "convolutional":
            continue
        c_out, c_in, k = ld["filters"], ld["in_ch"], ld["size"]
        if ld["bn"]:
            beta = take(c_out)
            gamma = take(c_out)
            mean = take(c_out)
            var = take(c_out)
            scale = gamma / np.sqrt(var + eps)
            bias = beta - mean * scale
        else:
            bias = take(c_out)
            scale = np.ones(c_out, np.float32)
        kern = take(c_out * c_in * k * k).reshape(c_out, c_in, k, k)
        params[f"conv{ld['index']}"] = {
            "weight": np.ascontiguousarray(kern * scale[:, None, None, None]),
            "bias": bias.astype(np.float32)}
    if ptr != w.size:
        raise ValueError(f"darknet weights file has {w.size - ptr} "
                         "unread floats — cfg/weights mismatch")
    return params


def expected_weight_count(layers: list[dict]) -> int:
    """Float count a matching ``.weights`` payload must have."""
    n = 0
    for ld in layers:
        if ld["type"] != "convolutional":
            continue
        n += ld["filters"] * (4 if ld["bn"] else 1)
        n += ld["filters"] * ld["in_ch"] * ld["size"] ** 2
    return n


# ---------------------------------------------------------------------------
# the graph
# ---------------------------------------------------------------------------


def _decode_yolo(x, anchors, num_classes, img_dim):
    """(B, A·(5+C), g, g) head -> (B, A·g·g, 5+C) with boxes in input
    pixels (cx, cy, w, h): sigmoid xy + the cell, exp wh × the anchors
    (cfg-native pixels), sigmoid objectness and classes."""
    b, g = x.shape[0], x.shape[2]
    na = len(anchors)
    stride = img_dim / g
    p = x.reshape(b, na, 5 + num_classes, g, g).permute(0, 1, 3, 4, 2)
    ar = torch.arange(g, dtype=x.dtype, device=x.device)
    gy, gx = torch.meshgrid(ar, ar, indexing="ij")
    aw = x.new_tensor([a[0] for a in anchors])[None, :, None, None]
    ah = x.new_tensor([a[1] for a in anchors])[None, :, None, None]
    cx = (torch.sigmoid(p[..., 0]) + gx) * stride
    cy = (torch.sigmoid(p[..., 1]) + gy) * stride
    w = torch.exp(p[..., 2]) * aw
    h = torch.exp(p[..., 3]) * ah
    rest = torch.sigmoid(p[..., 4:])
    out = torch.cat([torch.stack([cx, cy, w, h], dim=-1), rest], dim=-1)
    return out.reshape(b, na * g * g, 5 + num_classes)


def darknet_apply(layers: list[dict], params: dict, x: torch.Tensor):
    """Run the spec on x (B, 3, H, W) in [0, 1] (``params`` tensors on x's
    device) -> (B, N, 5+C) decoded detections."""
    img_dim = x.shape[2]
    outs, dets = [], []
    for ld in layers:
        t = ld["type"]
        if t == "convolutional":
            p = params[f"conv{ld['index']}"]
            x = F.conv2d(x, p["weight"], p["bias"], ld["stride"], ld["pad"])
            if ld["leaky"]:
                x = torch.where(x > 0, x, 0.1 * x)
        elif t == "maxpool":
            k, s = ld["size"], ld["stride"]
            if k == 2 and s == 1:
                # the reference's ZeroPad2d((0, 1, 0, 1)): the pad value
                # is zero, so negative edge activations clamp to it
                x = F.max_pool2d(F.pad(x, (0, 1, 0, 1)), 2, 1)
            else:
                x = F.max_pool2d(x, k, s, (k - 1) // 2)
        elif t == "upsample":
            s = ld["stride"]
            x = x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
        elif t == "route":
            x = torch.cat([outs[j] for j in ld["layers"]], dim=1)
        elif t == "shortcut":
            x = outs[-1] + outs[ld["frm"]]
        elif t == "yolo":
            x = _decode_yolo(x, ld["anchors"], ld["classes"], img_dim)
            dets.append(x)
        outs.append(x)
    return torch.cat(dets, dim=1)


# ---------------------------------------------------------------------------
# host-side suppression + person selection
# ---------------------------------------------------------------------------


def _xywh2xyxy(b):
    out = np.empty_like(b)
    out[:, 0] = b[:, 0] - b[:, 2] / 2
    out[:, 1] = b[:, 1] - b[:, 3] / 2
    out[:, 2] = b[:, 0] + b[:, 2] / 2
    out[:, 3] = b[:, 1] + b[:, 3] / 2
    return out


def _iou_xyxy(box, boxes):
    ix1 = np.maximum(box[0], boxes[:, 0])
    iy1 = np.maximum(box[1], boxes[:, 1])
    ix2 = np.minimum(box[2], boxes[:, 2])
    iy2 = np.minimum(box[3], boxes[:, 3])
    inter = (np.clip(ix2 - ix1 + 1, 0, None)
             * np.clip(iy2 - iy1 + 1, 0, None))
    a0 = (box[2] - box[0] + 1) * (box[3] - box[1] + 1)
    a1 = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    return inter / (a0 + a1 - inter + 1e-16)


def non_max_suppression(pred: np.ndarray, conf_thres: float = 0.5,
                        nms_thres: float = 0.4) -> list:
    """Weighted-merge NMS: same-class boxes above the IoU threshold merge,
    weighted by objectness, instead of being dropped. pred (B, N, 5+C)
    -> per image an (n, 7) array [x1, y1, x2, y2, obj, cls_conf, cls] or
    None."""
    output = []
    for image_pred in pred:
        image_pred = image_pred[image_pred[:, 4] >= conf_thres]
        if not image_pred.shape[0]:
            output.append(None)
            continue
        boxes = _xywh2xyxy(image_pred[:, :4])
        cls_conf = image_pred[:, 5:].max(1)
        cls_pred = image_pred[:, 5:].argmax(1).astype(np.float32)
        score = image_pred[:, 4] * cls_conf
        order = (-score).argsort(kind="stable")
        det = np.concatenate(
            [boxes, image_pred[:, 4:5], cls_conf[:, None],
             cls_pred[:, None]], axis=1)[order]
        keep = []
        while det.shape[0]:
            invalid = ((_iou_xyxy(det[0, :4], det[:, :4]) > nms_thres)
                       & (det[:, 6] == det[0, 6]))
            wts = det[invalid, 4:5]
            merged = det[0].copy()
            merged[:4] = (wts * det[invalid, :4]).sum(0) / wts.sum()
            keep.append(merged)
            det = det[~invalid]
        output.append(np.stack(keep))
    return output


class YoloHumanDetector:
    """Largest-person selection over the darknet graph: per image an
    enlarged, clipped (x1, y1, x2, y2) in input pixels, or None when no
    person clears the confidence threshold."""

    PERSON = 0                                   # COCO class id

    def __init__(self, cfg_path: str, weights_path: str,
                 conf_thres: float = 0.8, nms_thres: float = 0.4,
                 device="cuda"):
        self.layers = build_layers(parse_darknet_cfg(cfg_path))
        self.device = torch.device(device)
        self.params = {
            name: {k: torch.from_numpy(v).to(self.device)
                   for k, v in p.items()}
            for name, p in load_darknet_weights(self.layers,
                                                weights_path).items()}
        self.conf_thres = conf_thres
        self.nms_thres = nms_thres

    def _apply(self, imgs) -> np.ndarray:
        x = torch.as_tensor(imgs, dtype=torch.float32, device=self.device)
        with torch.no_grad(), full_fp32():
            pred = darknet_apply(self.layers, self.params,
                                 x.permute(0, 3, 1, 2))
        return pred.cpu().numpy()

    def detect(self, imgs, factor: float = 1.05) -> list:
        """imgs (B, H, W, 3) in [0, 1], H == W a multiple of 32."""
        b, h, w, _ = imgs.shape
        dets = non_max_suppression(self._apply(imgs), self.conf_thres,
                                   self.nms_thres)
        out = []
        for d in dets:
            if d is None:
                out.append(None)
                continue
            persons = d[d[:, 6] == self.PERSON]
            if not persons.shape[0]:
                out.append(None)
                continue
            areas = ((persons[:, 2] - persons[:, 0])
                     * (persons[:, 3] - persons[:, 1]))
            x1, y1, x2, y2 = persons[areas.argmax(), :4]
            # enlarge by ``factor`` about the centre, clip to the frame
            cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
            bw, bh = (x2 - x1) * factor / 2, (y2 - y1) * factor / 2
            out.append((float(np.clip(cx - bw, 0, w - 1)),
                        float(np.clip(cy - bh, 0, h - 1)),
                        float(np.clip(cx + bw, 0, w - 1)),
                        float(np.clip(cy + bh, 0, h - 1))))
        return out

    def body_bboxes(self, imgs) -> np.ndarray:
        """[-1, 1] frames (tensor or array) -> (B, 4) fractional [x0, x1,
        y0, y1] body boxes (the SMPL body-box layout); a frame with no
        detection gets the whole frame, as the reference runner falls
        back."""
        imgs = torch.as_tensor(imgs, dtype=torch.float32)
        b, h, w, _ = imgs.shape
        boxes = self.detect((imgs + 1.0) * 0.5)
        out = np.tile(np.asarray([0.0, 1.0, 0.0, 1.0], np.float32), (b, 1))
        for i, bx in enumerate(boxes):
            if bx is not None:
                out[i] = [max(bx[0] / w, 0.0), min(bx[2] / w, 1.0),
                          max(bx[1] / h, 0.0), min(bx[3] / h, 1.0)]
        return out
