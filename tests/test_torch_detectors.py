"""The port's detectors against the JAX package's on the CPU: MTCNN
(``metrics/mtcnn.py``) with the repository's released P / R / O-net
weights read through the port's converter, its host-side resample, NMS
and box algebra on seeded boxes, and the whole cascade on seeded frames;
YOLO (``metrics/yolo.py``) on a tiny darknet cfg covering every layer
type with a seeded weight file the test writes, its weighted-merge NMS
and the person pick."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impersonator_tpu.metrics import mtcnn as JMt
from impersonator_tpu.metrics import yolo as JY
from impersonator_tpu_torch.metrics import mtcnn as TMt
from impersonator_tpu_torch.metrics import yolo as TY
from impersonator_tpu_torch.scenes import face_image
from impersonator_tpu_torch.utils import convert

from torch_threads import one_torch_thread  # noqa: F401

SHIPPED = os.path.join(os.path.dirname(__file__), "..", "impersonator_tpu",
                       "weights", "mtcnn_pro.msgpack")


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.fixture(scope="module")
def detectors():
    """(port, JAX) MTCNN detectors on the repository's weights."""
    return (TMt.load_mtcnn(SHIPPED, device="cpu"), JMt.load_mtcnn(SHIPPED))


def test_mtcnn_nets_match_jax(detectors):
    """P / R / O-net outputs on seeded inputs within 1e-4 of JAX's largest
    magnitude; the probabilities sum to 1."""
    port, ref = detectors
    rng = np.random.default_rng(31)
    for name, shape, jnet in (("pnet", (2, 30, 26, 3), ref._pnet),
                              ("rnet", (3, 24, 24, 3), ref._rnet),
                              ("onet", (3, 48, 48, 3), ref._onet)):
        x = rng.uniform(-1, 1, shape).astype(np.float32)
        got, want = port._run(name, x), jnet(jnp.asarray(x))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert _rel(g, w) <= 1e-4, name
        np.testing.assert_allclose(got[-1].sum(-1), 1.0, atol=1e-5)


def test_area_resize_nms_and_box_algebra_match_jax():
    """area_resize, greedy NMS (union and min), batched NMS, the box
    regression, the square expansion and the crop padding equal JAX's on
    seeded boxes."""
    rng = np.random.default_rng(32)
    x = rng.uniform(0, 255, (2, 63, 50, 3)).astype(np.float32)
    for oh, ow in ((38, 31), (12, 12), (63, 50), (7, 5)):
        np.testing.assert_array_equal(TMt.area_resize(x, oh, ow),
                                      JMt.area_resize(x, oh, ow))
    xy = rng.uniform(0, 80, (40, 2))
    wh = rng.uniform(5, 40, (40, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = rng.uniform(0, 1, 40).astype(np.float32)
    idxs = rng.integers(0, 3, 40)
    for thr in (0.3, 0.5, 0.7):
        for method in ("union", "min"):
            np.testing.assert_array_equal(
                TMt._nms(boxes, scores, thr, method),
                JMt._nms(boxes, scores, thr, method))
            np.testing.assert_array_equal(
                TMt._batched_nms(boxes, scores, idxs, thr, method),
                JMt._batched_nms(boxes, scores, idxs, thr, method))
    assert TMt._nms(boxes[:0], scores[:0], 0.5).shape == (0,)
    reg = rng.normal(0, 0.1, (40, 4)).astype(np.float32)
    np.testing.assert_array_equal(TMt._bbreg(boxes, reg),
                                  JMt._bbreg(boxes, reg))
    np.testing.assert_array_equal(TMt._rerec(boxes), JMt._rerec(boxes))
    for a, b in zip(TMt._pad(boxes, 70, 60), JMt._pad(boxes, 70, 60)):
        np.testing.assert_array_equal(a, b)


def test_mtcnn_cascade_matches_jax(detectors):
    """detect and head_bboxes on three 96×80 frames, two with a drawn
    face (``scenes.face_image``) and one of noise: the same boxes per
    frame with coordinates within 0.5 px and scores within 1e-4,
    landmarks within 0.5 px; the frame with no box gets the whole frame
    in head_bboxes."""
    port, ref = detectors
    imgs = np.stack([face_image(96, 80, 40, 45, 24, seed=1),
                     face_image(96, 80, 36, 50, 30, seed=2),
                     np.random.default_rng(33).uniform(0, 255, (96, 80, 3))
                     .astype(np.uint8)])
    boxes_t, pts_t = port.detect(imgs)
    boxes_j, pts_j = ref.detect(imgs)
    assert [len(b) for b in boxes_j] == [1, 1, 0]
    for bt, bj, pt, pj in zip(boxes_t, boxes_j, pts_t, pts_j):
        assert bt.shape == bj.shape
        if len(bj):
            assert np.abs(bt[:, :4] - bj[:, :4]).max() <= 0.5
            assert np.abs(bt[:, 4] - bj[:, 4]).max() <= 1e-4
            assert np.abs(pt - pj).max() <= 0.5
    heads = port.head_bboxes(imgs)
    np.testing.assert_allclose(heads, ref.head_bboxes(imgs), atol=0.5 / 80)
    np.testing.assert_array_equal(heads[2], [0.0, 1.0, 0.0, 1.0])


TINY_CFG = """
[net]
channels=3
height=64
width=64

[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky

[shortcut]
from=-2
activation=linear

[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky

[maxpool]
size=2
stride=1

[maxpool]
size=5
stride=1

[route]
layers=-1,-2

[convolutional]
filters=18
size=1
stride=1
pad=1
activation=linear

[yolo]
mask=0,1
anchors=10,14, 23,27, 37,58
classes=4

[route]
layers=3

[upsample]
stride=2

[convolutional]
filters=27
size=1
stride=1
pad=1
activation=linear

[yolo]
mask=0,1,2
anchors=10,14, 23,27, 37,58
classes=4
"""


@pytest.fixture
def tiny(tmp_path):
    """The tiny cfg (conv with and without BN, both maxpool kinds, a
    shortcut, a multi and an absolute route, an upsample, two YOLO heads)
    and a seeded weight file in darknet's layout."""
    rng = np.random.default_rng(34)
    cfg = tmp_path / "tiny.cfg"
    cfg.write_text(TINY_CFG)
    layers = TY.build_layers(TY.parse_darknet_cfg(str(cfg)))
    chunks = []
    for ld in layers:
        if ld["type"] != "convolutional":
            continue
        co, ci, k = ld["filters"], ld["in_ch"], ld["size"]
        if ld["bn"]:
            chunks += [rng.normal(0, 0.1, co), rng.uniform(0.5, 1.5, co),
                       rng.normal(0, 0.1, co), rng.uniform(0.5, 1.5, co)]
        else:
            chunks.append(rng.normal(0, 0.1, co))
        chunks.append(rng.standard_normal(co * ci * k * k)
                      / np.sqrt(ci * k * k))
    buf = np.concatenate(chunks).astype(np.float32)
    wfile = tmp_path / "tiny.weights"
    with open(wfile, "wb") as f:
        np.zeros(5, np.int32).tofile(f)
        buf.tofile(f)
    return str(cfg), str(wfile), buf


def test_darknet_cfg_weights_and_graph_match_jax(tiny):
    """The parsed spec and its weight count equal JAX's; the folded
    weights equal JAX's through ``darknet_params_from_jax``; the decoded
    detections of two 64² frames within 1e-4 of JAX's largest magnitude;
    a short or a long weight file is refused."""
    cfg, wfile, buf = tiny
    layers = TY.build_layers(TY.parse_darknet_cfg(cfg))
    assert layers == JY.build_layers(JY.parse_darknet_cfg(cfg))
    assert TY.expected_weight_count(layers) == \
        JY.expected_weight_count(layers) == buf.size
    params_t = TY.load_darknet_weights(layers, wfile)
    params_j = JY.load_darknet_weights(layers, wfile)
    from_j = convert.darknet_params_from_jax(params_j)
    assert sorted(params_t) == sorted(from_j)
    for name in params_t:
        for k in ("weight", "bias"):
            np.testing.assert_array_equal(params_t[name][k], from_j[name][k])
    x = np.random.default_rng(35).uniform(0, 1, (2, 64, 64, 3)) \
        .astype(np.float32)
    tp = {n: {k: torch.from_numpy(v) for k, v in p.items()}
          for n, p in params_t.items()}
    got = TY.darknet_apply(layers, tp, torch.from_numpy(x).permute(0, 3, 1, 2))
    want = np.asarray(JY.darknet_apply(layers, params_j, jnp.asarray(x)))
    assert got.shape == (2, 2 * 16 * 16 + 3 * 32 * 32, 9)
    assert _rel(got.numpy(), want) <= 1e-4
    short = os.path.join(os.path.dirname(wfile), "short.weights")
    np.concatenate([np.zeros(5, np.int32).view(np.float32),
                    buf[:-10]]).tofile(short)
    with pytest.raises(ValueError, match="truncated"):
        TY.load_darknet_weights(layers, short)
    long = os.path.join(os.path.dirname(wfile), "long.weights")
    np.concatenate([np.zeros(5, np.int32).view(np.float32), buf,
                    np.zeros(7, np.float32)]).tofile(long)
    with pytest.raises(ValueError, match="unread"):
        TY.load_darknet_weights(layers, long)


def test_non_max_suppression_matches_jax():
    """Weighted-merge NMS on seeded detections (three classes, overlaps,
    an image with nothing above the threshold): equal to JAX's."""
    rng = np.random.default_rng(36)
    pred = np.zeros((3, 60, 8), np.float32)
    pred[..., 0:2] = rng.uniform(20, 80, (3, 60, 2))
    pred[..., 2:4] = rng.uniform(10, 40, (3, 60, 2))
    pred[..., 4] = rng.uniform(0, 1, (3, 60))
    pred[..., 5:] = rng.uniform(0, 1, (3, 60, 3))
    pred[2, :, 4] = 0.1
    got = TY.non_max_suppression(pred, 0.5, 0.4)
    want = JY.non_max_suppression(pred, 0.5, 0.4)
    assert got[2] is None and want[2] is None
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)


def test_yolo_human_detector_matches_jax(tiny):
    """YoloHumanDetector's largest-person boxes and body_bboxes on two
    seeded [-1, 1] frames (a low threshold, so persons are found) within
    1e-4 of JAX's; nothing above an impossible threshold gives the whole
    frame."""
    cfg, wfile, _ = tiny
    imgs = np.random.default_rng(37).uniform(-1, 1, (2, 64, 64, 3)) \
        .astype(np.float32)
    port = TY.YoloHumanDetector(cfg, wfile, conf_thres=0.3, device="cpu")
    ref = JY.YoloHumanDetector(cfg, wfile, conf_thres=0.3)
    got, want = port.detect((imgs + 1) * 0.5), ref.detect((imgs + 1) * 0.5)
    assert any(w is not None for w in want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_allclose(g, w, atol=1e-3)
    np.testing.assert_allclose(port.body_bboxes(torch.from_numpy(imgs)),
                               ref.body_bboxes(imgs), atol=1e-4)
    port.conf_thres = 1.1
    np.testing.assert_array_equal(port.body_bboxes(imgs),
                                  [[0, 1, 0, 1], [0, 1, 0, 1]])
