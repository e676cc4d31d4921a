"""The iPER, Places2 and DeepFashion readers and their composites against
the JAX package on the CPU, on small trees the tests write themselves
(no dataset is in the repository).

Both packages read the same tree draw for draw: the same frame pairs,
crops, flips and background picks, for a serial walk over the items and
through each package's loader with one worker. The θs are equal; PNG
frames (stored at the image size: no resize) are equal; JPEG images are
within the codec's bound against OpenCV's decode, 2 levels
(tests/test_torch_io.py), i.e. 2 · 2/255 in [-1, 1], plus 1e-5 for the
resize (the port's F.interpolate against cv2.resize, both bilinear on
float32).
"""

import os
import pickle

import cv2
import numpy as np
import pytest
import torch

from impersonator_tpu import config as jconfig
from impersonator_tpu.data import datasets as jdata
from impersonator_tpu.data import loader as jloader
from impersonator_tpu_torch import assets as tassets
from impersonator_tpu_torch.config import TrainConfig as TCfg
from impersonator_tpu_torch.data import datasets as tdata
from impersonator_tpu_torch.data import loader as tloader
from impersonator_tpu_torch.models.generator import ImpersonatorGenerator
from impersonator_tpu_torch.models.layers import init_weights
from impersonator_tpu_torch.tasks import trainer_aug as TA

from train_ref import one_torch_thread  # noqa: F401

S = 32
JPEG_TOL = 4.0 / 255 + 1e-5
CPU = "cpu"
# (video, frames: (extension, height, width) each, pickle rows or None)
VIDEOS = [("001/1/1", [(".png", S, S)] * 5, 5),
          ("002/2/1", [(".jpg", 40, 48), (".jpg", 48, 40), (".png", S, S),
                       (".jpg", 40, 40)], 6),
          ("003/1/2", [(".png", S, S)], 1),        # one frame: skipped
          ("004/1/1", [(".png", S, S)] * 3, None)]  # no pickle: skipped
PLACES = [("a/0001.jpg", 48, 64), ("a/0002.jpg", 40, 40),
          ("b/c/0003.jpg", 64, 48), ("b/0004.jpg", S, S),
          ("b/0005.jpg", 24, 30), ("b/skip.png", 40, 40)]
FASHION = [("img/front_01.jpg", 40, 36), ("img/back_01.png", S, S),
           ("img/side/p2.jpg", 36, 44), ("img/side/p3.png", S, S)]


def _image(rng, h, w):
    """A smooth seeded image with some noise (JPEG keeps it within a few
    levels)."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    base = np.stack([np.sin(6 * xx + rng.uniform(0, 6)),
                     np.cos(5 * yy + rng.uniform(0, 6)),
                     np.sin(4 * (xx + yy))], -1)
    img = (base * 0.4 + 0.5) * 255 + rng.normal(0, 4, (h, w, 3))
    return img.clip(0, 255).astype(np.uint8)


def _write(path, img):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    assert cv2.imwrite(str(path), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


def _smpl_rows(rng, n):
    return {"cams": rng.normal(0, 1, (n, 3)).astype(np.float32),
            "pose": rng.normal(0, 1, (n, 72)).astype(np.float32),
            "shape": rng.normal(0, 1, (n, 10)).astype(np.float32)}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """An iPER tree (images_HD / smpls / train.txt), a Places2 folder and a
    DeepFashion folder with pairs.txt and per-image _smpl.pkl files."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    iper, place, fashion = root / "iPER", root / "places", root / "fashion"
    for vid, frames, rows in VIDEOS:
        for i, (ext, h, w) in enumerate(frames):
            _write(iper / "images_HD" / vid / f"frame{i:08d}{ext}",
                   _image(rng, h, w))
        if rows:
            os.makedirs(iper / "smpls" / vid)
            with open(iper / "smpls" / vid / "pose_shape.pkl", "wb") as f:
                pickle.dump(_smpl_rows(rng, rows), f)
    (iper / "train.txt").write_text(
        "\n".join(v for v, _, _ in VIDEOS) + "\n\n")
    (iper / "val.txt").write_text("002/2/1\n")
    for rel, h, w in PLACES:
        _write(place / rel, _image(rng, h, w))
    for rel, h, w in FASHION:
        _write(fashion / rel, _image(rng, h, w))
        with open(fashion / (os.path.splitext(rel)[0] + "_smpl.pkl"),
                  "wb") as f:
            pickle.dump({k: v[0] for k, v in _smpl_rows(rng, 1).items()}, f)
    (fashion / "pairs.txt").write_text(
        "img/front_01.jpg img/back_01.png\n"
        "img/side/p2.jpg img/side/p3.png\nbad-line\n"
        "img/back_01.png img/side/p2.jpg\n")
    return dict(data_dir=str(iper), place_dir=str(place),
                fashion_dir=str(fashion))


def _cfgs(tree):
    kw = dict(image_size=S, **tree)
    return jconfig.TrainConfig(**kw), TCfg(**kw)


def _same_item(got: dict, want: dict, jpeg: bool):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        if k == "smpls":
            np.testing.assert_array_equal(got[k], v)
        elif jpeg:
            assert np.abs(got[k] - v).max() <= JPEG_TOL, k
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def _walk(name, tree, order, ids_file=None):
    jcfg, tcfg = _cfgs(tree)
    jds = jdata.dataset_by_name(name, jcfg, ids_file=ids_file)
    tds = tdata.dataset_by_name(name, tcfg, ids_file=ids_file, device=CPU)
    assert len(tds) == len(jds) > 0
    return [(tds[i], jds[i]) for i in order]


def test_imper_pairs_match_jax_draw_for_draw(tree):
    """ImPerDataset over train.txt: the one-frame video and the video with
    no pickle are skipped (2 videos left), and a serial walk of 12 items
    gives the same frame pairs as JAX (the θ rows, which differ frame to
    frame, equal), j in (i, i + interval] clipped to the last frame, PNG
    frames equal and JPEG frames within the codec's bound; the val split
    reads its own list."""
    order = [0, 1, 1, 0, 3, 2, 5, 4, 0, 1, 1, 1]
    pairs = _walk("iPER", tree, order)
    rows = pickle.load(open(os.path.join(
        tree["data_dir"], "smpls", "002/2/1", "pose_shape.pkl"), "rb"))
    for idx, (got, want) in zip(order, pairs):
        assert got["images"].shape == (2, S, S, 3)
        vid = VIDEOS[idx % 2]
        jpeg = any(e == ".jpg" for e, _, _ in vid[1])
        _same_item(got, want, jpeg)
    # the frame indices behind one item of video 2 (4 frames, 6 θ rows)
    theta = np.concatenate([rows["cams"], rows["pose"], rows["shape"]], 1)
    i, j = (int(np.flatnonzero((theta == r).all(1))[0])
            for r in pairs[1][0]["smpls"])
    assert 0 <= i < j <= 3
    val = _walk("iPER", tree, [0, 0], ids_file="val.txt")
    for got, want in val:
        _same_item(got, want, jpeg=True)


def test_place_crops_match_jax_draw_for_draw(tree):
    """PlaceDataset: the five JPEGs under the folder, recursively, sorted
    (the PNG left out); a serial walk of 15 items gives JAX's crops (y,
    then x, where the image is larger than S² on both sides; else the
    whole image resized) and flips, within the codec's JPEG bound."""
    tds = tdata.PlaceDataset(tree["place_dir"], S, device=CPU)
    jds = jdata.PlaceDataset(tree["place_dir"], S)
    assert tds.paths == jds.paths and len(tds) == 5
    assert not any(p.endswith(".png") for p in tds.paths)
    for i in [0, 1, 2, 3, 4, 2, 2, 0, 0, 1, 3, 4, 4, 2, 0]:
        _same_item(tds[i], jds[i], jpeg=True)
    assert tds.rng.random() == jds.rng.random()    # the streams in step


def test_fashion_pairs_match_jax(tree):
    """FashionPairDataset: three pairs (the one-token line skipped), each
    image with its sibling _smpl.pkl; items equal to JAX's (θs exactly,
    PNG exactly, JPEG within the bound); a missing pairs file gives an
    empty dataset."""
    for got, want in _walk("fashion", tree, [0, 1, 2, 4]):
        _same_item(got, want, jpeg=True)
    assert len(tdata.FashionPairDataset(tree["place_dir"])) == 0


@pytest.mark.parametrize("name", ["iPER_place", "iPER_fashion_place",
                                  "place", "synthetic", "synthetic_bg"])
def test_dataset_by_name_matches_jax(tree, name):
    """Every other registry name on the same tree: a serial walk of 7
    items equal to JAX's (the composites draw the pair first, then the
    background index, then the background's crop and flip; the pooled
    set takes iPER's items first, then DeepFashion's)."""
    for got, want in _walk(name, tree, [0, 1, 2, 3, 4, 1, 0]):
        _same_item(got, want, jpeg=not name.startswith("synthetic"))
    with pytest.raises(ValueError):
        tdata.dataset_by_name("no_such_set", _cfgs(tree)[1])


def test_loader_feeds_an_aug_step_from_disk(tree):
    """iPER_fashion_place through both loaders with one worker (a serial
    walk, so the draws stay in step; batch 2, seed 3): the same batches
    as JAX's, then the port's batch staged NCHW on the CPU drives one aug
    step (conv_dim 8 generator, 2-layer Global + Local D) to finite
    losses."""
    jcfg, tcfg = _cfgs(tree)
    tds = tdata.dataset_by_name("iPER_fashion_place", tcfg, device=CPU)
    jds = jdata.dataset_by_name("iPER_fashion_place", jcfg)
    got = list(tloader.DataLoader(tds, 2, num_workers=1, seed=3))
    want = list(jloader.DataLoader(jds, 2, num_workers=1, seed=3))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _same_item(g, w, jpeg=True)
    batch = tloader.stage_batch(got[0], CPU)
    assert batch["bg"].shape == (2, 3, S, S)
    assert batch["images"].shape == (2, 2, 3, S, S)
    cfg = TCfg(image_size=S, repeat_num=1, batch_size=2, d_layers=2,
               use_vgg=False, use_face=False,
               model="impersonator_trainer_aug")
    tr = TA.build_aug_trainer(cfg, tassets.synthetic_assets(), device=CPU)
    gen = ImpersonatorGenerator(conv_dim=8, repeat_num=1)
    init_weights(gen, torch.Generator().manual_seed(0))
    st = tr.init_state(gen)
    batch["smpls"] = batch["smpls"].clone()
    batch["smpls"][..., 0] = 0.9        # a camera that frames the body
    _, m = TA.make_aug_train_step(tr)(st, batch)
    assert all(np.isfinite(float(v)) for v in m.values())
    assert float(m["g_total"]) > 0
