"""The port's metrics (``impersonator_tpu_torch.metrics``: metrics,
unpaired, protocols; ``ops.sampler.resize_bilinear_torch``) against the
JAX package's on the CPU, on the same seeded NumPy inputs: the paired
metrics within 1e-5, both runners (``merge`` included) key for key, the
Fréchet distance and the Inception Score within 1e-6 relative on the
same features, and every protocol registry name parsing one tree into
the same units."""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impersonator_tpu.metrics import metrics as JM
from impersonator_tpu.metrics import protocols as JP
from impersonator_tpu.metrics import unpaired as JU
from impersonator_tpu.metrics import zoo as JZ
from impersonator_tpu.models import losses as jL
from impersonator_tpu.ops import sampler as jsampler
from impersonator_tpu_torch.metrics import metrics as TM
from impersonator_tpu_torch.metrics import protocols as TP
from impersonator_tpu_torch.metrics import unpaired as TU
from impersonator_tpu_torch.metrics import zoo as TZ
from impersonator_tpu_torch.models import losses as tL
from impersonator_tpu_torch.ops import sampler as tsampler
from tools import convert_weights as cw

import torch_ref
from torch_threads import one_torch_thread  # noqa: F401


def _imgs(seed, shape=(3, 32, 32, 3)):
    return np.random.default_rng(seed).uniform(-1, 1, shape) \
        .astype(np.float32)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


@pytest.mark.parametrize("size", [(299, 299), (160, 160), (224, 224),
                                  (112, 96), (20, 13)])
def test_resize_bilinear_torch_matches_jax(size):
    """align_corners=False resize, up and down, within 1e-5 of JAX's:
    XLA's CPU backend fuses the source coordinate's multiply-add
    ``(i + 0.5) · scale - 0.5`` into one FMA, which moves a coordinate by
    an ulp (measured 3.3e-6 at 299² from 64×48); same size is the
    identity."""
    x = _imgs(1, (2, 64, 48, 3))
    ref = np.asarray(jsampler.resize_bilinear_torch(jnp.asarray(x), *size))
    out = tsampler.resize_bilinear_torch(torch.from_numpy(x), *size)
    assert out.shape == (2, *size, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    same = tsampler.resize_bilinear_torch(torch.from_numpy(x), 64, 48)
    assert torch.equal(same, torch.from_numpy(x))


def test_paired_metrics_match_jax():
    """ssim, psnr, perceptual distance (an alex feature net, with and
    without lin weights, and through the runner's fallback), SSPE and the
    matched cosine within 1e-5 of JAX's on the same inputs; identical
    images score ssim 1."""
    a, b = _imgs(2), _imgs(3)
    b = (0.7 * a + 0.3 * b).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert abs(float(TM.ssim(ta, tb)) - float(JM.ssim(a, b))) <= 1e-5
    assert abs(float(TM.psnr(ta, tb)) - float(JM.psnr(a, b))) <= 1e-5
    assert abs(float(TM.ssim(ta, ta)) - 1.0) <= 1e-5

    sd = torch_ref.make_alexnet_sd(np.random.default_rng(4))
    net = TZ.AlexFeatures()
    net.load_state_dict(sd, strict=True)
    jnet, jparams = JZ.AlexFeatures(), cw.convert_alexnet(sd)
    a64, b64 = _imgs(5, (2, 64, 64, 3)), _imgs(6, (2, 64, 64, 3))
    lin = [np.random.default_rng(7).uniform(0, 0.1, c).astype(np.float32)
           for c in TZ.LPIPS_CHNS]
    for w in (None, lin):
        got = TM.perceptual_distance(net.eval(), a64, b64, w)
        want = JM.perceptual_distance(jnet, jparams, a64, b64, w)
        assert _rel(got, want) <= 1e-5
    # the runner's lps without an LPIPS net falls back to this distance
    run_t = TM.PairedMetricRunner(["lps"], vgg=net)
    run_j = JM.PairedMetricRunner(["lps"], vgg=jnet, vgg_params=jparams)
    run_t.update(a64, b64)
    run_j.update(a64, b64)
    assert _rel(run_t.evaluate()["lps"], run_j.evaluate()["lps"]) <= 1e-5

    rng = np.random.default_rng(8)
    p, r = rng.normal(size=(4, 85)), rng.normal(size=(4, 85))
    assert TM.sspe_score(torch.from_numpy(p), r) == JM.sspe_score(p, r)
    e1, e2 = rng.normal(size=(5, 16)), rng.normal(size=(5, 16))
    assert TU.matched_cosine(torch.from_numpy(e1).float(), e2) == \
        pytest.approx(JU.matched_cosine(e1.astype(np.float32), e2), abs=1e-7)


def _extractors(pkg):
    """The same toy extractors written with each package's ops: lpips,
    hmr, a head-crop face embed, a re-id embed, an inception pair and a
    generic embed."""
    if pkg == "jax":
        crop, arr = jL.crop_resize_fractional, jnp.asarray

        def cat(xs):
            return jnp.concatenate(xs, 1)

        def softmax(z):
            return jax.nn.softmax(z, axis=-1)
    else:
        crop = tL.crop_resize_fractional

        def arr(x):
            return torch.as_tensor(x, dtype=torch.float32)

        def cat(xs):
            return torch.cat(xs, 1)

        def softmax(z):
            return torch.softmax(z, -1)
    proj = np.random.default_rng(9).normal(size=(48, 10)).astype(np.float32)

    def lpips(a, b):
        return abs(a - b).mean((1, 2, 3))

    def hmr(imgs):
        return imgs.reshape(imgs.shape[0], -1)[:, :85] * 2.0

    def face(imgs, bboxes):
        return crop(imgs, arr(bboxes), 4, 4).reshape(imgs.shape[0], -1)

    def reid(imgs):
        return imgs.mean(1).reshape(imgs.shape[0], -1)[:, :24]

    def inception(imgs):
        feats = imgs.reshape(imgs.shape[0], -1)[:, :48]
        return (cat([imgs.mean((1, 2)), feats[:, :5]]),
                softmax(feats @ arr(proj)))

    def embed(imgs):
        return imgs[:, ::8, ::8, 0].reshape(imgs.shape[0], -1)

    return dict(lpips_apply=lpips, hmr_fn=hmr, face_fn=face, reid_fn=reid,
                inception_fn=inception, embed_fn=embed)


def _boxes(seed, n):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(0.0, 0.4, n)
    y0 = rng.uniform(0.0, 0.4, n)
    return np.stack([x0, x0 + rng.uniform(0.3, 0.6, n), y0,
                     y0 + rng.uniform(0.3, 0.6, n)], 1).astype(np.float32)


def test_paired_runner_and_merge_match_jax():
    """Two per-video runners merged into an aggregate, every metric type
    (face-CS on head crops, OS-CS-reid on body crops), key for key within
    1e-5 of JAX's, with the frame weighting of unequal videos."""
    types = ["ssim", "psnr", "lps", "SSPE", "face-CS", "OS-CS-reid"]
    out = {}
    for pkg, runner in (("jax", JM.PairedMetricRunner),
                        ("torch", TM.PairedMetricRunner)):
        ex = _extractors(pkg)
        kw = dict(metric_types=types, lpips_apply=ex["lpips_apply"],
                  hmr_fn=ex["hmr_fn"], face_fn=ex["face_fn"],
                  reid_fn=ex["reid_fn"])
        agg = runner(**kw)
        per = []
        for v, n in enumerate((3, 2)):
            r = runner(**kw)
            a, b = _imgs(10 + v, (n, 32, 32, 3)), _imgs(20 + v, (n, 32, 32, 3))
            r.update(a, b, pred_bboxes=_boxes(30 + v, n),
                     ref_bboxes=_boxes(30 + v, n),
                     pred_body_bboxes=_boxes(40 + v, n),
                     ref_body_bboxes=_boxes(50 + v, n))
            agg.merge(r)
            per.append(r.evaluate())
        out[pkg] = (agg.evaluate(), per)
    (agg_j, per_j), (agg_t, per_t) = out["jax"], out["torch"]
    assert list(agg_t) == list(agg_j) == types
    for got, want in zip([agg_t] + per_t, [agg_j] + per_j):
        assert set(got) == set(want)
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-5 * max(1.0, abs(want[k])), k


def test_unpaired_runner_matches_jax():
    """is, fid, OS / PCB re-id FD and CS on person crops, face FD and CS
    on head crops, generic fd / cs, over two updates: the same keys and
    values within 1e-5 relative of JAX's."""
    out = {}
    for pkg, runner in (("jax", JU.UnpairedMetricRunner),
                        ("torch", TU.UnpairedMetricRunner)):
        ex = _extractors(pkg)
        r = runner(inception_fn=ex["inception_fn"], reid_fn=ex["reid_fn"],
                   face_fn=ex["face_fn"], embed_fn=ex["embed_fn"],
                   pcb_fn=ex["reid_fn"])
        for u in range(2):
            r.update(_imgs(60 + u, (12, 32, 32, 3)),
                     _imgs(70 + u, (12, 32, 32, 3)),
                     pred_bboxes=_boxes(80 + u, 12),
                     ref_bboxes=_boxes(90 + u, 12),
                     pred_body_bboxes=_boxes(100 + u, 12),
                     ref_body_bboxes=_boxes(110 + u, 12))
        out[pkg] = r.evaluate()
    assert sorted(out["torch"]) == sorted(out["jax"]) == sorted(
        ["is", "fid", "OS-freid", "OS-CS-reid", "PCB-freid", "PCB-CS-reid",
         "face-FD", "face-CS", "fd", "cs"])
    for k, want in out["jax"].items():
        assert _rel(out["torch"][k], want) <= 1e-5, k


def test_frechet_and_inception_score_match_jax():
    """On the same features: Fréchet distance (rank-deficient
    covariances, N < D) and Inception Score within 1e-6 relative;
    gaussian_stats equal."""
    rng = np.random.default_rng(12)
    f1 = rng.normal(size=(40, 64))
    f2 = rng.normal(0.2, 1.1, size=(40, 64))
    m1, s1 = TU.gaussian_stats(f1)
    m2, s2 = TU.gaussian_stats(f2)
    jm1, js1 = JU.gaussian_stats(f1)
    np.testing.assert_array_equal(m1, jm1)
    np.testing.assert_array_equal(s1, js1)
    assert _rel(TU.frechet_distance(m1, s1, m2, s2),
                JU.frechet_distance(m1, s1, m2, s2)) <= 1e-6
    assert TU.frechet_distance(m1, s1, m1, s1) == \
        JU.frechet_distance(m1, s1, m1, s1)
    logits = rng.normal(size=(50, 20))
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    assert _rel(TU.inception_score(probs), JU.inception_score(probs)) <= 1e-6
    assert _rel(TU.inception_score(probs, splits=3),
                JU.inception_score(probs, splits=3)) <= 1e-6


def test_accepts_bboxes():
    for fn in (lambda imgs, boxes=None: imgs, lambda imgs: imgs, print,
               _boxes):
        assert TU.accepts_bboxes(fn) == JU.accepts_bboxes(fn)
    assert TU.accepts_bboxes(lambda imgs, boxes=None: imgs)
    assert not TU.accepts_bboxes(lambda imgs: imgs)


# -- protocols ---------------------------------------------------------------

def _video(img_dir, n, smpl_pkl, rng, shape_once=False):
    os.makedirs(img_dir, exist_ok=True)
    for i in range(n):
        open(os.path.join(img_dir, f"{i:08d}.jpg"), "a").close()
    os.makedirs(os.path.dirname(smpl_pkl), exist_ok=True)
    with open(smpl_pkl, "wb") as f:
        pickle.dump({"cams": rng.normal(size=(n, 3)).astype(np.float32),
                     "pose": rng.normal(size=(n, 72)).astype(np.float32),
                     "shape": rng.normal(size=(1 if shape_once else n, 10))
                     .astype(np.float32)}, f)


_LAYOUTS = {"iPER": None, "iPER_Novel_View": None,
            "fashionvideo": os.path.join("processed", "val"),
            "MotionSynthetic": "processed",
            "MotionSynthetic_Novel_View": "processed",
            "YoutubeDancer18": "processed"}


def _tree(root, registry):
    """Two 8-frame videos in the registry's layout and a protocol JSON of
    each schema (the standard one, the legacy list and the AT one)."""
    rng = np.random.default_rng(13)
    vids = ["001/1/1", "002/1/2"]
    for vid in vids:
        sub = _LAYOUTS.get(registry)
        if sub is None:
            _video(os.path.join(root, "images_HD", vid), 8,
                   os.path.join(root, "smpls", vid, "pose_shape.pkl"), rng)
        else:
            _video(os.path.join(root, sub, vid, "images"), 8,
                   os.path.join(root, sub, vid, "pose_shape.pkl"), rng,
                   shape_once=registry.startswith("MotionSynthetic"))
    std = {"val": {vid: {
        "source": ["00000000.jpg", "00000002.jpg"], "view angle": [0, 90],
        "s_n": {"1": ["00000001.jpg"], "2": ["00000000.jpg", "00000002.jpg"]},
        "self_imitation": {"target": vid, "range": [1, 5]},
        "cross_imitation": {"target": vids[1 - i], "range": [2, 7]},
        "flag": [0, 4]} for i, vid in enumerate(vids)}}
    legacy = [{"videoID": vid, "source": {"1": [1]},
               "self_imitation": {"begin": 2, "end": 6},
               "cross_imitation": {"videoID": vids[1 - i], "begin": 0,
                                   "end": 3}} for i, vid in enumerate(vids)]
    at = {"video_infos": {vid: {"source": ["00000000.jpg"],
                                "view angle": [0],
                                "s_n": {"1": ["00000003.jpg"]},
                                "flag": [1, 6]} for vid in vids},
          "vid_name_pairs": [vids, vids[::-1]]}
    paths = {}
    for name, obj in (("std", std), ("legacy", legacy), ("at", at)):
        paths[name] = os.path.join(root, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(obj, f)
    return paths


def _same_units(a, b):
    assert type(a).__name__ == type(b).__name__
    for k, v in vars(b).items():
        got = vars(a)[k]
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got, v, err_msg=k)
        else:
            assert got == v, k


@pytest.mark.parametrize("registry", sorted(JP.PROTOCOLS))
def test_protocol_registry_matches_jax(tmp_path, registry):
    """Every registry name of the JAX package parses the same tree into
    the same units (paths and θs), for one and two sources, with and
    without θs."""
    assert sorted(TP.PROTOCOLS) == sorted(JP.PROTOCOLS)
    root = str(tmp_path)
    paths = _tree(root, registry)
    files = ([paths["at"]] if registry == "iPER_Appearance_Transfer"
             else [paths["std"]] + ([paths["legacy"]]
                                    if _LAYOUTS[registry] is None else []))
    for pf in files:
        for n_src, smpls in ((1, True), (2, False)):
            pt = TP.build_protocol(registry, root, pf)
            pj = JP.build_protocol(registry, root, pf)
            pt.setup(num_sources=n_src, load_smpls=smpls)
            pj.setup(num_sources=n_src, load_smpls=smpls)
            assert len(pt) == len(pj) == 2
            for i in range(2):
                _same_units(pt[i], pj[i])
    with pytest.raises(ValueError):
        TP.build_protocol("nope", root, files[0])
