"""The port's evaluation CLI (``cli/evaluate.py``) against the JAX
package's on the CPU: ``evaluate_protocol`` (self- and cross-imitation),
``evaluate_at_protocol`` (appearance transfer) and
``evaluate_view_protocol`` (novel views) on fake 64² trees in the
reference layouts (PNG frames, per-video θ pickles), float32, the
generator at conv_dim 8 with 2 residual blocks and the same seeded
weights in both packages (each package's task classes are patched to
take them). The metrics: LPIPS (alex, the repository's v0.1 lin heads
over a seeded backbone) and toy face / re-id / inception extractors
written with each package's ops, the face one on SMPL head crops. Both
give the same keys; the values differ as far as the two packages'
imitations do (their CPU rasters differ by the reference's FMA
contraction, ROADMAP.md), within the bounds below. Then the port's
``main`` end to end with ``--device cpu``, and without ``--device``
where there is no card."""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impersonator_tpu import config as jconfig
from impersonator_tpu.cli import evaluate as JE
from impersonator_tpu.metrics import zoo as JZ
from impersonator_tpu.models import HumanModelRecovery as JHMR
from impersonator_tpu.models import losses as jL
from impersonator_tpu.models.generator import ImpersonatorGenerator as JGen
from impersonator_tpu.tasks import imitator as JI
from impersonator_tpu.tasks import swapper as JS
from impersonator_tpu.tasks import viewer as JV
from impersonator_tpu_torch import assets as tassets
from impersonator_tpu_torch.cli import evaluate as TE
from impersonator_tpu_torch.config import TestConfig as TConfig
from impersonator_tpu_torch.metrics import zoo as TZ
from impersonator_tpu_torch.models import losses as tL
from impersonator_tpu_torch.models.hmr import HumanModelRecovery as THMR
from impersonator_tpu_torch.models.generator import \
    ImpersonatorGenerator as TGen
from impersonator_tpu_torch.tasks import imitator as TI
from impersonator_tpu_torch.tasks import swapper as TS
from impersonator_tpu_torch.tasks import viewer as TV
from impersonator_tpu_torch.utils import convert
from impersonator_tpu_torch.utils.checkpoint import read_flax_msgpack
from impersonator_tpu_torch.utils.visualizer import write_png
from tools import convert_weights as cw

import torch_ref
from torch_threads import one_torch_thread  # noqa: F401

S, CONV_DIM, REPEAT, FRAMES = 64, 8, 2, 6

# |port - JAX| bounds on the evaluated metrics; in brackets the largest
# gap measured over the three runs (the two rasters agree on these
# bodies, so the gaps are float32 rounding; FD takes square roots of
# near-zero eigenvalues)
BOUNDS = {"ssim": 1e-5,        # [1.9e-7]
          "SSPE": 1e-5,        # [1.5e-7]
          "psnr": 1e-4,        # dB [1.9e-6]
          "lps": 1e-5,         # [2.1e-7]
          "face-CS": 1e-4,     # [3.9e-6]
          "OS-CS-reid": 1e-5,  # [1.1e-7]
          "face-FD": 1e-3,     # [1.3e-4]
          "OS-freid": 1e-4,    # [8.5e-7]
          "is": 1e-6,          # [1.0e-8]
          "fid": 1e-4}         # [9.9e-7]


# -- trees -------------------------------------------------------------------

def _frame(rng):
    """A smooth 64² RGB frame (upsampled 8² noise)."""
    low = rng.uniform(0, 255, (8, 8, 3))
    return np.kron(low, np.ones((8, 8, 1))).astype(np.uint8)


def _smpls(rng, n, orbit=False):
    pose = rng.normal(0, 0.05, (n, 72)).astype(np.float32)
    if orbit:
        pose[:] = pose[:1]
        pose[:, 1] = np.linspace(0, 1.5, n, dtype=np.float32)
    cams = np.tile([0.9, 0.0, 0.0], (n, 1)).astype(np.float32)
    cams[:, 1:] += rng.normal(0, 0.03, (n, 2)).astype(np.float32)
    return {"cams": cams, "pose": pose,
            "shape": np.zeros((1 if orbit else n, 10), np.float32)}


def _write_video(img_dir, pkl, rng, names, orbit=False):
    os.makedirs(img_dir, exist_ok=True)
    for name in names:
        write_png(os.path.join(img_dir, name), _frame(rng))
    os.makedirs(os.path.dirname(pkl), exist_ok=True)
    with open(pkl, "wb") as f:
        pickle.dump(_smpls(rng, len(names), orbit), f)


def iper_tree(root, n_frames=FRAMES):
    """Two iPER videos (images_HD/{vid}/%08d.png, smpls/{vid}/
    pose_shape.pkl) and a protocol in the standard schema: self-imitation
    over every frame, cross-imitation of the other video."""
    rng = np.random.default_rng(41)
    vids = ["001/1/1", "002/1/2"]
    names = [f"{i:08d}.png" for i in range(n_frames)]
    for vid in vids:
        _write_video(os.path.join(root, "images_HD", vid),
                     os.path.join(root, "smpls", vid, "pose_shape.pkl"),
                     rng, names)
    proto = {"val": {vid: {
        "source": [names[0]], "view angle": [0], "s_n": {"1": [names[0]]},
        "self_imitation": {"target": vid, "range": [0, n_frames - 1]},
        "cross_imitation": {"target": vids[1 - i],
                            "range": [0, n_frames - 1]},
        "flag": [0, n_frames - 1]} for i, vid in enumerate(vids)}}
    path = os.path.join(root, "iper_protocol.json")
    with open(path, "w") as f:
        json.dump(proto, f)
    return path


def at_tree(root):
    """The same layout with an appearance-transfer protocol (the real
    schema: video_infos + vid_name_pairs, both ways)."""
    rng = np.random.default_rng(42)
    vids = ["003/1/1", "003/2/1"]
    names = [f"{i:08d}.png" for i in range(5)]
    for vid in vids:
        _write_video(os.path.join(root, "images_HD", vid),
                     os.path.join(root, "smpls", vid, "pose_shape.pkl"),
                     rng, names)
    proto = {"video_infos": {vid: {"source": [names[0]], "view angle": [0],
                                   "s_n": {"1": [names[0]]}, "flag": [1, 4]}
                             for vid in vids},
             "vid_name_pairs": [vids, vids[::-1]]}
    path = os.path.join(root, "at_protocol.json")
    with open(path, "w") as f:
        json.dump(proto, f)
    return path


def view_tree(root):
    """A MotionSynthetic novel-view video (processed/{vid}/images,
    one shape row, a yaw orbit) and its protocol."""
    rng = np.random.default_rng(43)
    vid = "PeopleSnapshot_test_0001"
    names = [f"frame_{i:08d}.png" for i in range(5)]
    _write_video(os.path.join(root, "processed", vid, "images"),
                 os.path.join(root, "processed", vid, "pose_shape.pkl"),
                 rng, names, orbit=True)
    proto = {"val": {vid: {
        "source": [names[0]], "view angle": [0], "s_n": {"1": [names[0]]},
        "novel view": True,
        "self_imitation": {"target": vid, "range": [0, 4]},
        "cross_imitation": {"target": vid, "range": [0, 4]},
        "flag": [0, 4]}}}
    path = os.path.join(root, "nv_protocol.json")
    with open(path, "w") as f:
        json.dump(proto, f)
    return path


# -- the two packages with the same weights -----------------------------------

@pytest.fixture(scope="module")
def weights():
    """Reference-layout generator weights, HMR (the port's seeded init,
    fc3 scaled, so θ stays near the mean) and an LPIPS tree (the
    repository's v0.1 alex lin heads over a seeded backbone)."""
    rng = np.random.default_rng(44)
    gen = {**torch_ref.make_bg_sd(rng, 4, CONV_DIM, REPEAT),
           **torch_ref.make_resunet_sd(rng, "src_model", 6, CONV_DIM, REPEAT),
           **torch_ref.make_resunet_sd(rng, "tsf_model", 6, CONV_DIM, REPEAT)}
    hmr = TI.build_nets(TConfig(repeat_num=1),
                        tassets.synthetic_assets()).hmr.state_dict()
    alex = torch_ref.make_alexnet_sd(np.random.default_rng(45))
    lpips = read_flax_msgpack(os.path.join(
        os.path.dirname(TE.REAL_LPIPS_LIN), "lpips_v01_alex_lin.msgpack"))
    lpips["params"]["alex"] = cw.convert_alexnet(alex)["params"]
    return gen, hmr, lpips


def _port_factory(cls, gen_sd, hmr_sd):
    def make(cfg, device="cuda"):
        gen = TGen(conv_dim=CONV_DIM, repeat_num=REPEAT)
        gen.load_state_dict(gen_sd, strict=True)
        hmr = THMR()
        hmr.load_state_dict(hmr_sd, strict=True)
        return cls(cfg, assets=tassets.synthetic_assets(),
                   nets=TI.ImitatorNets(gen, hmr), device=device)
    return make


def _jax_factory(cls, gen_sd, hmr_sd):
    params = cw.convert_generator(gen_sd, repeat=REPEAT)
    hmr = cw.convert_hmr(hmr_sd)

    def make(cfg):
        gen = JGen(bg_dim=4, src_dim=6, tsf_dim=6, conv_dim=CONV_DIM,
                   repeat_num=REPEAT)
        return cls(cfg, nets=JI.ImitatorNets(gen, params, JHMR(), hmr,
                                             None, None))
    return make


def _extractors(pkg, lpips_tree):
    """lpips_apply, face_fn (head crops), reid_fn, inception_fn of one
    package; the toy ones are the same arithmetic in each package's
    ops."""
    proj = np.random.default_rng(46).normal(size=(48, 10)).astype(np.float32)
    if pkg == "jax":
        model = JZ.LPIPS()
        lpips = jax.jit(lambda a, b: model.apply(lpips_tree, a, b))
        crop, arr = jL.crop_resize_fractional, jnp.asarray

        def inception(imgs):
            feats = imgs.reshape(imgs.shape[0], -1)[:, :48]
            return (jnp.concatenate([imgs.mean((1, 2)), feats[:, :5]], 1),
                    jax.nn.softmax(feats @ arr(proj), axis=-1))
    else:
        model = TZ.LPIPS()
        model.load_state_dict(
            convert.lpips_state_dict_from_jax(lpips_tree), strict=True)
        lpips = TE.lpips_apply_fn(model.eval())
        crop = tL.crop_resize_fractional

        def arr(x):
            return torch.as_tensor(x, dtype=torch.float32)

        def inception(imgs):
            feats = imgs.reshape(imgs.shape[0], -1)[:, :48]
            return (torch.cat([imgs.mean((1, 2)), feats[:, :5]], 1),
                    torch.softmax(feats @ arr(proj), -1))

    def face(imgs, bboxes=None):
        if bboxes is None:
            bboxes = np.tile(np.float32([0, 1, 0, 1]), (imgs.shape[0], 1))
        return crop(imgs, arr(bboxes), 8, 8).reshape(imgs.shape[0], -1)

    def reid(imgs):
        return imgs.mean(1).reshape(imgs.shape[0], -1)[:, :24]

    return dict(lpips_apply=lpips, face_fn=face, reid_fn=reid,
                inception_fn=inception)


def _cfgs(data_dir, out):
    kw = dict(image_size=S, repeat_num=REPEAT, compute_dtype="float32",
              data_dir=data_dir, output_dir=out)
    return TConfig(**kw), jconfig.TestConfig(**kw)


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):
    """Each protocol evaluated once by each package."""
    gen_sd, hmr_sd, lpips_tree = weights
    root = str(tmp_path_factory.mktemp("eval"))
    iper, at, nv = iper_tree(root), at_tree(root), view_tree(root)
    ex = {pkg: _extractors(pkg, lpips_tree) for pkg in ("jax", "torch")}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for mod, cls in ((TE, TI.Imitator), (TS, TS.Swapper),
                         (TV, TV.Viewer)):
            mp.setattr(mod, cls.__name__, _port_factory(cls, gen_sd, hmr_sd))
        for mod, cls in ((JE, JI.Imitator), (JS, JS.Swapper),
                         (JV, JV.Viewer)):
            mp.setattr(mod, cls.__name__, _jax_factory(cls, gen_sd, hmr_sd))
        for pkg, mod in (("torch", TE), ("jax", JE)):
            tcfg, jcfg = _cfgs(root, os.path.join(root, "out_" + pkg))
            cfg = tcfg if pkg == "torch" else jcfg
            dev = {"device": "cpu"} if pkg == "torch" else {}
            e = ex[pkg]
            out[pkg] = {
                "iper": mod.evaluate_protocol(
                    cfg, iper, lpips_apply=e["lpips_apply"],
                    inception_fn=e["inception_fn"], face_fn=e["face_fn"],
                    reid_fn=e["reid_fn"], sspe=True, **dev),
                "at": mod.evaluate_at_protocol(
                    cfg, at, lpips_apply=e["lpips_apply"],
                    face_fn=e["face_fn"], **dev),
                "view": mod.evaluate_view_protocol(
                    cfg, nv, lpips_apply=e["lpips_apply"], **dev)}
    return out


def _compare(got, want, keys):
    """Same keys at every level; each metric within its bound. Returns
    the largest gap of each metric."""
    gaps = {}
    assert sorted(got) == sorted(want) == sorted(keys)
    for section in ("self_imitation", "cross_imitation"):
        if section not in want:
            continue
        assert list(got[section]) == list(want[section]), section
        for k, v in want[section].items():
            gap = abs(got[section][k] - v)
            gaps[k] = max(gaps.get(k, 0.0), gap)
            assert np.isfinite(got[section][k]), k
            assert gap <= BOUNDS[k], (section, k, got[section][k], v)
    assert list(got["per_video"]) == list(want["per_video"])
    for vid, res in want["per_video"].items():
        for k, v in res.items():
            assert abs(got["per_video"][vid][k] - v) <= BOUNDS[k], (vid, k)
    return gaps


def test_evaluate_protocol_matches_jax(runs):
    """Self-imitation (ssim, psnr, lps, face-CS on SMPL head crops,
    OS-CS-reid, SSPE through HMR) and cross-imitation (is, fid, OS-freid
    / CS, face-FD / CS) on two videos of six frames: the JAX run's keys, frame counts and
    values within BOUNDS."""
    got, want = runs["torch"]["iper"], runs["jax"]["iper"]
    gaps = _compare(got, want, ["self_imitation", "cross_imitation",
                                "per_video", "num_si_frames",
                                "num_ci_frames"])
    assert got["num_si_frames"] == want["num_si_frames"] == 2 * FRAMES
    assert got["num_ci_frames"] == want["num_ci_frames"] == 2 * FRAMES
    assert sorted(got["cross_imitation"]) == sorted(
        ["is", "fid", "OS-freid", "OS-CS-reid", "face-FD", "face-CS"])
    print("evaluate_protocol gaps", gaps)


def test_evaluate_at_protocol_matches_jax(runs):
    """Appearance transfer over both vid_name_pairs (swap, re-personalise
    on the composite, four driving frames each): the JAX run's keys and
    values within BOUNDS."""
    got, want = runs["torch"]["at"], runs["jax"]["at"]
    gaps = _compare(got, want, ["self_imitation", "per_video",
                                "num_si_frames"])
    assert got["num_si_frames"] == want["num_si_frames"] == 8
    print("evaluate_at_protocol gaps", gaps)


def test_evaluate_view_protocol_matches_jax(runs):
    """Novel views over a five-frame yaw orbit: the JAX run's keys and
    values within BOUNDS."""
    got, want = runs["torch"]["view"], runs["jax"]["view"]
    gaps = _compare(got, want, ["self_imitation", "per_video",
                                "num_si_frames"])
    assert got["num_si_frames"] == want["num_si_frames"] == 5
    print("evaluate_view_protocol gaps", gaps)


def test_evaluate_cli_main_on_the_cpu(tmp_path, capsys):
    """``main`` with --device cpu on the iPER tree (the task's own seeded
    nets, the repository's LPIPS lin heads with a seeded backbone, MTCNN
    face crops for the Sphere20a face net read from a msgpack,
    --max_frames 4, --save_preds): results.txt in the reference's format,
    results.json, the predictions in the reference's layout, and the
    log lines of the capped ranges and the seeded backbone."""
    from flax import serialization

    from impersonator_tpu_torch.models.facenet import Sphere20a, init_facenet
    proto = iper_tree(str(tmp_path))
    net = init_facenet(Sphere20a(), torch.Generator().manual_seed(47))
    sphere = tmp_path / "sphere.msgpack"
    sphere.write_bytes(serialization.to_bytes(
        cw.convert_sphere(net.state_dict())))
    out = tmp_path / "out"
    results = TE.main([
        "--data_dir", str(tmp_path), "--protocol_file", proto,
        "--max_frames", "4", "--save_preds", "--sphere_path", str(sphere),
        "--mtcnn_path", TE.REAL_MTCNN, "--image_size", str(S),
        "--repeat_num", "1", "--device", "cpu",
        "--checkpoints_dir", str(tmp_path / "ckpt"),
        "--output_dir", str(out), "--name", "eval"])
    log = capsys.readouterr().out
    assert "capping 6 -> 4 frames (2 dropped)" in log
    assert "fixed-seed random backbone" in log
    si, ci = results["self_imitation"], results["cross_imitation"]
    assert list(si) == ["ssim", "psnr", "lps", "face-CS"]
    assert sorted(ci) == ["face-CS", "face-FD"]
    assert all(np.isfinite(v) for v in [*si.values(), *ci.values()])
    assert results["num_si_frames"] == results["num_ci_frames"] == 8
    txt = (out / "results.txt").read_text()
    for title in ("Self-imitation Results", "Cross-imitation Results",
                  "Per-video (self-imitation)"):
        assert title in txt
    assert "ssim = " in txt and "quality = higher" in txt
    assert json.loads((out / "results.json").read_text())[
        "self_imitation"] == pytest.approx(si)
    for sub in ("self_imitation", "cross_imitation"):
        assert sorted(os.listdir(out / sub)) == [f"pred_{i:08d}.jpg"
                                                for i in range(8)]


def test_evaluate_cli_defaults_to_cuda(tmp_path):
    """Without --device the CLI asks for the card; where there is none it
    fails before writing anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proto = iper_tree(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.main(["--data_dir", str(tmp_path), "--protocol_file", proto,
                 "--image_size", str(S), "--repeat_num", "1",
                 "--output_dir", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_evaluate_helpers_match_jax(weights, tmp_path):
    """SMPL head boxes (_head_bboxes) within 1e-6, MTCNN head boxes of
    [-1, 1] frames (_mtcnn_boxes) within half a pixel, SSPE's θs of 64²
    frames resized to 224² (_hmr_fn) and the θs of frame files in padded
    batches (_hmr_thetas) within 1e-4 of the largest |θ|; save_results
    and save_si_results write the same text as JAX's from one results
    dict."""
    from impersonator_tpu.metrics import mtcnn as JMt
    from impersonator_tpu_torch.metrics import mtcnn as TMt
    from impersonator_tpu_torch.scenes import face_image
    gen_sd, hmr_sd, _ = weights
    tcfg, jcfg = _cfgs(str(tmp_path), str(tmp_path))
    port = _port_factory(TI.Imitator, gen_sd, hmr_sd)(tcfg, device="cpu")
    ref = _jax_factory(JI.Imitator, gen_sd, hmr_sd)(jcfg)
    thetas = np.concatenate([_smpls(np.random.default_rng(48), 4)[k]
                             for k in ("cams", "pose")] +
                            [np.zeros((4, 10), np.float32)], 1)
    np.testing.assert_allclose(TE._head_bboxes(port, thetas),
                               JE._head_bboxes(ref, thetas), atol=1e-6)

    faces = np.stack([face_image(96, 96, 48, 50, 28, seed=1),
                      face_image(96, 96, 40, 44, 24, seed=2)])
    x = faces.astype(np.float32) / 127.5 - 1.0
    det_t = TMt.load_mtcnn(TE.REAL_MTCNN, device="cpu")
    det_j = JMt.load_mtcnn(JE.REAL_MTCNN)
    np.testing.assert_allclose(TE._mtcnn_boxes(det_t, torch.from_numpy(x)),
                               JE._mtcnn_boxes(det_j, x), atol=0.5 / 96)

    imgs = np.random.default_rng(49).uniform(-1, 1, (6, S, S, 3)) \
        .astype(np.float32)
    got = TE._hmr_fn(port)(torch.from_numpy(imgs))
    want = np.asarray(JE._hmr_fn(ref)(imgs))
    assert got.shape == (6, 85)
    assert float(np.abs(got.numpy() - want).max()
                 / np.abs(want).max()) <= 1e-4
    paths = []
    for i in range(5):
        paths.append(str(tmp_path / f"{i:08d}.png"))
        write_png(paths[-1], _frame(np.random.default_rng(50 + i)))
    got = TE._hmr_thetas(port, paths)
    want = JE._hmr_thetas(ref, paths)
    assert got.shape == want.shape == (5, 85)
    assert float(np.abs(got - want).max() / np.abs(want).max()) <= 1e-4

    results = {"self_imitation": {"ssim": 0.5, "psnr": 20.25, "lps": 0.125,
                                  "SSPE": 1.5},
               "cross_imitation": {"fid": 3.0, "is": 1.25, "face-CS": 0.5},
               "per_video": {"001/1/1": {"ssim": 0.5, "psnr": 20.25}}}
    for save in ("save_results", "save_si_results"):
        getattr(TE, save)(str(tmp_path / "t.txt"), results)
        getattr(JE, save)(str(tmp_path / "j.txt"), results)
        assert (tmp_path / "t.txt").read_text() == \
            (tmp_path / "j.txt").read_text()


def test_build_extractors_match_jax(weights, tmp_path, capsys):
    """build_extractors from the same msgpack files in both packages (an
    LPIPS tree with its backbone, Sphere20a, OSNet): LPIPS distances, the
    face and the re-id embeddings within 1e-4 relative; absent files give
    the JAX CLI's log lines and skip their extractors; the lin-heads-only
    file gets a fixed-seed backbone, with the log line."""
    from flax import serialization

    from impersonator_tpu_torch.models.facenet import Sphere20a, init_facenet
    _, _, lpips_tree = weights
    files = {"lpips": tmp_path / "lpips.msgpack",
             "sphere": tmp_path / "sphere.msgpack",
             "osnet": tmp_path / "osnet.msgpack"}
    files["lpips"].write_bytes(serialization.to_bytes(lpips_tree))
    sphere = init_facenet(Sphere20a(), torch.Generator().manual_seed(51))
    files["sphere"].write_bytes(serialization.to_bytes(
        cw.convert_sphere(sphere.state_dict())))
    files["osnet"].write_bytes(serialization.to_bytes(
        cw.convert_osnet(torch_ref.make_osnet_sd(np.random.default_rng(52)))))
    missing = str(tmp_path / "absent.msgpack")
    args = (str(files["lpips"]), missing, str(files["sphere"]), missing,
            str(files["osnet"]), missing, missing)
    got = TE.build_extractors(*args, device="cpu")
    log_t = capsys.readouterr().out
    want = JE.build_extractors(*args)
    log_j = capsys.readouterr().out
    assert log_t == log_j and log_t.count("not found") == 4
    assert [f is None for f in got] == [f is None for f in want] == \
        [False, True, False, False, True]
    rng = np.random.default_rng(53)
    a = rng.uniform(-1, 1, (2, S, S, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (2, S, S, 3)).astype(np.float32)

    def rel(x, y):
        y = np.asarray(y)
        return float(np.abs(x.detach().numpy() - y).max() / np.abs(y).max())

    assert rel(got[0](torch.from_numpy(a), torch.from_numpy(b)),
               want[0](a, b)) <= 1e-4
    for i in (2, 3):
        assert rel(got[i](torch.from_numpy(a)), want[i](a)) <= 1e-4

    lin_only = TE.build_extractors(device="cpu")[0]
    assert "fixed-seed random backbone" in capsys.readouterr().out
    assert torch.isfinite(lin_only(torch.from_numpy(a),
                                   torch.from_numpy(b))).all()
