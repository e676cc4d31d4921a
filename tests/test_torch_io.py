"""Host and device IO of the port against the JAX package, on the CPU:
the colour transforms (ops/colorspace.py), the image codec
(data/native.py, libjpeg build) against OpenCV and the JAX package's
native loader, the camera helpers, the video / visualiser / mesh
helpers, and the streamed Imitator.inference_from_paths (float, uint8
and I420 readback) against the port's own inference and against JAX's.

Tolerances. rgb_to_i420: float32 sums in another order can move a value
across a rounding boundary, so at most 1e-4 of the values may differ, by
one level. i420_to_rgb_device: float32, 1e-6. The codec: PNG exact,
JPEG within 2 levels of OpenCV's decode (another IDCT / upsampling may
round differently), the resize exact against JAX's native build (the
same float arithmetic) or within 1 level / 3e-5 of OpenCV's where that
build is missing. The encoder: quality 95 keeps a smooth image above
35 dB. The streamed preds against JAX's: test_torch_slice.py's
imitation bound, 1e-2.
"""

import os
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impersonator_tpu import config
from impersonator_tpu.data import native as jnative
from impersonator_tpu.models.generator import ImpersonatorGenerator as JGen
from impersonator_tpu.models.hmr import HumanModelRecovery as JHMR
from impersonator_tpu.ops import colorspace as jcs
from impersonator_tpu.tasks import imitator as JI
from impersonator_tpu.utils import cv_utils as jcv
from impersonator_tpu.utils import mesh_io as jmesh
from impersonator_tpu.utils import video as jvideo
from impersonator_tpu.utils import visualizer as jvis
from impersonator_tpu_torch.config import TestConfig as TConfig
from impersonator_tpu_torch.data import native
from impersonator_tpu_torch.models.generator import \
    ImpersonatorGenerator as TGen
from impersonator_tpu_torch.ops import colorspace as tcs
from impersonator_tpu_torch.tasks import imitator as TI
from impersonator_tpu_torch.utils import cv_utils as tcv
from impersonator_tpu_torch.utils import mesh_io as tmesh
from impersonator_tpu_torch.utils import profiling
from impersonator_tpu_torch.utils import video as tvideo
from impersonator_tpu_torch.utils import visualizer as tvis
from tools import convert_weights as cw

import torch_ref
from torch_threads import one_torch_thread  # noqa: F401

S, CONV_DIM, REPEAT = 64, 8, 2
FIX = (Path(__file__).resolve().parent.parent / "impersonator_tpu_torch"
       / "testdata" / "codec")
FIXTURES = ["smooth.png", "smooth.jpg", "person.png", "person.jpg"]
CPU = "cpu"


def smooth_image(h, w, phase=0.0):
    y, x = np.mgrid[0:h, 0:w].astype(np.float32) / max(h, w)
    img = np.stack([np.sin(6 * x + phase), np.cos(4 * y - phase),
                    np.sin(5 * x * y + 2 * phase)], -1)
    return ((img * 0.5 + 0.5) * 255).round().astype(np.uint8)


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


# --------------------------------------------------------------------------
# colour transforms
# --------------------------------------------------------------------------

def test_rgb_to_i420_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.1, 1.1, (3, 64, 48, 3)).astype(np.float32)
    want = np.asarray(jcs.rgb_to_i420(x))
    got = tcs.rgb_to_i420(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 96, 48) and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4


def test_i420_to_rgb_matches_jax():
    rng = np.random.default_rng(1)
    packed = rng.integers(0, 256, (2, 48, 32)).astype(np.uint8)
    got = tcs.i420_to_rgb_device(torch.from_numpy(packed)).numpy()
    want = np.asarray(jcs.i420_to_rgb_device(packed))
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(tcs.i420_to_rgb(packed),
                                  jcs.i420_to_rgb(packed))


def test_rgb_to_u8_matches_jax_rounding():
    """Half to even, as jnp.round: inputs whose (x + 1) * 127.5 is k + 0.5
    in float32 included."""
    k = np.arange(-2, 258, dtype=np.float32)
    x = np.concatenate([(k + 0.5) / np.float32(127.5) - 1,
                        np.random.default_rng(12).uniform(-1.2, 1.2, 500)
                        .astype(np.float32)])
    scaled = (x + np.float32(1.0)) * np.float32(127.5)
    assert (scaled - np.floor(scaled) == 0.5).sum() > 20
    want = np.asarray(jnp.clip(jnp.round((jnp.asarray(x) + 1.0) * 127.5),
                               0, 255).astype(jnp.uint8))
    np.testing.assert_array_equal(tcs.rgb_to_u8(torch.from_numpy(x)).numpy(),
                                  want)


# --------------------------------------------------------------------------
# the codec
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", FIXTURES)
def test_codec_decode_matches_cv2(name):
    path = str(FIX / name)
    got = native.read_image(path, CPU)
    committed = np.load(FIX / "cv2_decode.npz")[name]
    live = jcv.read_img(path)                       # cv2 in the JAX package
    assert got.shape == committed.shape and got.dtype == np.uint8
    for want in (committed, live):
        diff = np.abs(got.astype(int) - want.astype(int)).max()
        assert diff == 0 if name.endswith(".png") else diff <= 2, diff
    np.testing.assert_array_equal(tcv.read_img(path, CPU), got)


@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("s", [48, 224])
def test_decode_resize_matches_jax_native(name, s):
    path = str(FIX / name)
    got_u8 = native.decode_resize_u8(path, s, CPU)
    got_f = native.decode_resize(path, s, CPU)
    committed = np.load(FIX / "jax_resize_u8.npz")[f"{name}@{s}"]
    diff = np.abs(got_u8.astype(int) - committed.astype(int)).max()
    assert diff == 0 if name.endswith(".png") else diff <= 2, diff
    if jnative.available():
        np.testing.assert_array_equal(got_u8, jnative.decode_resize_u8(path,
                                                                       s))
        np.testing.assert_array_equal(got_f, jnative.decode_resize(path, s))
    else:
        img = jcv.read_img(path)
        want = cv2.resize(img, (s, s), interpolation=cv2.INTER_LINEAR)
        assert np.abs(got_u8.astype(int) - want.astype(int)).max() <= 1
        np.testing.assert_allclose(got_f, jcv.resize_img_hwc(img, s),
                                   atol=3e-5)
    # the array entry point: the same arithmetic on a decoded frame, one
    # level at most from OpenCV's fixed-point bilinear
    img = native.read_image(path, CPU)
    np.testing.assert_array_equal(native.resize_u8(img, s, CPU), got_u8)
    cv2_u8 = cv2.resize(img, (s, s), interpolation=cv2.INTER_LINEAR)
    assert np.abs(got_u8.astype(int) - cv2_u8.astype(int)).max() <= 1


def test_codec_rejects_garbage(tmp_path):
    with pytest.raises(ValueError, match="undecodable"):
        native.decode(b"\x89PNG\r\n\x1a\nnot really", CPU)
    with pytest.raises(ValueError, match="undecodable"):
        native.decode(b"\xff\xd8\xff\xe0 truncated", CPU)
    with pytest.raises(IOError, match="decode failed"):
        native.decode_resize_u8(str(tmp_path / "missing.jpg"), 32, CPU)


def test_codec_build_is_explicit():
    assert native.backend("cpu") == "cpu"
    assert native.backend(torch.device("cuda", 0)) == "cuda"
    with pytest.raises(ValueError):
        native.backend("meta")


def test_ring_keeps_fifo_order(tmp_path):
    """Frames of many sizes through 3 threads and a small capacity come
    back in submission order with their tags, each equal to a lone
    decode."""
    rng = np.random.default_rng(2)
    paths = []
    for i in range(12):
        h, w = int(rng.integers(20, 90)), int(rng.integers(20, 90))
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        p = str(tmp_path / f"{i:02d}.{'png' if i % 3 else 'jpg'}")
        tcv.save_img(img, p, normalize=False, device=CPU)
        paths.append(p)
    for u8 in (True, False):
        with native.NativeImageLoader(32, threads=3, capacity=4, u8=u8,
                                      device=CPU) as loader:
            for i, p in enumerate(paths[:4]):
                loader.submit(p, 100 + i)
            for i in range(len(paths)):
                frame, tag = loader.next()
                if i + 4 < len(paths):
                    loader.submit(paths[i + 4], 100 + i + 4)
                assert tag == 100 + i
                want = (native.decode_resize_u8 if u8
                        else native.decode_resize)(paths[i], 32, CPU)
                np.testing.assert_array_equal(frame, want)
            with pytest.raises(StopIteration):
                loader.next()


def test_ring_names_the_bad_file(tmp_path):
    good, bad = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    tcv.save_img(np.zeros((8, 8, 3), np.uint8), good, normalize=False,
                 device=CPU)
    Path(bad).write_bytes(b"not an image")
    with native.NativeImageLoader(8, threads=2, u8=True,
                                  device=CPU) as loader:
        loader.submit(good)
        loader.submit(bad)
        loader.next()
        with pytest.raises(IOError, match="b.png"):
            loader.next()


def test_jpeg_encoder_quality_95():
    img = smooth_image(256, 256)
    data = native.encode_jpeg(img, device=CPU)
    assert data[:2] == b"\xff\xd8"
    back = native.decode(data, CPU)
    assert psnr(back, img) > 35.0
    # OpenCV reads it to the same pixels, and its own encoder at its
    # defaults (quality 95, 4:2:0) writes a file of the same quality
    np.testing.assert_array_equal(
        cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        [..., ::-1], back)
    ok, ref = cv2.imencode(".jpg", img[..., ::-1])
    assert ok and abs(len(data) - len(ref)) <= 0.02 * len(ref)


def test_save_img_and_load_image_batch_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    img = np.clip(smooth_image(40, 56) / 127.5 - 1.0
                  + rng.normal(0, 0.02, (40, 56, 3)), -1, 1) \
        .astype(np.float32)
    for ext in ("png", "jpg"):
        mine, theirs = tmp_path / f"t.{ext}", tmp_path / f"j.{ext}"
        tcv.save_img(img, str(mine), device=CPU)
        jcv.save_img(img, str(theirs))
        a, b = native.read_image(str(mine), CPU), jcv.read_img(str(theirs))
        diff = np.abs(a.astype(int) - b.astype(int)).max()
        assert diff == 0 if ext == "png" else diff <= 2, diff
    paths = [str(tmp_path / "t.png"), str(tmp_path / "t.jpg")]
    got = tcv.load_image_batch(paths, 32, CPU)
    want = jcv.load_image_batch(paths, 32)
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=2e-2)   # ≤ 2 JPEG levels


# --------------------------------------------------------------------------
# camera helpers
# --------------------------------------------------------------------------

def test_camera_helpers_match_jax():
    rng = np.random.default_rng(4)
    for _ in range(5):
        cam = np.array([rng.uniform(0.5, 1.2), *rng.uniform(-0.2, 0.2, 2)])
        scale, start = rng.uniform(0.5, 2.0), rng.uniform(-30, 30, 2)
        for fn, args in ((tcv.cam_init2orig, (cam, scale, start)),
                         (tcv.cam_orig2crop, (cam, scale, start)),
                         (tcv.cam_process, (cam, scale, start, scale * 0.8,
                                            start + 3, 256))):
            np.testing.assert_allclose(
                fn(*args), getattr(jcv, fn.__name__)(*args), atol=1e-6)
        rt = rng.uniform(-180, 180, 3)
        np.testing.assert_allclose(tcv.euler2matrix(rt),
                                   jcv.euler2matrix(rt), atol=1e-6)


def test_rotate_global_pose_matches_jax():
    rng = np.random.default_rng(5)
    for i in range(20):
        pose = rng.normal(0, 0.5, 72).astype(np.float32)
        if i % 4 == 0:            # a root rotation by π: cv2's special case
            axis = rng.normal(0, 1, 3)
            pose[:3] = axis / np.linalg.norm(axis) * np.pi
        R = jcv.euler2matrix(rng.uniform(-180, 180, 3))
        np.testing.assert_allclose(tcv.rotate_global_pose(pose, R),
                                   jcv.rotate_global_pose(pose, R),
                                   atol=1e-6)


# --------------------------------------------------------------------------
# video, visualiser, mesh export
# --------------------------------------------------------------------------

def test_ffmpeg_paths_raise_without_ffmpeg(tmp_path):
    if tvideo.have_ffmpeg():
        pytest.skip("ffmpeg on host")
    frames = np.zeros((2, 8, 8, 3), np.uint8)
    for call in (lambda: tvideo.frames_to_mp4(frames, str(tmp_path / "a")),
                 lambda: tvideo.i420_to_mp4(np.zeros((2, 12, 8), np.uint8),
                                            str(tmp_path / "b")),
                 lambda: list(tvideo.stream_i420(str(tmp_path / "c"))),
                 lambda: tvideo.video_to_frames(str(tmp_path / "c"),
                                                str(tmp_path / "d"))):
        with pytest.raises(RuntimeError, match="ffmpeg not available"):
            call()


def test_i420_to_mp4(tmp_path):
    if not tvideo.have_ffmpeg():
        pytest.skip("ffmpeg not on host")
    rng = np.random.default_rng(2)
    preds = torch.from_numpy(rng.uniform(-1, 1, (4, 32, 32, 3))
                             .astype(np.float32))
    out = tvideo.i420_to_mp4(tcs.rgb_to_i420(preds), str(tmp_path / "v.mp4"),
                             fps=5)
    assert os.path.getsize(out) > 0


def test_fuse_helpers_match_jax(monkeypatch):
    rng = np.random.default_rng(6)
    a = rng.uniform(-1, 1, (3, 8, 10, 3)).astype(np.float32)
    b = rng.integers(0, 256, (2, 8, 10, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tvideo.fuse_grid([a, b], 1, 2),
                                  jvideo.fuse_grid([a, b], 1, 2))
    np.testing.assert_array_equal(tvideo.fuse_grid([a, b, b, a], 2, 2),
                                  jvideo.fuse_grid([a, b, b, a], 2, 2))
    grids = {}
    for mod, key in ((tvideo, "t"), (jvideo, "j")):
        monkeypatch.setattr(mod, "frames_to_mp4", lambda g, p, fps, k=key:
                            grids.setdefault(k, []).append(g) or p)
    for refs in (None, b):
        tvideo.fuse_source_reference_output(a[0], refs, a, "x.mp4")
        jvideo.fuse_source_reference_output(a[0], refs, a, "x.mp4")
    for got, want in zip(grids["t"], grids["j"]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("map_name", ["uv", "seg", "uv_seg", "par",
                                      "binary"])
def test_fim_enc_to_img_matches_jax(map_name):
    rng = np.random.default_rng(7)
    enc = rng.uniform(-1, 1, (12, 10, 4)).astype(np.float32)
    np.testing.assert_array_equal(tvis.fim_enc_to_img(enc, map_name),
                                  jvis.fim_enc_to_img(enc, map_name))


def test_draw_skeleton_matches_jax():
    rng = np.random.default_rng(8)
    img = rng.uniform(-1, 1, (48, 48, 3)).astype(np.float32)
    kps = rng.uniform(-0.95, 0.95, (19, 2)).astype(np.float32)
    got = tvis.draw_skeleton(img, kps)
    want = jvis.draw_skeleton(img, kps)
    pts = ((kps + 1.0) * 0.5 * 47).astype(int)
    yy, xx = np.mgrid[0:48, 0:48]
    d2 = ((yy[None] - pts[:, 1, None, None]) ** 2
          + (xx[None] - pts[:, 0, None, None]) ** 2).min(0)
    rim = (d2 >= 2) & (d2 <= 9)          # around the radius-2 discs' edge
    np.testing.assert_array_equal(got[~rim], want[~rim])
    assert (got != img).any()


def test_save_obj_matches_jax(tmp_path):
    rng = np.random.default_rng(9)
    verts = rng.normal(0, 1, (7, 3)).astype(np.float32)
    faces = rng.integers(0, 7, (5, 3))
    tex = rng.uniform(-1, 1, (5, 9, 3)).astype(np.float32)
    for textures in (None, tex):
        mine = tmesh.save_obj(str(tmp_path / "t.obj"), verts, faces,
                              textures)
        theirs = jmesh.save_obj(str(tmp_path / "j.obj"), verts, faces,
                                textures)
        assert (Path(mine).read_text().replace("t.", "X.")
                == Path(theirs).read_text().replace("j.", "X."))
    assert (tmp_path / "t.mtl").read_text() == \
        (tmp_path / "j.mtl").read_text().replace("j.png", "t.png")
    np.testing.assert_array_equal(
        native.read_image(str(tmp_path / "t.png"), CPU),
        jcv.read_img(str(tmp_path / "j.png")))


def test_profiling_on_the_cpu(tmp_path):
    timer = profiling.StepTimer()
    for _ in range(3):
        with timer.phase("step", device=CPU):
            torch.ones(4).sum()
    assert timer.summary()["step"]["count"] == 3
    with profiling.trace(str(tmp_path / "trace"), device=CPU):
        torch.ones(8).sum()
    assert any((tmp_path / "trace").iterdir())
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}


# --------------------------------------------------------------------------
# streamed inference
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stream(tmp_path_factory, assets):
    """Three JPEG frames of two sizes on disk, the source image and θ, and
    both packages' nets with the same weights (test_torch_hmr.py's)."""
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(10)
    paths = []
    for i, (h, w) in enumerate([(240, 200), (224, 224), (180, 260)]):
        img = np.clip(smooth_image(h, w, phase=0.7 * i).astype(np.float32)
                      + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)
        p = str(d / f"{i:03d}.jpg")
        tcv.save_img(img, p, normalize=False, device=CPU)
        paths.append(p)
    src_img = (smooth_image(S, S) / 127.5 - 1.0).astype(np.float32)
    theta = np.zeros(85, np.float32)
    theta[0] = 0.9
    sd_rng = np.random.default_rng(21)
    sd = {**torch_ref.make_bg_sd(sd_rng, 4, CONV_DIM, REPEAT),
          **torch_ref.make_resunet_sd(sd_rng, "src_model", 6, CONV_DIM,
                                      REPEAT),
          **torch_ref.make_resunet_sd(sd_rng, "tsf_model", 6, CONV_DIM,
                                      REPEAT)}
    tgen = TGen(conv_dim=CONV_DIM, repeat_num=REPEAT)
    tgen.load_state_dict(sd, strict=True)
    thmr = TI.build_nets(TConfig(repeat_num=REPEAT), assets).hmr
    imit = TI.Imitator(TConfig(image_size=S, repeat_num=REPEAT,
                               compute_dtype="float32"), assets=assets,
                       nets=TI.ImitatorNets(tgen, thmr), device=CPU)
    imit.personalize(src_img, src_smpl=theta)
    jnets = JI.ImitatorNets(
        JGen(bg_dim=4, src_dim=6, tsf_dim=6, conv_dim=CONV_DIM,
             repeat_num=REPEAT),
        cw.convert_generator(sd, repeat=REPEAT), JHMR(),
        cw.convert_hmr(thmr.state_dict()))
    return dict(paths=paths, src_img=src_img, theta=theta, imit=imit,
                jnets=jnets)


def test_inference_from_paths_packs_on_the_device(stream):
    """Float, uint8 and I420 readback on 3 frames at batch 2 (one padded
    batch) against the port's inference on the same decoded frames."""
    imit, paths = stream["imit"], stream["paths"]
    frames = np.stack([native.decode_resize_u8(p, 224, CPU) for p in paths])
    ref = imit.inference(frames.astype(np.float32) / 127.5 - 1.0, batch=2)
    first_cam = imit.first_cam.clone()

    preds = imit.inference_from_paths(paths, batch=2)
    assert torch.is_tensor(preds) and preds.shape == (3, S, S, 3)
    np.testing.assert_allclose(preds.numpy(), ref.numpy(), atol=1e-6)
    np.testing.assert_array_equal(imit.first_cam.numpy(), first_cam.numpy())

    u8 = imit.inference_from_paths(paths, batch=2, as_uint8=True)
    want = np.round((ref.numpy() + 1.0) * 127.5).clip(0, 255)
    assert isinstance(u8, np.ndarray) and u8.dtype == np.uint8
    assert u8.shape == (3, S, S, 3)
    assert np.abs(u8.astype(int) - want).max() <= 1

    i420 = imit.inference_from_paths(paths, batch=2, as_i420=True)
    assert i420.shape == (3, S * 3 // 2, S) and i420.dtype == np.uint8
    diff = np.abs(i420.astype(int)
                  - tcs.rgb_to_i420(ref).numpy().astype(int))
    assert diff.max() <= 1


def test_stream_infer_ingests_i420_and_refuses_an_empty_stream(stream):
    imit = stream["imit"]
    rng = np.random.default_rng(11)
    rgb = torch.from_numpy(rng.uniform(-1, 1, (2, 224, 224, 3))
                           .astype(np.float32))
    packed = tcs.rgb_to_i420(rgb).numpy()
    got = imit._stream_infer(iter([packed]), imit.regress_smpl_i420, None,
                             "smooth", False, False)
    want = imit.inference(tcs.i420_to_rgb_device(torch.from_numpy(packed)),
                          batch=2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="no frames"):
        imit._stream_infer(iter([]), imit.regress_smpl_u8, None, "smooth",
                           True, False)
    with pytest.raises(ValueError, match="no frames"):
        imit.inference_from_paths([])


def test_inference_from_paths_matches_jax(stream, assets):
    imit, paths = stream["imit"], stream["paths"]
    got = imit.inference_from_paths(paths, batch=2).numpy()
    jcfg = config.TestConfig(image_size=S, repeat_num=REPEAT,
                             compute_dtype="float32")
    jimit = JI.Imitator(jcfg, assets=assets, nets=stream["jnets"])
    jimit.personalize(stream["src_img"], src_smpl=stream["theta"])
    want = np.asarray(jimit.inference_from_paths(paths, batch=2))
    np.testing.assert_allclose(imit.first_cam.numpy(),
                               np.asarray(jimit.first_cam), atol=1e-5)
    assert got.shape == want.shape == (3, S, S, 3)
    np.testing.assert_allclose(got, want, atol=1e-2)
