"""The port's entry points end to end on the CPU (``--device cpu``, 64²,
repeat 2), mirroring the JAX package's tests/test_cli.py: run_imitator
(with and without --i420, and --post_tune with a face net read from a
flax msgpack), run_swap, run_view (with and without --T_pose), the
three demos, and serve over real HTTP on an ephemeral port. Without
--device the CLIs ask for CUDA and fail where there is none."""

import base64
import http.client
import json
import os
import threading

import numpy as np
import pytest
import torch

from impersonator_tpu_torch.cli import (demos, run_imitator, run_swap,
                                        run_view, serve)
from impersonator_tpu_torch.config import TestConfig as TConfig
from impersonator_tpu_torch.data import native
from impersonator_tpu_torch.models.facenet import Sphere20a, init_facenet
from torch_threads import one_torch_thread  # noqa: F401

S = 64


@pytest.fixture(scope="module")
def img_files(tmp_path_factory):
    """A source JPEG and a directory of two target JPEGs, written with the
    port's own encoder (no OpenCV)."""
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    tgt = d / "tgt"
    tgt.mkdir()
    paths = [d / "src.jpg"] + [tgt / f"{i:03d}.jpg" for i in range(2)]
    for p in paths:
        img = rng.uniform(0, 255, (96, 80, 3)).astype(np.uint8)
        img[20:40, 30:50] = (200, 150, 120)             # a head
        img[40:85, 28:52] = (90, 90, 160)               # a torso
        p.write_bytes(native.encode_jpeg(img, device="cpu"))
    return str(paths[0]), str(tgt)


def _common(tmp_path, name="smoke"):
    return ["--image_size", str(S), "--repeat_num", "2", "--device", "cpu",
            "--checkpoints_dir", str(tmp_path / "ckpt"),
            "--output_dir", str(tmp_path / "out"), "--name", name]


def _decodes(path):
    img = native.read_image(str(path), "cpu")
    return img.shape == (S, S, 3)


@pytest.mark.parametrize("i420", [False, True])
def test_run_imitator_cli(img_files, tmp_path, i420):
    src, tgt = img_files
    preds = run_imitator.main(
        ["--src_path", src, "--tgt_path", tgt, "--batch", "2",
         "--data_parallel"] + (["--i420"] if i420 else [])
        + _common(tmp_path))
    assert preds.shape == (2, S, S, 3) and preds.dtype == np.uint8
    outs = sorted(os.listdir(tmp_path / "out"))
    assert outs == ["pred_000.jpg", "pred_001.jpg"]
    assert all(_decodes(tmp_path / "out" / o) for o in outs)


def test_run_imitator_post_tune_with_face(img_files, tmp_path):
    """--post_tune --face_path: a Sphere20a msgpack in the JAX package's
    layout (flax's serializer over tools/convert_weights.py's tree of a
    seeded port net) is read back into the same weights, and the tune
    runs with it, over two prior poses from a --prior_poses pickle (five
    steps, where the eight default priors take ten)."""
    import pickle

    from flax import serialization

    from tools import convert_weights as cw
    net = Sphere20a()
    init_facenet(net, torch.Generator().manual_seed(0))
    fpath = tmp_path / "sphere.msgpack"
    fpath.write_bytes(serialization.to_bytes(
        cw.convert_sphere(net.state_dict())))
    face = run_imitator.load_face_net(str(fpath), "cpu")
    want, got = net.state_dict(), face.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k

    priors = np.zeros((2, 85), np.float32)
    priors[:, 0] = 0.9
    priors[:, 3:75] = np.random.default_rng(1).normal(0, 0.1, (2, 72))
    ppath = tmp_path / "priors.pkl"
    ppath.write_bytes(pickle.dumps(priors))
    src, tgt = img_files
    preds = run_imitator.main(
        ["--src_path", src, "--tgt_path", tgt, "--batch", "2",
         "--post_tune", "--face_path", str(fpath),
         "--prior_poses", str(ppath)] + _common(tmp_path))
    assert preds.shape == (2, S, S, 3)
    assert len(os.listdir(tmp_path / "out")) == 2


def test_run_swap_cli(img_files, tmp_path):
    src, tgt_dir = img_files
    pred = run_swap.main(["--src_path", src, "--tgt_path",
                          os.path.join(tgt_dir, "000.jpg")]
                         + _common(tmp_path))
    assert pred.shape == (S, S, 3) and np.isfinite(pred).all()
    assert _decodes(tmp_path / "out" / "swap_result.png")


@pytest.mark.parametrize("t_pose", [False, True])
def test_run_view_cli(img_files, tmp_path, t_pose):
    src, _ = img_files
    preds = run_view.main(["--src_path", src] + (["--T_pose"] if t_pose
                                                 else [])
                          + _common(tmp_path), sweep=True, n_views=2)
    assert preds.shape == (2, S, S, 3)
    assert sorted(os.listdir(tmp_path / "out")) == ["view_000.png",
                                                    "view_001.png"]


@pytest.mark.parametrize("which", ["imitator", "swap", "view"])
def test_demos_cli(which, tmp_path):
    demos.main([which, "--frames", "2"] + _common(tmp_path, "demo"))
    outs = [o for o in os.listdir(tmp_path / "out") if o.endswith(".png")]
    assert outs and all(_decodes(tmp_path / "out" / o) for o in outs)


def test_cli_defaults_to_cuda(img_files, tmp_path):
    """Without --device the entry points ask for the card; where there is
    none they fail instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    src, tgt = img_files
    args = ["--src_path", src, "--tgt_path", tgt, "--image_size", str(S),
            "--repeat_num", "2", "--checkpoints_dir", str(tmp_path / "c"),
            "--output_dir", str(tmp_path / "out")]
    for main in (run_imitator.main, run_swap.main):
        with pytest.raises((RuntimeError, AssertionError)):
            main(args)
    assert not (tmp_path / "out").exists()


def test_serve_http_roundtrip():
    """healthz -> personalize (JPEG body + X-Smpl) -> imitate -> imitate_
    frames -> imitate_video (400 without ffmpeg) -> malformed bodies get
    400 and the next request still 200."""
    cfg = TConfig(image_size=S, repeat_num=2)
    service = serve.ImitatorService(cfg, batch=2, device="cpu")
    server = serve.make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def call(method, path, body=None, headers=None):
        c = http.client.HTTPConnection("127.0.0.1", server.server_port,
                                       timeout=600)
        c.request(method, path, body=body, headers=headers or {})
        resp = c.getresponse()
        return resp.status, resp.read()

    try:
        code, body = call("GET", "/healthz")
        health = json.loads(body)
        assert code == 200 and health["backend"] == "cpu"
        assert health["personalized"] is False

        rng = np.random.default_rng(0)
        img = rng.uniform(0, 255, (S, S, 3)).astype(np.uint8)
        jpg = native.encode_jpeg(img, device="cpu")
        code, _ = call("POST", "/imitate",
                       json.dumps({"smpls": np.zeros((1, 85)).tolist()}))
        assert code == 400                         # not personalised yet
        theta = np.zeros(85, np.float32)
        theta[0] = 0.9
        code, body = call("POST", "/personalize", jpg,
                          {"X-Smpl": ",".join(str(v) for v in theta)})
        assert code == 200 and json.loads(body)["ok"]

        smpls = np.tile(theta, (3, 1))
        smpls[:, 3:75] += rng.normal(0, 0.03, (3, 72)).astype(np.float32)
        code, body = call("POST", "/imitate",
                          json.dumps({"smpls": smpls.tolist()}))
        r = json.loads(body)
        assert code == 200 and len(r["frames"]) == 3
        frame = native.decode(base64.b64decode(r["frames"][0]), "cpu")
        assert frame.shape == (S, S, 3)

        b64 = base64.b64encode(jpg).decode("ascii")
        code, body = call("POST", "/imitate_frames",
                          json.dumps({"frames": [b64, b64]}))
        assert code == 200 and len(json.loads(body)["frames"]) == 2

        code, body = call("POST", "/imitate_video",
                          json.dumps({"smpls": smpls.tolist(), "fps": 5}))
        if serve.shutil.which("ffmpeg") is None:
            assert code == 400 and "ffmpeg" in json.loads(body)["error"]
        else:
            assert code == 200 and len(body) > 0

        for bad in (b"{not json", json.dumps({"smpls": [[1.0, 2.0]]})):
            code, body = call("POST", "/imitate", bad)
            assert code == 400 and not json.loads(body)["ok"]
        code, _ = call("POST", "/personalize", b"not an image")
        assert code == 400
        code, _ = call("POST", "/imitate",
                       json.dumps({"smpls": smpls[:1].tolist()}))
        assert code == 200
        code, body = call("GET", "/healthz")
        assert json.loads(body)["personalized"] is True
    finally:
        server.shutdown()
        thread.join(timeout=10)
        service.close()
    assert not thread.is_alive()
