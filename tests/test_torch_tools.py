"""The port's tools (``impersonator_tpu_torch/tools``) against the repo's
JAX tools (``tools/``) on the CPU, at a small size, each pair run on the
same files:

* ``convert_weights``: the same output bytes as the JAX CLI for released
  layouts of the generator, Sphere20a (with fc6), SENet50's pickle,
  LPIPS (lin heads and a torchvision alexnet) and MTCNN (a directory of
  three ``.pt`` files); exact;
* ``prepare_iper``: the same frame folders from the same videos (both
  tools' ``video_to_frames`` replaced by one stub, as the CPU host has no
  ffmpeg); exact;
* ``make_prior_poses``: the pickles from three PNGs through one HMR
  msgpack (written by the port's ``write_flax_msgpack``, read by the JAX
  tool through flax) within 1e-4 of the largest value (float32 convs
  summed in other orders; measured ~2e-6);
* ``visual_iper`` at 64² with a given ``--smpl_pkl``: the fim of each
  batch equal to the JAX renderer's, the debug render and silhouette
  within 1e-5, and the written triptychs within one level of 255 (the
  quantisation of nearly equal floats).
The parity harness and the two artifacts are in
``test_torch_tools_harness.py`` and ``test_torch_tools_artifacts.py``."""

import os
import pickle
import sys

import cv2
import numpy as np
import pytest
import torch

import torch_ref
from impersonator_tpu_torch.models.hmr import HumanModelRecovery, init_hmr
from impersonator_tpu_torch.utils import convert as C
from impersonator_tpu_torch.utils.checkpoint import (read_flax_msgpack,
                                                     write_flax_msgpack)
from impersonator_tpu_torch.utils.visualizer import write_png
from torch_threads import one_torch_thread  # noqa: F401

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "impersonator_tpu",
                       "weights")


def _jax_cli(monkeypatch, module, args):
    """Run a JAX tool's argv-reading main with ``args``."""
    monkeypatch.setattr(sys, "argv", [module.__file__] + list(args))
    return module.main()


def _released(kind, tmp):
    """(src argument, extra CLI args) of a seeded released file of kind."""
    rng = np.random.default_rng(71)
    if kind == "gen":
        # the CLI converts the released depth: 6 residual blocks
        sd = {**torch_ref.make_bg_sd(rng, 4, 4, 6),
              **torch_ref.make_resunet_sd(rng, "src_model", 6, 4, 6),
              **torch_ref.make_resunet_sd(rng, "tsf_model", 6, 4, 6)}
    elif kind == "sphere":
        from impersonator_tpu_torch.models.facenet import Sphere20a
        g = torch.Generator().manual_seed(72)
        sd = {k: torch.randn(v.shape, generator=g)
              for k, v in Sphere20a().state_dict().items()}
        sd["fc6.weight"] = torch.randn(512, 16, generator=g)
    elif kind == "senet50":
        sd = torch_ref.make_senet50_sd(rng)
        raw = {k: v.numpy() for k, v in sd.items()}
        raw["fc.weight"] = np.ones((8, 2048), np.float32)
        path = os.path.join(tmp, "senet50.pkl")
        with open(path, "wb") as f:
            pickle.dump(raw, f)
        return path, []
    elif kind == "lpips":
        lin = os.path.join(tmp, "alex.pth")
        torch.save(torch_ref.make_lpips_lin_sd(rng), lin)
        back = os.path.join(tmp, "alexnet.pth")
        torch.save({**torch_ref.make_alexnet_sd(rng),
                    "classifier.1.weight": torch.ones(4, 9216)}, back)
        return lin, ["--src2", back, "--net", "alex"]
    else:
        assert kind == "mtcnn"
        sds = C.mtcnn_state_dicts_from_jax(read_flax_msgpack(
            os.path.join(WEIGHTS, "mtcnn_pro.msgpack")))
        d = os.path.join(tmp, "mtcnn")
        os.makedirs(d)
        for name, sd in sds.items():
            torch.save(sd, os.path.join(d, f"{name}.pt"))
        return d, []
    path = os.path.join(tmp, f"{kind}.pth")
    torch.save(sd, path)
    return path, []


@pytest.mark.parametrize("kind", ["gen", "sphere", "senet50", "lpips",
                                  "mtcnn"])
def test_convert_weights_cli_bytes_match_jax_cli(kind, tmp_path,
                                                 monkeypatch):
    from impersonator_tpu_torch.tools import convert_weights as port
    from tools import convert_weights as jax_cli
    src, extra = _released(kind, str(tmp_path))
    out_j, out_t = str(tmp_path / "j.msgpack"), str(tmp_path / "t.msgpack")
    _jax_cli(monkeypatch, jax_cli, [kind, src, out_j] + extra)
    port.main([kind, src, out_t] + extra)
    got, want = open(out_t, "rb").read(), open(out_j, "rb").read()
    assert len(want) > 1000 and got == want


def test_convert_weights_cli_refuses_a_file_that_does_not_load(tmp_path):
    """A state dict missing a tensor the module needs fails the strict
    load before anything is written."""
    from impersonator_tpu_torch.tools import convert_weights as port
    sd = torch_ref.make_senet50_sd(np.random.default_rng(73))
    sd["layer4.2.conv5.weight"] = torch.ones(3, 3, 1, 1)
    path = str(tmp_path / "bad.pth")
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="size mismatch"):
        port.main(["senet50", path, str(tmp_path / "o.msgpack")])
    assert not (tmp_path / "o.msgpack").exists()


def test_prepare_iper_matches_jax_tool(tmp_path, monkeypatch):
    import impersonator_tpu_torch.tools.prepare_iper as port
    from tools import prepare_iper as jax_tool

    def stub(path, out_dir, fps=None):
        os.makedirs(out_dir, exist_ok=True)
        n = 2 + len(os.path.basename(path)) % 3 + (fps or 0) // 25
        for i in range(n):
            open(os.path.join(out_dir, f"frame_{i + 1:08d}.png"), "w").close()
        return sorted(os.listdir(out_dir))

    vids = tmp_path / "videos"
    vids.mkdir()
    for name in ("001_1_1", "002_10_2", "odd", "003_1_1_extra"):
        (vids / f"{name}.mp4").write_bytes(b"")
    (vids / "notes.txt").write_text("")
    monkeypatch.setattr(port, "video_to_frames", stub)
    monkeypatch.setattr(jax_tool, "video_to_frames", stub)
    trees = []
    for run, out in ((lambda a: _jax_cli(monkeypatch, jax_tool, a), "j"),
                     (port.main, "t")):
        root = tmp_path / out
        (root / "001" / "1" / "1").mkdir(parents=True)
        (root / "001" / "1" / "1" / "kept.png").write_text("")  # skipped
        run(["--video_dir", str(vids), "--out_dir", str(root), "--fps",
             "25"])
        trees.append(sorted(str(p.relative_to(root))
                            for p in root.rglob("*")))
    assert trees[0] == trees[1] and len(trees[0]) > 10


def _pngs(folder, n, size, seed):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        write_png(os.path.join(folder, f"{i:03d}.png"),
                  rng.integers(0, 256, (size, size + 8, 3), dtype=np.uint8))


def test_make_prior_poses_matches_jax_tool(tmp_path):
    from impersonator_tpu_torch.tools import make_prior_poses as port
    from tools import make_prior_poses as jax_tool
    _pngs(str(tmp_path / "imgs"), 3, 80, 74)
    hmr = HumanModelRecovery()
    init_hmr(hmr, torch.Generator().manual_seed(75), np.zeros(85),
             fc3_scale=1.0)
    ckpt = write_flax_msgpack(C.hmr_to_jax(hmr.state_dict()),
                              str(tmp_path / "hmr.msgpack"))
    args = ["--img_dir", str(tmp_path / "imgs"), "--hmr_ckpt", ckpt,
            "--itv", "1", "--batch", "2"]
    jax_tool.main(args + ["--out", str(tmp_path / "j.pkl")])
    port.main(args + ["--out", str(tmp_path / "t.pkl"), "--device", "cpu"])
    with open(tmp_path / "j.pkl", "rb") as f:
        want = pickle.load(f)
    with open(tmp_path / "t.pkl", "rb") as f:
        got = pickle.load(f)
    assert list(got) == list(want) == ["cams", "pose", "shape"]
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        gap = np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
        assert gap <= 1e-4, (k, gap)


def test_visual_iper_matches_jax_tool(tmp_path):
    import jax.numpy as jnp

    from impersonator_tpu import assets as jassets
    from impersonator_tpu.ops import rasterizer as jrast
    from impersonator_tpu.ops import smpl as jsmpl
    from impersonator_tpu.tasks.renderer import SMPLRenderer as JRenderer
    from impersonator_tpu_torch import assets as tassets
    from impersonator_tpu_torch.ops import smpl as tsmpl
    from impersonator_tpu_torch.tasks.renderer import SMPLRenderer
    from impersonator_tpu_torch.tools import visual_iper as port
    from tools import visual_iper as jax_tool

    s, n = 64, 3
    _pngs(str(tmp_path / "frames"), n, s, 76)
    rng = np.random.default_rng(77)
    th = np.zeros((n, 85), np.float32)
    th[:, 0] = 0.9
    th[:, 3:75] = rng.normal(0, 0.1, (n, 72))
    pkl = str(tmp_path / "pose_shape.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"cams": th[:, :3], "pose": th[:, 3:75],
                     "shape": th[:, 75:]}, f)
    args = ["--frames_dir", str(tmp_path / "frames"), "--smpl_pkl", pkl,
            "--image_size", str(s), "--batch", "2"]
    jax_tool.main(args + ["--out_dir", str(tmp_path / "j")])
    port.main(args + ["--out_dir", str(tmp_path / "t"), "--device", "cpu"])
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == n
    for name in names:
        a = cv2.imread(str(tmp_path / "t" / name)).astype(np.int32)
        b = cv2.imread(str(tmp_path / "j" / name)).astype(np.int32)
        assert a.shape == b.shape == (s, 3 * s, 3)
        assert np.abs(a - b).max() <= 1, name

    # one batch's renders, the JAX tool's render_batch spelled out
    ja = jassets.synthetic_assets()
    jr = JRenderer.create(ja, image_size=s)
    info = jsmpl.get_details(jsmpl.SMPLParams.from_assets(ja),
                             jnp.asarray(th), ja.parents)
    f2v, fim_j, wim_j = jr.render_fim_wim(info["cam"], info["verts"])
    rgb_j = jr.render_textured(fim_j, wim_j, jnp.ones(
        (n, f2v.shape[1], jr.tex_size ** 2, 3), jnp.float32))
    sil_j = jrast.render_silhouette(fim_j)
    ta = tassets.synthetic_assets()
    fim_t, rgb_t, sil_t = port.render_batch(
        SMPLRenderer.create(ta, "cpu", image_size=s),
        tsmpl.SMPLParams.from_assets(ta, "cpu"), ta.parents,
        torch.from_numpy(th))
    np.testing.assert_array_equal(fim_t.numpy(), np.asarray(fim_j))
    assert (fim_t.numpy() >= 0).mean() > 0.02
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=1e-5)
    np.testing.assert_array_equal(sil_t.numpy(), np.asarray(sil_j))


def test_parity_harness_reads_lpips_heads_as_pth_or_msgpack(tmp_path):
    """The harness' --lpips_ckpt: a released lin-head .pth and the msgpack
    the port's converter makes of it give the same LPIPS (the lin heads
    over cli.evaluate's seeded backbone); exact."""
    from impersonator_tpu_torch.tools import convert_weights as port
    from impersonator_tpu_torch.tools import parity_harness as ph
    pth, out = str(tmp_path / "alex.pth"), str(tmp_path / "alex.msgpack")
    torch.save(torch_ref.make_lpips_lin_sd(np.random.default_rng(78)), pth)
    port.main(["lpips", pth, out])
    a = ph.load_lpips(pth, "cpu").state_dict()
    b = ph.load_lpips(out, "cpu").state_dict()
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("name,args", [
    ("make_prior_poses", ["--img_dir", ".", "--out", "p.pkl"]),
    ("visual_iper", ["--frames_dir", ".", "--out_dir", "qa"]),
    ("parity_harness", ["--src_path", "s.png", "--tgt_path", ".",
                        "--ref_dir", "."]),
    ("posttune_artifact", []),
    ("trainconv_artifact", []),
])
def test_tools_ask_for_the_card_by_default(name, args, monkeypatch):
    """Without --device each card tool asks for CUDA and fails where
    there is none, before it reads or writes anything."""
    import importlib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tool = importlib.import_module(f"impersonator_tpu_torch.tools.{name}")
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main(args)
