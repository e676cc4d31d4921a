"""The port's parity harness (``impersonator_tpu_torch/tools/
parity_harness.py``) against the repo's JAX one on the CPU: both run on
the same files, a 64² source PNG, two target PNGs and two reference
``pred_*`` PNGs, with a full-width generator, HMR and an LPIPS tree
(lin heads with an alexnet backbone) written by the port's
``write_flax_msgpack`` and read by the JAX tool through flax. The JAX
tool's TestConfig is asked for float32 compute (its default, bfloat16,
rounds too coarsely for these bounds) and the port runs with
``--compute_dtype float32``. Every per-frame and aggregate number of the
two JSONs within ``cli.evaluate``'s bounds against JAX
(``tests/test_torch_evaluate.py``: ssim, lps 1e-5, psnr 1e-4 dB;
measured 1.9e-7, 5.7e-7, 1.0e-6)."""

import json
import sys

import numpy as np
import torch

import torch_ref
from impersonator_tpu_torch.models.generator import ImpersonatorGenerator
from impersonator_tpu_torch.models.hmr import HumanModelRecovery, init_hmr
from impersonator_tpu_torch.models.layers import init_weights
from impersonator_tpu_torch.utils import convert as C
from impersonator_tpu_torch.utils.checkpoint import write_flax_msgpack
from impersonator_tpu_torch.utils.visualizer import write_png
from torch_threads import one_torch_thread  # noqa: F401

BOUNDS = {"ssim": 1e-5, "psnr": 1e-4, "lps": 1e-5}


def test_parity_harness_matches_jax_tool(tmp_path, monkeypatch, capsys):
    import impersonator_tpu.config as jconfig
    from impersonator_tpu_torch.tools import parity_harness as port
    from tools import parity_harness as jax_tool

    rng = np.random.default_rng(81)
    for d in ("tgt", "ref"):
        (tmp_path / d).mkdir()

    def png(path):
        write_png(str(path), rng.integers(0, 256, (64, 64, 3),
                                          dtype=np.uint8))

    png(tmp_path / "src.png")
    for i in range(2):
        png(tmp_path / "tgt" / f"{i:03d}.png")
        png(tmp_path / "ref" / f"pred_{i:03d}.png")
    gen = ImpersonatorGenerator()
    init_weights(gen, torch.Generator().manual_seed(82))
    hmr = HumanModelRecovery()
    init_hmr(hmr, torch.Generator().manual_seed(83), np.zeros(85),
             fc3_scale=5e-5)
    lin, back = (torch_ref.make_lpips_lin_sd(rng),
                 torch_ref.make_alexnet_sd(rng))
    files = {name: write_flax_msgpack(tree, str(tmp_path / f"{name}.msgpack"))
             for name, tree in (("gen", C.generator_to_jax(gen.state_dict())),
                                ("hmr", C.hmr_to_jax(hmr.state_dict())),
                                ("lpips", C.lpips_to_jax(lin, back)))}
    args = ["--src_path", str(tmp_path / "src.png"),
            "--tgt_path", str(tmp_path / "tgt"),
            "--ref_dir", str(tmp_path / "ref"),
            "--gen_ckpt", files["gen"], "--hmr_ckpt", files["hmr"],
            "--lpips_ckpt", files["lpips"], "--image_size", "64"]

    base = jconfig.TestConfig
    monkeypatch.setattr(jconfig, "TestConfig",
                        lambda **kw: base(compute_dtype="float32", **kw))
    monkeypatch.setattr(sys, "argv", ["parity_harness"] + args)
    jax_tool.main()
    want = json.loads(capsys.readouterr().out)
    got = port.main(args + ["--device", "cpu", "--compute_dtype", "float32"])
    assert got["aggregate"]["frames"] == want["aggregate"]["frames"] == 2
    for k, v in want["aggregate"].items():
        if k != "frames":
            assert abs(got["aggregate"][k] - v) <= BOUNDS[k.split("_")[0]], k
    assert [r["frame"] for r in got["per_frame"]] == \
        [r["frame"] for r in want["per_frame"]]
    for g, w in zip(got["per_frame"], want["per_frame"]):
        assert list(g) == list(w) == ["frame", "ssim", "psnr", "lps"]
        for k in BOUNDS:
            assert abs(g[k] - w[k]) <= BOUNDS[k], (g["frame"], k, g[k], w[k])
