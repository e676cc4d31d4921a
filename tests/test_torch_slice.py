"""The given-SMPL imitation slice end to end: the port's
Imitator.personalize + inference_by_smpls (torch, CPU, bucket raster
path through the kernels' plain twins) against the JAX production cores
personalize_core + imitate_with_swap_core (brute raster path off-TPU) on
the same weights and inputs, float32. Also: neither the port nor
chip_smoke.py imports JAX or any module of the JAX package.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from impersonator_tpu import config
from impersonator_tpu.models.generator import ImpersonatorGenerator as JGen
from impersonator_tpu.ops import smpl as jsmpl
from impersonator_tpu.tasks import imitator as JI
from impersonator_tpu.tasks.renderer import SMPLRenderer as JRenderer
from impersonator_tpu_torch.models.generator import \
    ImpersonatorGenerator as TGen
from impersonator_tpu_torch.ops import smpl as tsmpl
from impersonator_tpu_torch.tasks import imitator as TI
from tools import convert_weights as cw

import torch_ref
from torch_threads import one_torch_thread  # noqa: F401

S, CONV_DIM, REPEAT = 64, 8, 2
ROOT = Path(__file__).resolve().parent.parent


def test_imitation_slice_matches_jax(assets):
    rng = np.random.default_rng(21)
    sd = {**torch_ref.make_bg_sd(rng, 4, CONV_DIM, REPEAT),
          **torch_ref.make_resunet_sd(rng, "src_model", 6, CONV_DIM, REPEAT),
          **torch_ref.make_resunet_sd(rng, "tsf_model", 6, CONV_DIM, REPEAT)}
    cfg = config.TestConfig(image_size=S, repeat_num=REPEAT,
                            compute_dtype="float32")

    src_img = rng.uniform(-1, 1, (S, S, 3)).astype(np.float32)
    src_theta = np.zeros(85, np.float32)
    src_theta[0] = 0.9
    tgt = np.tile(src_theta, (3, 1))
    tgt[:, 1:3] += rng.uniform(-0.05, 0.05, (3, 2)).astype(np.float32)
    tgt[:, 3:75] += rng.normal(0, 0.08, (3, 72)).astype(np.float32)

    # --- port -------------------------------------------------------------
    tgen = TGen(conv_dim=CONV_DIM, repeat_num=REPEAT)
    tgen.load_state_dict(sd, strict=True)
    imit = TI.Imitator(cfg, assets=assets, nets=TI.ImitatorNets(tgen),
                       device="cpu")
    src_t = imit.personalize(src_img, src_smpl=src_theta)
    preds_t = imit.inference_by_smpls(tgt, batch=2)
    assert imit.renderer._bucket_config() is not None  # the kernel path

    # --- JAX production cores -------------------------------------------
    jgen = JGen(bg_dim=4, src_dim=6, tsf_dim=6, conv_dim=CONV_DIM,
                repeat_num=REPEAT)
    nets = JI.ImitatorNets(jgen, cw.convert_generator(sd, repeat=REPEAT),
                           None, None, None, None)
    renderer = JRenderer.create(assets, image_size=S, map_name="uv_seg")
    params = jsmpl.SMPLParams.from_assets(assets)
    src_j = jax.jit(lambda: JI.personalize_core(
        nets, renderer, params, assets.parents,
        jnp.asarray(src_img)[None], jnp.asarray(src_theta)[None],
        bg_ks=cfg.bg_ks, ft_ks=cfg.ft_ks))()
    step = jax.jit(lambda c, first: JI.imitate_with_swap_core(
        nets, renderer, params, assets.parents, src_j, c, first))
    tgt_pad = np.concatenate([tgt, tgt[-1:]])
    first = jnp.asarray(tgt[0:1, 0:3])
    preds_j = np.concatenate([np.asarray(step(jnp.asarray(tgt_pad[i:i + 2]),
                                              first))
                              for i in (0, 2)])[:3]

    # personalisation: raster products exact, BG stream close
    np.testing.assert_array_equal(src_t["fim"].numpy(),
                                  np.asarray(src_j["fim"]))
    np.testing.assert_allclose(src_t["p2verts"].numpy(),
                               np.asarray(src_j["p2verts"]), atol=1e-5)
    np.testing.assert_allclose(src_t["bg"].numpy(), np.asarray(src_j["bg"]),
                               atol=5e-3)

    # the targets' face-index maps: port fused kernel path vs JAX brute
    tsf_t = TI.swap_smpl(src_t["cam"], src_t["shape"], torch.from_numpy(tgt),
                         torch.from_numpy(tgt[0:1, 0:3]))
    info_t = tsmpl.get_details(imit.smpl_params, tsf_t, assets.parents)
    fim_t, _ = imit.renderer.render_flow(info_t["cam"], info_t["verts"],
                                         src_t["p2verts"])
    tsf_j = JI.swap_smpl(src_j["cam"], src_j["shape"], jnp.asarray(tgt),
                         first)
    info_j = jsmpl.get_details(params, tsf_j, assets.parents)
    _, fim_j, _ = renderer.render_fim_wim(info_j["cam"], info_j["verts"])
    np.testing.assert_array_equal(fim_t.numpy(), np.asarray(fim_j))
    assert (fim_t.numpy() >= 0).mean() > 0.02

    assert preds_t.shape == (3, S, S, 3) and preds_t.dtype == torch.float32
    np.testing.assert_allclose(preds_t.numpy(), preds_j, atol=1e-2)


PORT_MODULES = [
    "impersonator_tpu_torch",
    "impersonator_tpu_torch.ops.cuda_raster",
    "impersonator_tpu_torch.ops.cuda_warp",
    "impersonator_tpu_torch.ops.flow",
    "impersonator_tpu_torch.ops.morphology",
    "impersonator_tpu_torch.ops.projection",
    "impersonator_tpu_torch.ops.rasterizer",
    "impersonator_tpu_torch.ops.sampler",
    "impersonator_tpu_torch.ops.smpl",
    "impersonator_tpu_torch.models.layers",
    "impersonator_tpu_torch.models.generator",
    "impersonator_tpu_torch.models.hmr",
    "impersonator_tpu_torch.models.inpaintor",
    "impersonator_tpu_torch.models.facenet",
    "impersonator_tpu_torch.models.losses",
    "impersonator_tpu_torch.tasks.renderer",
    "impersonator_tpu_torch.tasks.imitator",
    "impersonator_tpu_torch.tasks.swapper",
    "impersonator_tpu_torch.tasks.viewer",
    "impersonator_tpu_torch.tasks.animator",
    "impersonator_tpu_torch.tasks.factory",
    "impersonator_tpu_torch.tasks.post_tune",
    "impersonator_tpu_torch.tasks.trainer",
    "impersonator_tpu_torch.models.discriminator",
    "impersonator_tpu_torch.data.datasets",
    "impersonator_tpu_torch.data.loader",
    "impersonator_tpu_torch.utils.checkpoint",
    "impersonator_tpu_torch.utils.visualizer",
    "impersonator_tpu_torch.cli.train",
    "impersonator_tpu_torch.cli.run_imitator",
    "impersonator_tpu_torch.cli.run_swap",
    "impersonator_tpu_torch.cli.run_view",
    "impersonator_tpu_torch.cli.serve",
    "impersonator_tpu_torch.cli.demos",
    "impersonator_tpu_torch.ops.colorspace",
    "impersonator_tpu_torch.data.native",
    "impersonator_tpu_torch.utils.native_build",
    "impersonator_tpu_torch.utils.video",
    "impersonator_tpu_torch.utils.profiling",
    "impersonator_tpu_torch.utils.mesh_io",
    "impersonator_tpu_torch.utils.convert",
    "impersonator_tpu_torch.utils.cv_utils",
    "impersonator_tpu_torch.utils.precision",
    "impersonator_tpu_torch.assets",
    "impersonator_tpu_torch.config",
    "impersonator_tpu_torch.models",
    "impersonator_tpu_torch.models.baseline",
    "impersonator_tpu_torch.ops.soft_raster",
    "impersonator_tpu_torch.tasks.trainer_aug",
    "impersonator_tpu_torch.tasks.trainer_baseline",
    "impersonator_tpu_torch.scenes",
    "impersonator_tpu_torch.metrics",
    "impersonator_tpu_torch.metrics.metrics",
    "impersonator_tpu_torch.metrics.unpaired",
    "impersonator_tpu_torch.metrics.zoo",
    "impersonator_tpu_torch.metrics.reid",
    "impersonator_tpu_torch.metrics.protocols",
    "impersonator_tpu_torch.metrics.mtcnn",
    "impersonator_tpu_torch.metrics.yolo",
    "impersonator_tpu_torch.cli.evaluate",
    "impersonator_tpu_torch.parallel",
    "impersonator_tpu_torch.parallel.mesh",
    "impersonator_tpu_torch.parallel.distributed",
    "impersonator_tpu_torch.utils.detectors",
    "impersonator_tpu_torch.ops",
    "impersonator_tpu_torch.tasks",
    "impersonator_tpu_torch.data",
    "impersonator_tpu_torch.tools",
    "impersonator_tpu_torch.tools.convert_weights",
    "impersonator_tpu_torch.tools.prepare_iper",
    "impersonator_tpu_torch.tools.make_prior_poses",
    "impersonator_tpu_torch.tools.visual_iper",
    "impersonator_tpu_torch.tools.parity_harness",
    "impersonator_tpu_torch.tools.posttune_artifact",
    "impersonator_tpu_torch.tools.trainconv_artifact",
]


def _chip_smoke_imports():
    """Every module chip_smoke.py imports, at top level or inside its
    functions."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module)
            mods.update(f"{node.module}.{a.name}" for a in node.names)
    return sorted(mods)


def test_port_imports_no_jax():
    """Every port module, and everything chip_smoke.py imports, loads
    without JAX, flax, the msgpack package (the card's host has none) or
    any module of the JAX package."""
    mods = PORT_MODULES + _chip_smoke_imports()
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    try:\n"
        "        importlib.import_module(m)\n"
        "    except ModuleNotFoundError:\n"
        "        pass  # a name imported from a module, not a module\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'msgpack', 'impersonator_tpu'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "impersonator_tpu_torch.tasks.imitator" in mods
    assert "impersonator_tpu_torch.tasks.swapper" in mods
    tools = Path(ROOT, "impersonator_tpu_torch", "tools")
    assert {f"impersonator_tpu_torch.tools.{p.stem}"
            for p in tools.glob("*.py") if p.stem != "__init__"} <= set(mods)
