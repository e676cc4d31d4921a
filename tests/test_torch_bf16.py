"""The port against the JAX package under the bf16 compute dtype, and one
float32 comparison at production width.

* the sampler in bf16: the JAX package's ``grid_sample`` and
  ``grid_sample_patched`` element for element;
* imitation (given SMPL), ``swap`` and ``view_by_smpls`` with
  ``compute_dtype="bfloat16"`` in both packages (64², conv_dim 8, 2
  residual blocks, the same weights carried across), with the task's
  dtype policy: the Imitator personalises in bf16, the Swapper and Viewer
  in float32 with the master weights;
* the float32 master: a bf16 task leaves the ImitatorNets it was given
  bit-identical, and a float32 task after it gives a fresh one's preds;
* float32 imitation at 256², conv_dim 64, 6 residual blocks, batch 1.

The bf16 bounds are what the repaired port measures here: a bf16
generator with these random weights is itself ~0.1 from its float32
run, and the two packages' convolutions round a few outputs in 10^4 to
another bf16 neighbour, so their preds differ by about as much as
either differs from float32 at the worst pixel; the mean gap is the
finer check.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impersonator_tpu import config
from impersonator_tpu.models import HumanModelRecovery as JHMR
from impersonator_tpu.models.generator import ImpersonatorGenerator as JGen
from impersonator_tpu.ops import sampler as jsampler
from impersonator_tpu.ops import smpl as jsmpl
from impersonator_tpu.tasks import imitator as JI
from impersonator_tpu.tasks import swapper as JS
from impersonator_tpu.tasks.viewer import Viewer as JViewer
from impersonator_tpu_torch import assets as tassets
from impersonator_tpu_torch.config import TestConfig as TConfig
from impersonator_tpu_torch.models.generator import \
    ImpersonatorGenerator as TGen
from impersonator_tpu_torch.ops import sampler as tsampler
from impersonator_tpu_torch.tasks import imitator as TI
from impersonator_tpu_torch.tasks import swapper as TS
from impersonator_tpu_torch.tasks import viewer as TV
from tools import convert_weights as cw

import torch_ref
from torch_threads import one_torch_thread  # noqa: F401

S, CONV_DIM, REPEAT = 64, 8, 2


def _weights(seed, conv_dim=CONV_DIM, repeat=REPEAT):
    rng = np.random.default_rng(seed)
    return {**torch_ref.make_bg_sd(rng, 4, conv_dim, repeat),
            **torch_ref.make_resunet_sd(rng, "src_model", 6, conv_dim, repeat),
            **torch_ref.make_resunet_sd(rng, "tsf_model", 6, conv_dim,
                                        repeat)}


def _port_nets(sd, conv_dim=CONV_DIM, repeat=REPEAT):
    gen = TGen(conv_dim=conv_dim, repeat_num=repeat)
    gen.load_state_dict(sd, strict=True)
    return TI.ImitatorNets(gen)


def _jax_nets(sd, conv_dim=CONV_DIM, repeat=REPEAT):
    gen = JGen(bg_dim=4, src_dim=6, tsf_dim=6, conv_dim=conv_dim,
               repeat_num=repeat)
    return JI.ImitatorNets(gen, cw.convert_generator(sd, repeat=repeat),
                           JHMR(), None, None, None)


def _cfgs(dtype, s=S, repeat=REPEAT):
    return (TConfig(image_size=s, repeat_num=repeat, compute_dtype=dtype),
            config.TestConfig(image_size=s, repeat_num=repeat,
                              compute_dtype=dtype))


def _theta(rng, cam=0.9, pose=0.0):
    t = np.zeros(85, np.float32)
    t[0] = cam
    if pose:
        t[3:75] = rng.normal(0, pose, 72)
    return t


def _poses(theta, seed, n=3):
    rng = np.random.default_rng(seed)
    tgt = np.tile(theta, (n, 1))
    tgt[:, 3:75] += rng.normal(0, 0.08, (n, 72)).astype(np.float32)
    return tgt


def _gap(port, ref):
    d = np.abs(port.float().numpy() - np.asarray(ref))
    return float(d.max()), float(d.mean())


# -- the sampler -------------------------------------------------------------

@pytest.mark.parametrize("ref", ["grid_sample", "grid_sample_patched"])
@pytest.mark.parametrize("batch", [1, 4])
def test_bf16_sampler_equals_jax(ref, batch):
    """A 64² 16-channel bf16 image (batch 1, expanded; or one per grid)
    warped by 4 flows in [-1.1, 1.1] with background rows: every element
    equal."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (batch, S, S, 16)).astype(np.float32)
    grid = rng.uniform(-1.1, 1.1, (4, S, S, 2)).astype(np.float32)
    grid[0, :8] = -2.0
    out_j = getattr(jsampler, ref)(jnp.asarray(x, jnp.bfloat16),
                                   jnp.asarray(grid))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    out_t = tsampler.grid_sample(xt, torch.from_numpy(grid))
    assert out_t.dtype == torch.bfloat16 and out_t.shape == (4, S, S, 16)
    np.testing.assert_array_equal(out_t.float().numpy(),
                                  np.asarray(out_j.astype(jnp.float32)))
    nchw = tsampler.grid_sample_nchw(xt.permute(0, 3, 1, 2).contiguous(),
                                     torch.from_numpy(grid))
    np.testing.assert_array_equal(nchw.permute(0, 2, 3, 1).float().numpy(),
                                  np.asarray(out_j.astype(jnp.float32)))


# -- the tasks in bf16 ---------------------------------------------------------

@pytest.fixture(scope="module")
def bf16_tasks(assets):
    """Both packages' Imitator, Swapper and Viewer in bf16, personalised
    on the same images and θs."""
    sd = _weights(31)
    tcfg, jcfg = _cfgs("bfloat16")
    ta = tassets.synthetic_assets()
    rng = np.random.default_rng(8)
    imgs = [np.random.default_rng(9 + i).uniform(-1, 1, (S, S, 3))
            .astype(np.float32) for i in range(2)]
    src_theta = _theta(rng)
    tgt_theta = _theta(rng, 0.85, 0.1)
    tgt_theta[1:3] = (0.03, -0.02)
    view_theta = _theta(rng, 0.9, 0.05)
    out = {}
    for name, port_cls, ref_cls in (("imitator", TI.Imitator, JI.Imitator),
                                     ("swapper", TS.Swapper, JS.Swapper),
                                     ("viewer", TV.Viewer, JViewer)):
        port = port_cls(tcfg, assets=ta, nets=_port_nets(sd), device="cpu")
        ref = ref_cls(jcfg, assets=assets, nets=_jax_nets(sd))
        for task in (port, ref):
            if name == "swapper":
                task.swap_setup(imgs[0], imgs[1], src_theta, tgt_theta)
            elif name == "viewer":
                task.personalize(imgs[1], view_theta)
            else:
                task.personalize(imgs[0], src_smpl=src_theta)
        out[name] = port, ref
    return out, src_theta


def test_bf16_source_features_follow_the_task(bf16_tasks):
    """The Imitator caches bf16 features; the Swapper's two states and the
    Viewer's cache float32 ones, computed by the float32 master."""
    tasks, _ = bf16_tasks
    states = {"imitator": [tasks["imitator"][0].src_info],
              "swapper": [tasks["swapper"][0].src_info,
                          tasks["swapper"][0].tsf_info],
              "viewer": [tasks["viewer"][0].src_info]}
    for name, sts in states.items():
        want = torch.bfloat16 if name == "imitator" else torch.float32
        for st in sts:
            enc, res = st["feats"]
            assert {t.dtype for t in enc + res} == {want}, name
            assert st["bg"].dtype == torch.float32
    assert tasks["imitator"][0].compute_nets.generator is not \
        tasks["imitator"][0].nets.generator


def test_bf16_imitation_matches_jax(bf16_tasks):
    tasks, src_theta = bf16_tasks
    port, ref = tasks["imitator"]
    tgt = _poses(src_theta, 12)
    preds_t = port.inference_by_smpls(tgt, batch=2)
    assert preds_t.dtype == torch.float32 and preds_t.shape == (3, S, S, 3)
    gap, mean = _gap(preds_t, ref.inference_by_smpls(tgt, batch=2))
    assert gap <= 0.1, gap            # measured 9.13e-2
    assert mean <= 7e-3, mean         # measured 6.52e-3


@pytest.mark.parametrize("part", ["body", "all"])
def test_bf16_swap_matches_jax(bf16_tasks, part):
    port, ref = bf16_tasks[0]["swapper"]
    gap, mean = _gap(port.swap(target_part=part),
                     ref.swap(target_part=part))
    # measured 8.84e-2 / 4.08e-3 (body), 8.46e-2 / 4.07e-3 (all); with
    # the bf16 personalisation 8.27e-2 / 7.61e-3, 8.41e-2 / 7.64e-3
    assert gap <= 0.1, gap
    assert mean <= 5e-3, mean


def test_bf16_view_by_smpls_matches_jax(bf16_tasks):
    port, ref = bf16_tasks[0]["viewer"]
    rng = np.random.default_rng(16)
    smpls = np.tile(np.asarray(ref.src_info["theta"])[0], (3, 1))
    smpls[:, 3:6] = rng.normal(0, 0.8, (3, 3)).astype(np.float32)
    gap, mean = _gap(port.view_by_smpls(smpls, batch=2),
                     ref.view_by_smpls(smpls, batch=2))
    assert gap <= 0.1, gap            # measured 7.74e-2
    assert mean <= 3.7e-3, mean       # measured 3.44e-3


# -- the float32 master --------------------------------------------------------

def test_bf16_task_leaves_the_master_bit_identical(assets):
    """The same ImitatorNets through a bf16 Imitator, then a float32 one:
    its parameters stay bit for bit, and the float32 preds equal those of
    a float32 Imitator on fresh nets."""
    sd = _weights(21)
    nets = _port_nets(sd)
    before = {k: v.clone() for k, v in nets.generator.state_dict().items()}
    ta = tassets.synthetic_assets()
    img = np.random.default_rng(4).uniform(-1, 1, (S, S, 3)) \
        .astype(np.float32)
    theta = _theta(np.random.default_rng(5))
    tgt = _poses(theta, 6, n=2)
    bf16 = TI.Imitator(_cfgs("bfloat16")[0], assets=ta, nets=nets,
                       device="cpu")
    bf16.personalize(img, src_smpl=theta)
    bf16.inference_by_smpls(tgt, batch=2)
    for k, v in nets.generator.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, before[k]), k
    preds = []
    for n in (nets, _port_nets(sd)):
        imit = TI.Imitator(_cfgs("float32")[0], assets=ta, nets=n,
                           device="cpu")
        imit.personalize(img, src_smpl=theta)
        preds.append(imit.inference_by_smpls(tgt, batch=2))
    assert torch.equal(preds[0], preds[1])


# -- production width, float32 ----------------------------------------------

def _smooth_image(s):
    """Low-frequency colour waves in [-1, 1], a photo's smoothness at the
    pixel scale (as chip_smoke.source_image)."""
    y, x = np.mgrid[0:s, 0:s].astype(np.float32) / s
    tau = 2.0 * np.pi
    img = np.stack([np.sin(tau * (1.5 * x + 0.5 * y)),
                    np.cos(tau * (0.7 * x - 1.2 * y)),
                    np.sin(tau * (2.0 * x * y + 0.3))], -1)
    return (0.8 * img).astype(np.float32)


@pytest.mark.parametrize("image", ["smooth", "noise"])
def test_float32_imitation_at_production_width_matches_jax(assets, image):
    """256², conv_dim 64, 6 residual blocks, batch 1, float32: given-SMPL
    imitation of two poses, bounded at 1e-2 as tests/test_torch_slice.py
    bounds 64². On a smooth source image the whole path is compared. On
    per-pixel noise the warp turns the reference's CPU flow divergence
    (T within 1.3e-4, ROADMAP.md's reference divergences: XLA contracts
    the raster's multiply-adds into FMAs) into 1.6e-2 at a few dozen
    pixels, so there the imitation tail is held on JAX's raster products."""
    s, conv_dim, repeat = 256, 64, 6
    sd = _weights(41, conv_dim, repeat)
    tcfg, jcfg = _cfgs("float32", s, repeat)
    rng = np.random.default_rng(42)
    img = rng.uniform(-1, 1, (s, s, 3)).astype(np.float32)
    if image == "smooth":
        img = _smooth_image(s)
    theta = _theta(rng)
    tgt = _poses(theta, 43, n=2)
    port = TI.Imitator(tcfg, assets=tassets.synthetic_assets(),
                       nets=_port_nets(sd, conv_dim, repeat), device="cpu")
    port.personalize(img, src_smpl=theta)
    ref = JI.Imitator(jcfg, assets=assets,
                      nets=_jax_nets(sd, conv_dim, repeat))
    ref.personalize(img, src_smpl=theta)
    np.testing.assert_array_equal(port.src_info["fim"].numpy(),
                                  np.asarray(ref.src_info["fim"]))
    if image == "smooth":
        preds_t = port.inference_by_smpls(tgt, batch=1)
        preds_j = ref.inference_by_smpls(tgt, batch=1)
    else:
        tsf = JI.swap_smpl(ref.src_info["cam"], ref.src_info["shape"],
                           jnp.asarray(tgt), jnp.asarray(tgt[0:1, 0:3]))
        info = jsmpl.get_details(ref.smpl_params, tsf, ref.parents)
        fim, t = ref.renderer.render_flow(info["cam"], info["verts"],
                                          ref.src_info["p2verts"])
        cond = ref.renderer.encode_fim(fim)
        preds_j = JI.imitate_from_flow(ref.nets, ref.renderer, ref.src_info,
                                       fim, t, cond)
        preds_t = TI.imitate_from_flow(
            port.nets, port.renderer, port.src_info,
            *(torch.from_numpy(np.array(a)) for a in (fim, t, cond)))
    assert preds_t.shape == (2, s, s, 3)
    gap, _ = _gap(preds_t, preds_j)
    assert gap <= 1e-2, gap           # measured 1.13e-3 / 3.11e-4
