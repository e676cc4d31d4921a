"""Appearance transfer, novel view, the animator, front-warp imitation and
the DeepFill background net: the port (torch, CPU, the bucket raster path
through the kernels' plain twins) against the JAX package's task classes
and cores (brute raster path off-TPU) on the same weights and inputs,
float32, 64², conv_dim 8, 2 residual blocks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impersonator_tpu import config
from impersonator_tpu.models import HumanModelRecovery as JHMR
from impersonator_tpu.models.generator import ImpersonatorGenerator as JGen
from impersonator_tpu.models.inpaintor import InpaintSANet as JInpaint
from impersonator_tpu.ops import flow as jflow
from impersonator_tpu.ops import projection as jproj
from impersonator_tpu.tasks import imitator as JI
from impersonator_tpu.tasks import swapper as JS
from impersonator_tpu.tasks.animator import Animator as JAnimator
from impersonator_tpu.tasks.renderer import SMPLRenderer as JRenderer
from impersonator_tpu.tasks.viewer import Viewer as JViewer
from impersonator_tpu_torch import assets as tassets
from impersonator_tpu_torch.models.generator import \
    ImpersonatorGenerator as TGen
from impersonator_tpu_torch.models.inpaintor import InpaintSANet as TInpaint
from impersonator_tpu_torch.ops import flow as tflow
from impersonator_tpu_torch.ops import projection as tproj
from impersonator_tpu_torch.tasks import factory
from impersonator_tpu_torch.tasks import imitator as TI
from impersonator_tpu_torch.tasks import swapper as TS
from impersonator_tpu_torch.tasks import viewer as TV
from impersonator_tpu_torch.tasks.animator import Animator as TAnimator
from impersonator_tpu_torch.tasks.renderer import SMPLRenderer as TRenderer
from impersonator_tpu_torch.utils.convert import \
    inpaintor_state_dict_from_jax
from tools import convert_weights as cw

import torch_ref

S, CONV_DIM, REPEAT, CNUM = 64, 8, 2, 8


def _cfg(**kw):
    return config.TestConfig(image_size=S, repeat_num=REPEAT,
                             compute_dtype="float32", **kw)


def _tcfg(**kw):
    from impersonator_tpu_torch.config import TestConfig
    return TestConfig(image_size=S, repeat_num=REPEAT,
                      compute_dtype="float32", **kw)


def _theta(rng, cam=0.9, pose=0.0):
    t = np.zeros(85, np.float32)
    t[0] = cam
    t[3:75] = rng.normal(0, pose, 72) if pose else 0.0
    return t


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(x):
    return x.detach().numpy().transpose(0, 2, 3, 1)


def make_inpaintor_sd(rng, c_dim=4, cnum=CNUM):
    """Reference-layout DeepFill state dict (random): gated convs at
    1.4/sqrt(fan_in), which with the sigmoid gates keeps the activations
    O(1) through the 35 layers; perturbed BatchNorms; a non-zero gamma so
    the attention counts."""
    sd = {}
    for key, v in TInpaint(c_dim, cnum).state_dict().items():
        shape = tuple(v.shape)
        if key.endswith("num_batches_tracked"):
            sd[key] = v
            continue
        if len(shape) == 4:
            fan_in = int(np.prod(shape[1:]))
            arr = rng.standard_normal(shape) * 1.4 / np.sqrt(fan_in)
        elif key.endswith("running_var"):
            arr = rng.uniform(0.5, 1.5, shape)
        elif "batch_norm2d.weight" in key:
            arr = 1.0 + 0.1 * rng.standard_normal(shape)
        elif key == "refine_attn.gamma":
            arr = np.asarray([0.7])
        else:
            arr = 0.1 * rng.standard_normal(shape)
        sd[key] = torch.from_numpy(np.asarray(arr, np.float32))
    return sd


@pytest.fixture(scope="module")
def weights():
    """Reference-layout generator and DeepFill weights, and both
    packages' nets built from them."""
    rng = np.random.default_rng(31)
    sd = {**torch_ref.make_bg_sd(rng, 4, CONV_DIM, REPEAT),
          **torch_ref.make_resunet_sd(rng, "src_model", 6, CONV_DIM, REPEAT),
          **torch_ref.make_resunet_sd(rng, "tsf_model", 6, CONV_DIM, REPEAT)}
    bg_sd = make_inpaintor_sd(rng)
    return sd, bg_sd


def _port_nets(weights, bgnet=False):
    sd, bg_sd = weights
    gen = TGen(conv_dim=CONV_DIM, repeat_num=REPEAT)
    gen.load_state_dict(sd, strict=True)
    net = None
    if bgnet:
        net = TInpaint(4, CNUM).eval()       # BatchNorm on running stats
        net.load_state_dict(bg_sd, strict=True)
    return TI.ImitatorNets(gen, None, net)


def _jax_nets(weights, bgnet=False):
    sd, bg_sd = weights
    gen = JGen(bg_dim=4, src_dim=6, tsf_dim=6, conv_dim=CONV_DIM,
               repeat_num=REPEAT)
    net = params = None
    if bgnet:
        net, params = JInpaint(c_dim=4, cnum=CNUM), cw.convert_bgnet(bg_sd)
    return JI.ImitatorNets(gen, cw.convert_generator(sd, repeat=REPEAT),
                           JHMR(), None, net, params)


def _images(seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (S, S, 3)).astype(np.float32)
            for _ in range(2)]


# -- generator ---------------------------------------------------------------

def test_generator_swap_and_infer_front_match_jax(weights):
    sd = weights[0]
    jgen = JGen(bg_dim=4, src_dim=6, tsf_dim=6, conv_dim=CONV_DIM,
                repeat_num=REPEAT)
    params = cw.convert_generator(sd, repeat=REPEAT)
    tgen = TGen(conv_dim=CONV_DIM, repeat_num=REPEAT).eval()
    tgen.load_state_dict(sd, strict=True)
    rng = np.random.default_rng(2)
    srcs = rng.uniform(-1, 1, (2, 1, S, S, 6)).astype(np.float32)
    tsf = rng.uniform(-1, 1, (2, S, S, 6)).astype(np.float32)
    ts = rng.uniform(-1, 1, (2, 2, S, S, 2)).astype(np.float32)
    ts[0, :, : S // 3] = -2.0                    # background rows
    ts[1, :, :, : S // 4] = -2.0
    feats_j = [jgen.apply(params, jnp.asarray(x), method="encode_src")
               for x in srcs]
    with torch.no_grad():
        feats_t = [tgen.encode_src(_nchw(x)) for x in srcs]
        out_t = tgen.swap(_nchw(tsf), feats_t[0][0], feats_t[1][0],
                          feats_t[0][1], feats_t[1][1],
                          torch.from_numpy(ts[0]), torch.from_numpy(ts[1]))
        front_t = tgen.infer_front(_nchw(np.repeat(srcs[0], 2, 0)),
                                   _nchw(tsf), torch.from_numpy(ts[0]))
    out_j = jgen.apply(params, jnp.asarray(tsf), feats_j[0][0],
                       feats_j[1][0], feats_j[0][1], feats_j[1][1],
                       jnp.asarray(ts[0]), jnp.asarray(ts[1]), method="swap")
    front_j = jgen.apply(params, jnp.asarray(np.repeat(srcs[0], 2, 0)),
                         jnp.asarray(tsf), jnp.asarray(ts[0]),
                         method="infer_front")
    assert out_t[0].shape == (2, 3, S, S) and len(front_t) == 4
    for a, b in zip(out_t + front_t, out_j + front_j):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), atol=1e-3)


# -- small ops ---------------------------------------------------------------

def _small_op(name, assets):
    """(port result, JAX result) of one small op on the same inputs."""
    rng = np.random.default_rng(5)
    if name == "identity_flow":
        return (tflow.identity_flow(2, 37).numpy(),
                np.asarray(jflow.identity_flow(2, 37)))
    if name == "null_visible_f2pts":
        f2pts = rng.uniform(-1, 1, (2, 40, 3, 2)).astype(np.float32)
        fim = rng.integers(-1, 40, (2, 9, 9)).astype(np.int32)
        fim[1] = np.where(fim[1] < 20, -1, fim[1])
        return (tflow.null_visible_f2pts(torch.from_numpy(f2pts),
                                         torch.from_numpy(fim)).numpy(),
                np.asarray(jflow.null_visible_f2pts(jnp.asarray(f2pts),
                                                    jnp.asarray(fim))))
    if name == "euler_to_matrix":
        angles = [(0, 90, 0), (10, -35, 170), (0.3, 1.1, -2.0)]
        return (np.stack([tproj.euler_to_matrix(a, deg=i < 2).numpy()
                          for i, a in enumerate(angles)]),
                np.stack([np.asarray(jproj.euler_to_matrix(a, deg=i < 2))
                          for i, a in enumerate(angles)]))
    if name == "swap_smpl_preserve_scale":
        src_cam = rng.uniform(0.5, 1.2, (3, 3)).astype(np.float32)
        shape = rng.normal(0, 1, (3, 10)).astype(np.float32)
        tgt = rng.normal(0, 0.3, (3, 85)).astype(np.float32)
        tgt[:, 0] = rng.uniform(0.7, 1.3, 3)
        return (TS.swap_smpl_preserve_scale(
                    torch.from_numpy(src_cam), torch.from_numpy(shape),
                    torch.from_numpy(tgt)).numpy(),
                np.asarray(JS.swap_smpl_preserve_scale(
                    jnp.asarray(src_cam), jnp.asarray(shape),
                    jnp.asarray(tgt))))
    if name == "encode_front_fim":
        fim = rng.integers(-1, assets.nf, (2, 16, 16)).astype(np.int32)
        tr = TRenderer.create(tassets.synthetic_assets(), "cpu",
                              image_size=16, has_front=True)
        jr = JRenderer.create(assets, image_size=16, has_front=True)
        return (np.concatenate([tr.encode_front_fim(torch.from_numpy(fim),
                                                    f).numpy()
                                for f in (True, False)]),
                np.concatenate([np.asarray(jr.encode_front_fim(
                    jnp.asarray(fim), f)) for f in (True, False)]))
    raise ValueError(name)


@pytest.mark.parametrize("name", ["identity_flow", "null_visible_f2pts",
                                  "euler_to_matrix",
                                  "swap_smpl_preserve_scale",
                                  "encode_front_fim"])
def test_small_ops_match_jax(name, assets):
    port, ref = _small_op(name, assets)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, atol=1e-6, rtol=0)


def test_renderer_without_front_table_raises():
    r = TRenderer.create(tassets.synthetic_assets(), "cpu", image_size=16)
    fim = torch.zeros((1, 16, 16), dtype=torch.int32)
    assert r.encode_front_fim(fim, front_fn=False).shape == (1, 16, 16, 1)
    with pytest.raises(ValueError):
        r.encode_front_fim(fim)


# -- swapper -----------------------------------------------------------------

@pytest.fixture(scope="module")
def swappers(weights, assets):
    """Both packages' Swappers after the same swap_setup."""
    rng = np.random.default_rng(8)
    src_img, tgt_img = _images(9)
    src_theta = _theta(rng)
    tgt_theta = _theta(rng, 0.85, 0.1)
    tgt_theta[1:3] = (0.03, -0.02)
    port = TS.Swapper(_tcfg(), assets=tassets.synthetic_assets(),
                      nets=_port_nets(weights), device="cpu")
    port.swap_setup(src_img, tgt_img, src_theta, tgt_theta)
    ref = JS.Swapper(_cfg(), assets=assets, nets=_jax_nets(weights))
    ref.swap_setup(src_img, tgt_img, src_theta, tgt_theta)
    assert port.renderer._bucket_config() is not None   # the kernel path
    return port, ref, (src_theta, tgt_theta)


@pytest.mark.parametrize("part", ["body", "all"])
def test_swap_matches_jax(swappers, part):
    port, ref, _ = swappers
    for p, r in ((port.src_info, ref.src_info),
                 (port.tsf_info, ref.tsf_info)):
        np.testing.assert_array_equal(p["fim"].numpy(), np.asarray(r["fim"]))
        np.testing.assert_array_equal(p["part"].numpy(),
                                      np.asarray(r["part"]))
    preds_t = port.swap(target_part=part)
    preds_j = np.asarray(ref.swap(target_part=part))
    assert preds_t.shape == (1, S, S, 3)
    np.testing.assert_allclose(preds_t.numpy(), preds_j, atol=1e-2)


def test_swap_parts_differ_where_the_source_keeps_its_head(swappers):
    port, _, _ = swappers
    kept = port.src_info["part"][0, ..., 0] != 0        # part 0 of 'par'
    assert int(kept.sum()) > 0
    diff = (port.swap(target_part="body")
            - port.swap(target_part="all")).abs().amax(-1)[0]
    assert float(diff[kept].max()) > 1e-3
    with pytest.raises(ValueError):
        port.swap(target_part="head")


def test_swapper_imitate_by_smpls_matches_jax(swappers):
    port, ref, (src_theta, _) = swappers
    rng = np.random.default_rng(12)
    tgt = np.tile(src_theta, (3, 1))
    tgt[:, 3:75] += rng.normal(0, 0.08, (3, 72)).astype(np.float32)
    tgt[:, 0] += rng.uniform(-0.05, 0.05, 3).astype(np.float32)
    preds_t = port.imitate_by_smpls(port.src_info, tgt, batch=2)
    preds_j = np.asarray(ref.imitate_by_smpls(ref.src_info, tgt, batch=2))
    assert preds_t.shape == (3, S, S, 3)
    np.testing.assert_allclose(preds_t.numpy(), preds_j, atol=1e-2)


def test_imitate_from_raster_matches_jax(swappers):
    """The imitation tail from given (fim, wim): the JAX renderer's raster
    products of three target poses fed to both packages."""
    port, ref, (src_theta, _) = swappers
    from impersonator_tpu.ops import smpl as jsmpl
    rng = np.random.default_rng(13)
    tgt = np.tile(src_theta, (3, 1))
    tgt[:, 3:75] += rng.normal(0, 0.08, (3, 72)).astype(np.float32)
    info = jsmpl.get_details(ref.smpl_params, jnp.asarray(tgt),
                             ref.parents)
    _, fim, wim = ref.renderer.render_fim_wim(info["cam"], info["verts"])
    cond = ref.renderer.encode_fim(fim)
    preds_j = np.asarray(JI.imitate_from_raster(ref.nets, ref.renderer,
                                                ref.src_info, fim, wim, cond))
    preds_t = TI.imitate_from_raster(
        port.nets, port.renderer, port.src_info,
        *(torch.from_numpy(np.array(a)) for a in (fim, wim, cond)))
    assert (np.asarray(fim) >= 0).mean() > 0.02
    np.testing.assert_allclose(preds_t.numpy(), preds_j, atol=1e-2)


# -- viewer ------------------------------------------------------------------

@pytest.fixture(scope="module")
def viewers(weights, assets):
    rng = np.random.default_rng(14)
    img = _images(15)[0]
    theta = _theta(rng, 0.9, 0.05)
    port = TV.Viewer(_tcfg(), assets=tassets.synthetic_assets(),
                     nets=_port_nets(weights), device="cpu")
    port.personalize(img, theta)
    ref = JViewer(_cfg(), assets=assets, nets=_jax_nets(weights))
    ref.personalize(img, theta)
    np.testing.assert_allclose(port.src_info["verts"].numpy(),
                               np.asarray(ref.src_info["verts"]), atol=1e-5)
    return port, ref


def _view_fims(port, ref, rots, trans):
    """fim of both renderers on the JAX package's rotated vertices."""
    verts = np.array(jnp.einsum("nvc,ncd->nvd", jnp.broadcast_to(
        ref.src_info["verts"], (rots.shape[0],)
        + ref.src_info["verts"].shape[1:]), rots) + trans[:, None])
    cam = np.repeat(np.asarray(ref.src_info["cam"]), rots.shape[0], 0)
    _, fim_j, _ = ref.renderer.render_fim_wim(jnp.asarray(cam),
                                              jnp.asarray(verts))
    fim_t, _ = port.renderer.render_flow(
        torch.from_numpy(cam), torch.from_numpy(verts),
        port.src_info["p2verts"])
    return fim_t.numpy(), np.asarray(fim_j)


def test_view_sweep_matches_jax(viewers):
    port, ref = viewers
    yaws = [0.0, 90.0, 180.0, 270.0]
    rots = np.stack([np.asarray(jproj.euler_to_matrix(
        jnp.asarray([0.0, y, 0.0]))) for y in yaws])
    fim_t, fim_j = _view_fims(port, ref, rots, np.zeros((4, 3), np.float32))
    np.testing.assert_array_equal(fim_t, fim_j)
    assert (fim_t[1] >= 0).mean() > 0.02
    preds_t = port.view_sweep(yaws)
    preds_j = np.asarray(ref.view_sweep(yaws))
    assert preds_t.shape == (4, S, S, 3)
    np.testing.assert_allclose(preds_t.numpy(), preds_j, atol=1e-2)
    rt, t = (10.0, 60.0, -5.0), (0.02, -0.01, 0.0)
    np.testing.assert_allclose(port.view(rt, t).numpy(),
                               np.asarray(ref.view(rt, t)), atol=1e-2)


def test_view_by_smpls_matches_jax(viewers):
    port, ref = viewers
    rng = np.random.default_rng(16)
    smpls = np.tile(np.asarray(ref.src_info["theta"])[0], (3, 1))
    smpls[:, 3:6] = rng.normal(0, 0.8, (3, 3)).astype(np.float32)
    preds_t = port.view_by_smpls(smpls, batch=2)
    preds_j = np.asarray(ref.view_by_smpls(smpls, batch=2))
    assert preds_t.shape == (3, S, S, 3)
    np.testing.assert_allclose(preds_t.numpy(), preds_j, atol=1e-2)


def test_viewer_post_personalize_raises(weights):
    """Post-tune needs a personalised source (it works then:
    tests/test_torch_post_tune.py)."""
    viewer = TV.Viewer(_tcfg(), assets=tassets.synthetic_assets(),
                       nets=_port_nets(weights), device="cpu")
    with pytest.raises(RuntimeError, match="personalize"):
        viewer.post_personalize()


# -- animator, front warp, DeepFill ------------------------------------------

def test_animate_with_frozen_parts_matches_jax(weights, assets):
    rng = np.random.default_rng(17)
    img = _images(18)[0]
    theta = _theta(rng, 0.9, 0.05)
    seq = np.tile(theta, (3, 1))
    seq[:, 3:75] += rng.normal(0, 0.1, (3, 72)).astype(np.float32)
    parts = ("01_head", "03_left_upper_arm")
    port = TAnimator(_tcfg(), assets=tassets.synthetic_assets(),
                     nets=_port_nets(weights), device="cpu")
    port.personalize(img, theta)
    ref = JAnimator(_cfg(), assets=assets, nets=_jax_nets(weights))
    ref.personalize(img, theta)
    preds_t = port.animate(seq, batch=2, freeze_parts=parts)
    preds_j = np.asarray(ref.animate(seq, batch=2, freeze_parts=parts))
    assert preds_t.shape == (3, S, S, 3)
    np.testing.assert_allclose(preds_t.numpy(), preds_j, atol=1e-2)


@pytest.mark.parametrize("bg_model", ["ORIGINAL", "deepfill"])
def test_front_warp_imitation_matches_jax(weights, assets, bg_model):
    """front_warp (the warped source face pasted over the head), with the
    generator's background stream or the DeepFill net."""
    rng = np.random.default_rng(19)
    img = _images(20)[0]
    theta = _theta(rng, 0.9, 0.05)
    theta[3:6] = (0.0, np.pi, 0.0)                # facing the camera
    tgt = np.tile(theta, (2, 1))
    tgt[:, 3:75] += rng.normal(0, 0.08, (2, 72)).astype(np.float32)
    deep = bg_model != "ORIGINAL"
    port = TI.Imitator(_tcfg(front_warp=True, bg_model=bg_model),
                       assets=tassets.synthetic_assets(),
                       nets=_port_nets(weights, deep), device="cpu")
    src_t = port.personalize(img, theta)
    ref = JI.Imitator(_cfg(front_warp=True, bg_model=bg_model),
                      assets=assets, nets=_jax_nets(weights, deep))
    src_j = ref.personalize(img, theta)
    np.testing.assert_allclose(src_t["bg"].numpy(), np.asarray(src_j["bg"]),
                               atol=1e-3 if deep else 5e-3)
    preds_t = port.inference_by_smpls(tgt, batch=2)
    preds_j = np.asarray(ref.inference_by_smpls(tgt, batch=2))
    front = port.renderer.encode_front_fim(port.renderer.render_flow(
        *_tsf_geometry(port, tgt), src_t["p2verts"])[0])
    assert float(front.sum()) > 0                 # the paste covers pixels
    np.testing.assert_allclose(preds_t.numpy(), preds_j, atol=1e-2)


def test_personalize_with_external_body_mask_matches_jax(weights, assets):
    """A given body mask takes the place of the eroded silhouette for the
    DeepFill background; the features are the same either way."""
    from impersonator_tpu.ops import smpl as jsmpl
    from impersonator_tpu_torch.ops import smpl as tsmpl
    rng = np.random.default_rng(23)
    img = _images(24)[0]
    theta = _theta(rng, 0.9, 0.05)
    mask = np.zeros((1, S, S, 1), np.float32)
    mask[0, 8:56, 20:44] = 1.0
    tr = TRenderer.create(tassets.synthetic_assets(), "cpu", image_size=S)
    tparams = tsmpl.SMPLParams.from_assets(tassets.synthetic_assets(), "cpu")
    jr = JRenderer.create(assets, image_size=S)
    st_t = TI.personalize_core(
        _port_nets(weights, True), tr, tparams, assets.parents,
        torch.from_numpy(img)[None], torch.from_numpy(theta)[None], 13, 3,
        ext_body_mask=torch.from_numpy(mask))
    st_j = jax.jit(lambda: JI.personalize_core(
        _jax_nets(weights, True), jr, jsmpl.SMPLParams.from_assets(assets),
        assets.parents, jnp.asarray(img)[None], jnp.asarray(theta)[None],
        13, 3, ext_body_mask=jnp.asarray(mask)))()
    np.testing.assert_allclose(st_t["bg"].numpy(), np.asarray(st_j["bg"]),
                               atol=1e-3)
    for a, b in zip(st_t["feats"][0] + st_t["feats"][1],
                    st_j["feats"][0] + st_j["feats"][1]):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), atol=1e-3)


def _tsf_geometry(imit, tgt):
    from impersonator_tpu_torch.ops import smpl as tsmpl
    tsf = TI.swap_smpl(imit.src_info["cam"], imit.src_info["shape"],
                       torch.from_numpy(tgt), torch.from_numpy(tgt[0:1, :3]))
    info = tsmpl.get_details(imit.smpl_params, tsf, imit.parents)
    return info["cam"], info["verts"]


def test_inpaintor_matches_jax(weights):
    _, bg_sd = weights
    rng = np.random.default_rng(22)
    imgs = rng.uniform(-1, 1, (2, S, S, 3)).astype(np.float32)
    masks = np.zeros((2, S, S, 1), np.float32)
    masks[0, 10:50, 20:40] = 1.0
    masks[1, 5:30, 5:60] = 1.0
    net = TInpaint(4, CNUM).eval()
    net.load_state_dict(bg_sd, strict=True)
    with torch.no_grad():
        out_t = net(_nchw(imgs), _nchw(masks))
    out_j = JInpaint(c_dim=4, cnum=CNUM).apply(
        cw.convert_bgnet(bg_sd), jnp.asarray(imgs), jnp.asarray(masks))
    for a, b in zip(out_t, out_j):
        b = np.asarray(b)
        assert 0.05 < np.abs(b).mean() and np.abs(b).max() <= 1.0
        np.testing.assert_allclose(_nhwc(a), b, atol=1e-3)


def test_inpaintor_state_dict_round_trips_flax_init():
    net = JInpaint(c_dim=4, cnum=CNUM)
    tree = jax.jit(net.init)(jax.random.PRNGKey(4), jnp.zeros((1, 32, 32, 3)),
                             jnp.zeros((1, 32, 32, 1)))
    tree = jax.tree_util.tree_map(np.asarray, tree)
    sd = inpaintor_state_dict_from_jax(tree)
    port = TInpaint(4, CNUM)
    port.load_state_dict(sd, strict=True)
    back = cw.convert_bgnet(port.state_dict())
    for coll in ("params", "batch_stats"):
        flat_a = jax.tree_util.tree_leaves_with_path(back[coll])
        flat_b = dict(jax.tree_util.tree_leaves_with_path(tree[coll]))
        assert len(flat_a) == len(flat_b)
        for path, leaf in flat_a:
            np.testing.assert_array_equal(leaf, flat_b[path])


# -- entry points ------------------------------------------------------------

@pytest.mark.parametrize("name", ["imitator", "swapper", "viewer",
                                  "animator"])
def test_factory_builds_each_task(name):
    """Each task comes from the factory on the device asked for, and
    runs on CUDA by default: without a card it fails rather than fall
    back to the CPU."""
    cfg = _tcfg()
    a = tassets.synthetic_assets()
    task = factory.get_by_name(name, cfg, assets=a, device="cpu")
    assert task.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            factory.get_by_name(name, cfg, assets=a)


@pytest.mark.parametrize("name", ["impersonator_trainer", "concat"])
def test_factory_trainers_wait_for_the_training_slice(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        factory.get_by_name(name, _tcfg(), device="cpu")


def test_detector_is_refused():
    with pytest.raises(NotImplementedError, match="MaskRCNN"):
        TI.Imitator(_tcfg(has_detector=True),
                    assets=tassets.synthetic_assets(), device="cpu")
