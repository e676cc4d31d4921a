"""The ablation baselines (``concat``, ``texture_warping``,
``feature_warping``), the texture renderer, depth and the soft silhouette
against the JAX package on the CPU.

Sizes are the JAX package's own trainer tests' (64², conv_dim 8, 2
residual blocks, batch 2, a 2-layer PatchGAN); the JAX weights come
across through ``impersonator_tpu_torch.utils.convert``. The raster,
texture and silhouette functions are fed the JAX package's own fim /
wim / face vertices, and the losses its own preprocessing, so that each
check compares one function. Tolerances and the measured gaps are in
each test's docstring.
"""

import copy
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impersonator_tpu import assets as jassets
from impersonator_tpu.models.baseline import ConcatGenerator as JConcat
from impersonator_tpu.models.baseline import \
    FeatureWarpingGenerator as JFeature
from impersonator_tpu.models.discriminator import \
    PatchDiscriminator as JDisc
from impersonator_tpu.ops import rasterizer as jrast
from impersonator_tpu.ops import smpl as jsmpl
from impersonator_tpu.ops import soft_raster as jsoft
from impersonator_tpu.tasks import renderer as jren
from impersonator_tpu.tasks import trainer_baseline as JB
from impersonator_tpu_torch import assets as tassets
from impersonator_tpu_torch.cli import train as tcli
from impersonator_tpu_torch.models.baseline import (ConcatGenerator,
                                                    FeatureWarpingGenerator)
from impersonator_tpu_torch.models.discriminator import PatchDiscriminator
from impersonator_tpu_torch.ops import cuda_raster
from impersonator_tpu_torch.ops import rasterizer as trast
from impersonator_tpu_torch.ops import smpl as tsmpl
from impersonator_tpu_torch.ops import soft_raster as tsoft
from impersonator_tpu_torch.tasks import renderer as tren
from impersonator_tpu_torch.tasks import trainer_baseline as TB
from impersonator_tpu_torch.utils import convert

from train_ref import (CONV_DIM, REPEAT, S, Pair, batch, capture_loss_fns,  # noqa: F401
                       grads_by_name, l2_gaps, np_tree, one_torch_thread,
                       perturbed, rel)

MODES = ("concat", "texture_warping", "feature_warping")
NO_NETS = dict(use_vgg=False, use_face=False)
ALL_TERMS = dict(use_vgg=True, use_face=True)


def _t(x):
    return torch.from_numpy(np.array(x))


# -- the texture renderer, depth and silhouette -------------------------------

@pytest.fixture(scope="module")
def posed():
    """Two posed synthetic bodies (552 faces) at 64²: the JAX renderer's
    cam, verts, face vertices, fim and wim, and a noise image."""
    ja = jassets.synthetic_assets()
    rng = np.random.default_rng(0)
    th = np.zeros((2, 85), np.float32)
    th[:, 0] = 0.9
    th[:, 3:75] = rng.normal(0, 0.1, (2, 72))
    info = jsmpl.get_details(jsmpl.SMPLParams.from_assets(ja),
                             jnp.asarray(th), ja.parents)
    jr = jren.SMPLRenderer.create(ja, image_size=S)
    f2v, fim, wim = jr.render_fim_wim(info["cam"], info["verts"])
    img = rng.uniform(-1, 1, (2, S, S, 3)).astype(np.float32)
    return dict(ja=ja, ta=tassets.synthetic_assets(), cam=info["cam"],
                verts=info["verts"], f2v=f2v, fim=fim, wim=wim, img=img)


def _renderers(p, tex_size):
    return (jren.SMPLRenderer.create(p["ja"], image_size=S,
                                     tex_size=tex_size),
            tren.SMPLRenderer.create(p["ta"], "cpu", image_size=S,
                                     tex_size=tex_size))


@pytest.mark.parametrize("tex_size", [1, 2, 3, 4])
def test_texture_sampling_matches_jax(posed, tex_size):
    """dynamic_sampler_grid equal to JAX's element for element (the same
    float32 grid values, then the same float32 arithmetic; measured 0),
    extract_texture within 1e-5 (measured ≤ 1.8e-7), and render_textured
    of JAX's own texture on JAX's fim / wim equal within 1e-5 (measured
    0), background pixels 0."""
    jr, tr = _renderers(posed, tex_size)
    cam, verts = _t(posed["cam"]), _t(posed["verts"])
    grid_j = np.asarray(jr.dynamic_sampler_grid(posed["cam"],
                                                posed["verts"]))
    grid_t = tr.dynamic_sampler_grid(cam, verts).numpy()
    assert grid_t.shape == grid_j.shape == (2, 552, tex_size ** 2, 2)
    assert np.abs(grid_t - grid_j).max() <= 1e-5
    tex_j = np.asarray(jr.extract_texture(jnp.asarray(posed["img"]),
                                          posed["cam"], posed["verts"]))
    tex_t = tr.extract_texture(_t(posed["img"]), cam, verts).numpy()
    assert np.abs(tex_t - tex_j).max() <= 1e-5
    img_j = np.asarray(jr.render_textured(posed["fim"], posed["wim"],
                                          jnp.asarray(tex_j)))
    img_t = tr.render_textured(_t(posed["fim"]), _t(posed["wim"]),
                               _t(tex_j)).numpy()
    assert np.abs(img_t - img_j).max() <= 1e-5
    bg = np.asarray(posed["fim"]) < 0
    assert 0 < bg.mean() < 1 and not img_t[bg].any()


def test_depth_silhouette_lighting_and_rgb_match_jax(posed):
    """depth_from_fim_wim on JAX's face vertices / fim / wim within 1e-5
    of JAX's (measured 0; ``far`` on background), render_silhouette
    equal, lighting (ambient 0.4, directional 0.6, 3 and 1 channels)
    within 1e-5 (measured 1.2e-7). render_depth and a lit render_rgb run
    the port's own raster (the bucket path's plain twin at 552 faces;
    fim equal to JAX's, barycentrics ~1e-4 apart, ROADMAP.md): depth
    within 1e-4 (measured 3.3e-5), RGB within 1e-3 (measured 1.7e-4),
    the silhouette equal."""
    jr, tr = _renderers(posed, 3)
    fv, fim, wim = (_t(posed[k]) for k in ("f2v", "fim", "wim"))
    d_j = np.asarray(jrast.depth_from_fim_wim(posed["f2v"], posed["fim"],
                                              posed["wim"], 25.0))
    d_t = trast.depth_from_fim_wim(fv, fim, wim, 25.0).numpy()
    assert np.abs(d_t - d_j).max() <= 1e-5
    assert (d_t[np.asarray(posed["fim"]) < 0] == 25.0).all()
    sil_t = trast.render_silhouette(fim)
    assert sil_t.dtype == torch.float32
    assert np.array_equal(sil_t.numpy(),
                          np.asarray(jrast.render_silhouette(posed["fim"])))
    tex = np.random.default_rng(2).uniform(-1, 1, (2, 552, 9, 3)).astype(
        np.float32)
    for c in (3, 1):
        l_j = np.asarray(jren.lighting(posed["f2v"],
                                       jnp.asarray(tex[..., :c]), 0.4, 0.6))
        l_t = tren.lighting(fv, _t(tex[..., :c]), 0.4, 0.6).numpy()
        assert np.abs(l_t - l_j).max() <= 1e-5, c
    cam, verts = _t(posed["cam"]), _t(posed["verts"])
    assert torch.equal(tr.render_fim_wim(cam, verts)[1], fim)
    depth = tr.render_depth(cam, verts).numpy()
    assert np.abs(depth - d_j).max() <= 1e-4
    rgb_j, s_j = jr.render_rgb(posed["cam"], posed["verts"],
                               jnp.asarray(posed["img"]), 0.5, 0.5)
    rgb_t, s_t = tr.render_rgb(cam, verts, _t(posed["img"]), 0.5, 0.5)
    assert np.array_equal(s_t.numpy(), np.asarray(s_j))
    assert np.abs(rgb_t.numpy() - np.asarray(rgb_j)).max() <= 1e-3


@pytest.mark.parametrize("cull", [True, False])
def test_soft_silhouette_and_camera_gradient_match_jax(posed, cull):
    """soft_silhouette at 32² (552 faces in 3 chunks, the last partial)
    within 1e-5 of JAX's (measured 1.2e-7), and the gradient of a
    silhouette loss with respect to the camera (through the projection)
    within 1e-3 relative L2 of jax.grad's (measured ≤ 1.7e-7); with
    cull_backfaces off the back faces' edges add coverage."""
    faces_j = jnp.asarray(posed["ja"].faces)
    faces_t = torch.as_tensor(np.asarray(posed["ja"].faces, np.int64))
    target = np.asarray(jsoft.soft_silhouette(
        jrast.project_to_raster_space(posed["verts"], posed["cam"] * 1.1,
                                      faces_j), image_size=32))

    def loss_j(cam):
        fv = jrast.project_to_raster_space(posed["verts"], cam, faces_j)
        sil = jsoft.soft_silhouette(fv, image_size=32, cull_backfaces=cull)
        return jnp.sum((sil - target) ** 2), sil

    (_, sil_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(posed["cam"])
    cam = _t(posed["cam"]).requires_grad_(True)
    fv = trast.project_to_raster_space(_t(posed["verts"]), cam, faces_t)
    sil_t = tsoft.soft_silhouette(fv, image_size=32, cull_backfaces=cull)
    ((sil_t - _t(target)) ** 2).sum().backward()
    assert sil_t.shape == (2, 32, 32)
    assert np.abs(sil_t.detach().numpy() - np.asarray(sil_j)).max() <= 1e-5
    g_j = np.asarray(g_j)
    assert np.linalg.norm(g_j) > 0
    gap = np.linalg.norm(cam.grad.numpy() - g_j) / np.linalg.norm(g_j)
    assert gap <= 1e-3, gap
    if not cull:
        with torch.no_grad():
            culled = tsoft.soft_silhouette(fv, image_size=32)
        assert float(sil_t.detach().sum()) > float(culled.sum())


# -- the generators -----------------------------------------------------------

def _jax_generator(mode):
    if mode == "feature_warping":
        return JFeature(conv_dim=CONV_DIM, repeat_num=REPEAT)
    return JConcat(conv_dim=CONV_DIM, repeat_num=REPEAT)


def _port_generator(mode):
    if mode == "feature_warping":
        return FeatureWarpingGenerator(conv_dim=CONV_DIM, repeat_num=REPEAT)
    return ConcatGenerator(tsf_dim=9 if mode == "concat" else 6,
                           conv_dim=CONV_DIM, repeat_num=REPEAT)


def _init_shapes(mode):
    if mode == "feature_warping":
        return [(1, S, S, 4), (1, S, S, 6), (1, S, S, 3), (1, S, S, 2)]
    return [(1, S, S, 4), (1, S, S, 9 if mode == "concat" else 6)]


@functools.lru_cache(maxsize=None)
def _weights(mode, seed=11):
    """(JAX generator params perturbed off their init, JAX 9-channel
    PatchGAN params at flax's init, as the base trainer's tests take
    it)."""
    g = jax.jit(_jax_generator(mode).init)(
        jax.random.PRNGKey(seed), *map(jnp.zeros, _init_shapes(mode)))
    d = jax.jit(JDisc(n_layers=2).init)(jax.random.PRNGKey(seed + 1),
                                        jnp.zeros((1, S, S, 9)))
    return perturbed(g, seed), np_tree(d)


@pytest.mark.parametrize("mode", MODES)
def test_baseline_generator_forward_matches_jax(mode):
    """Each ablation generator from the JAX params through
    utils.convert.generator_state_dict_from_jax (strict load: concat's
    tsf stream takes 9 channels, texture_warping's 6, feature_warping's
    3 beside a 6-channel source stream): every output within 1e-4 of the
    JAX output's largest magnitude (measured ≤ 5.1e-5)."""
    g, _ = _weights(mode)
    rng = np.random.default_rng(4)
    xs = [rng.uniform(-1, 1, s[1:]).astype(np.float32)[None].repeat(2, 0)
          + rng.normal(0, 0.1, (2,) + s[1:]).astype(np.float32)
          for s in _init_shapes(mode)]
    if mode == "feature_warping":
        xs[-1][:, :8] = -2.0                      # background flow rows
    outs_j = jax.jit(_jax_generator(mode).apply)(g, *map(jnp.asarray, xs))
    net = _port_generator(mode)
    net.load_state_dict(convert.generator_state_dict_from_jax(g))
    args = [_t(x).permute(0, 3, 1, 2) for x in xs]
    if mode == "feature_warping":
        args[-1] = _t(xs[-1])
    with torch.no_grad():
        outs_t = net(*args)
    assert len(outs_t) == len(outs_j)
    for a, b in zip(outs_t, outs_j):
        assert rel(a.permute(0, 2, 3, 1).numpy(), b) <= 1e-4


# -- the baseline trainers ----------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    return Pair()


def _trainers(pair, mode, **kw):
    """(JAX BaselineTrainer, port BaselineTrainer) for ``mode`` at 64² with
    the same frozen VGG19 / Sphere20a, conv_dim 8; the VGG and face
    terms off unless ``kw`` turns them on."""
    jtr, ttr = pair.trainers(model=mode, **{**NO_NETS, **kw})
    jb = JB.BaselineTrainer(mode, jtr, _jax_generator(mode), JDisc(
        n_layers=2))
    tb = TB.BaselineTrainer(**{f.name: getattr(ttr, f.name)
                               for f in dataclasses.fields(ttr)})
    return jb, tb


def _port_state(tb, mode, g, d):
    gen = _port_generator(mode)
    gen.load_state_dict(convert.generator_state_dict_from_jax(g))
    disc = PatchDiscriminator(9, 64, 2)
    disc.load_state_dict(convert.discriminator_state_dict_from_jax(d))
    return tb.init_state(gen, disc)


def _nchw_inputs(jin):
    """JAX baseline_recovery_flow outputs -> the port's layout."""
    return {k: (_t(v).permute(0, 3, 1, 2).contiguous()
                if np.ndim(v) == 4 and k != "T" else _t(v))
            for k, v in jin.items()}


def _jax_inputs(jb, jbatch):
    jtr = jb.inner
    return jax.jit(lambda b: JB.baseline_recovery_flow(
        jtr.renderer, jtr.smpl_params, jtr.assets.parents,
        b["images"][:, 0], b["images"][:, 1], b["smpls"][:, 0],
        b["smpls"][:, 1], jb.mode))(jbatch)


@pytest.mark.parametrize("mode", MODES)
def test_baseline_recovery_flow_matches_jax(pair, mode):
    """The frozen preprocessing of each mode on two synthetic pairs: the
    conditioning maps and the masks equal (fim equal), the head box
    within 1e-5, T within 1e-3 (the raster's bound, ROADMAP.md), the
    masked images within 1e-6 and texture_warping's re-rendered source
    within 5e-3 (per-face texels of noise sampled at barycentrics ~1e-4
    apart; measured 5.5e-4); nothing carries a gradient."""
    jb, tb = _trainers(pair, mode)
    jbatch, tbatch = batch()
    want = _nchw_inputs(_jax_inputs(jb, jbatch))
    got, _ = TB.baseline_inputs(tb, tbatch)
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.shape == want[k].shape and not v.requires_grad, k
    for k in ("src_cond", "tsf_cond", "tsf_crop_mask"):
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["input_G_bg"][:, 3:], want["input_G_bg"][:, 3:])
    np.testing.assert_allclose(got["input_G_bg"], want["input_G_bg"],
                               atol=1e-6)
    np.testing.assert_allclose(got["head_bbox"], want["head_bbox"],
                               atol=1e-5)
    if mode == "feature_warping":
        np.testing.assert_allclose(got["input_G_src"], want["input_G_src"],
                                   atol=1e-6)
        np.testing.assert_allclose(got["T"], want["T"], atol=1e-3)
    else:
        np.testing.assert_allclose(got["input_G"], want["input_G"],
                                   atol=5e-3 if mode == "texture_warping"
                                   else 1e-6)


def _losses_and_grads(pair, mode, **kw):
    """One mode's G and D losses and gradients in both packages on JAX's
    preprocessing of synthetic items 0 and 1 (the JAX losses are the
    functions its train step differentiates; D's on JAX's fake in both),
    the gap of the fakes, and for feature_warping without the VGG and
    face nets the port's G gradient in float64."""
    jb, tb = _trainers(pair, mode, **kw)
    jbatch, tbatch = batch()
    g, d = _weights(mode)
    jstate = JB.TrainState(g, d, jb.inner.g_tx.init(g),
                           jb.inner.d_tx.init(d), jnp.zeros((), jnp.int32))
    g_fn, d_fn = capture_loss_fns(JB.make_train_step(jb), jstate, jbatch)
    jin = _jax_inputs(jb, jbatch)
    real = jbatch["images"][:, 1]
    (_, (m_j, fake_j)), gg_j = jax.jit(jax.value_and_grad(
        g_fn, has_aux=True))(g, d, jin, real)
    (_, dm_j), dg_j = jax.jit(jax.value_and_grad(d_fn, has_aux=True))(
        d, jin, fake_j, real)
    ts = _port_state(tb, mode, g, d)
    tg_fn, td_fn = TB.make_baseline_loss_fns(tb)
    tin = _nchw_inputs(jin)
    total, (m_t, fake_t) = tg_fn(ts.generator, ts.discriminator, tin,
                                 tbatch["images"][:, 1])
    gg_t = grads_by_name(ts.generator, total)
    # D on JAX's fake, so that its check compares D alone
    d_total, dm_t = td_fn(ts.discriminator, tin,
                          _t(fake_j).permute(0, 3, 1, 2),
                          tbatch["images"][:, 1])
    dg_t = grads_by_name(ts.discriminator, d_total)
    m_j = {**m_j, **dm_j, "d_total": dm_j["d_real"] + dm_j["d_fake"]}
    out = dict(
        fake=rel(fake_t.detach().permute(0, 2, 3, 1).numpy(), fake_j),
        m_j={k: float(v) for k, v in m_j.items()},
        m_t={k: float(v) for k, v in {**m_t, **dm_t}.items()},
        g=(gg_t, convert.generator_state_dict_from_jax(np_tree(gg_j))),
        d=(dg_t, convert.discriminator_state_dict_from_jax(np_tree(dg_j))))
    if mode != "feature_warping" or kw:
        return out
    # the same G loss in float64 on the port, the exact gradient's stand-in
    tb64 = dataclasses.replace(tb, **{
        k: None if getattr(tb, k) is None
        else copy.deepcopy(getattr(tb, k)).double() for k in ("vgg", "face")})
    gen64 = copy.deepcopy(ts.generator).double()
    total64, _ = TB.make_baseline_loss_fns(tb64)[0](
        gen64, copy.deepcopy(ts.discriminator).double(),
        {k: v.double() if v.is_floating_point() else v
         for k, v in tin.items()}, tbatch["images"][:, 1].double())
    out["g64"] = grads_by_name(gen64, total64)
    return out


@pytest.fixture(scope="module")
def runs(pair):
    """Every mode with the adversarial, reconstruction and mask terms,
    and feature_warping with VGG and face on as well ("all")."""
    out = {mode: _losses_and_grads(pair, mode) for mode in MODES}
    out["all"] = _losses_and_grads(pair, "feature_warping", **ALL_TERMS)
    return out


@pytest.mark.parametrize("mode", MODES + ("all",))
def test_baseline_losses_match_jax(runs, mode):
    """Every G term and both D terms on fixed inputs within 1e-4 relative
    of JAX's (measured ≤ 1.2e-6); d_real / d_fake are the two LSGAN
    losses and d_total their sum, as JAX reports them; VGG and face on
    for "all" (feature_warping), off (0) otherwise. The fake target
    within 1e-4 of its largest magnitude (the generator's bound; measured
    7.1e-6 for the unwarped concat input, 6.7e-5 through
    feature_warping's bottleneck warp)."""
    r = runs[mode]
    assert r["fake"] <= 1e-4, r["fake"]
    assert set(r["m_t"]) == set(r["m_j"]) == {
        "g_adv", "g_rec", "g_vgg", "g_face", "g_mask", "g_mask_tv",
        "g_total", "d_real", "d_fake", "d_total"}
    for k, ref in r["m_j"].items():
        got = r["m_t"][k]
        assert np.isfinite(got), k
        assert abs(got - ref) <= 1e-4 * max(abs(ref), 1e-12), (k, got, ref)
    on = ["g_adv", "g_rec", "g_mask", "g_mask_tv", "d_real", "d_fake"]
    if mode == "all":
        on += ["g_vgg", "g_face"]
    assert all(r["m_t"][k] != 0.0 for k in on)


def _d_gaps(dg_t, dg_j):
    """D's gradient gaps (per tensor, over all) in the L2 norm; the biases
    of the convs before an instance norm (0 in exact arithmetic) are held
    below 1e-5 of the whole gradient's norm in both instead."""
    norm = float(torch.cat([v.flatten() for v in dg_j.values()]).norm())
    noise = [k for k, v in dg_j.items() if float(v.norm()) <= 1e-5 * norm]
    assert sorted(noise) == ["model.2.bias", "model.5.bias"]
    for k in noise:
        assert float(dg_t[k].norm()) <= 1e-5 * norm, k
    keep = [k for k in dg_j if k not in noise]
    per, _ = l2_gaps({k: dg_t[k] for k in keep}, {k: dg_j[k] for k in keep})
    return per, l2_gaps(dg_t, dg_j)[1]


@pytest.mark.parametrize("mode", MODES + ("all",))
def test_baseline_gradients_match_jax(runs, mode):
    """D's gradient on the same fake against jax.value_and_grad of the
    same loss within 1e-3 per tensor and over all, in the L2 norm (the
    base trainer's bound, tests/test_torch_train_losses.py; measured ≤
    2.9e-6). G's within the base trainer's 1e-2 per tensor and 5e-3 over
    all of JAX's (measured ≤ 5.5e-5 for concat and texture_warping, 6.7e-3
    / 1.9e-3 for feature_warping with VGG and face on). Through
    feature_warping's bottleneck warp alone JAX's own float32 gradient is
    1.4e-2 per tensor / 6.2e-3 over all from the float64 one, the port's
    1.4e-5 / 3e-6: there the port is held to those bounds against the
    port's float64 gradient of the same loss and must be at least as
    close to it as JAX is."""
    gg_t, gg_j = runs[mode]["g"]
    assert set(gg_t) == set(gg_j)
    per, total = _d_gaps(*runs[mode]["d"])
    assert per <= 1e-3 and total <= 1e-3, (per, total)
    if mode != "feature_warping":
        per, total = l2_gaps(gg_t, gg_j)
        assert per <= 1e-2 and total <= 5e-3, (per, total)
        return
    g64 = runs[mode]["g64"]
    port = l2_gaps({k: v.double() for k, v in gg_t.items()}, g64)
    assert port[0] <= 1e-2 and port[1] <= 5e-3, port
    ref = l2_gaps({k: v.double() for k, v in gg_j.items()}, g64)
    assert port[0] <= ref[0] and port[1] <= ref[1], (port, ref)


@pytest.mark.parametrize("mode", MODES)
def test_baseline_step_rasters_twice_and_ignores_train_dtype(pair, mode,
                                                             monkeypatch):
    """Three G+D steps from the same weights with --train_dtype float32
    and bfloat16 give the same losses and weights bit for bit (the
    baselines apply their nets without the precision policy, as in the
    JAX package); each step rasterises twice through zbuffer_bucket_rows
    (source and target) and never through the flow kernel; the weights
    move and the metrics are finite; a G-only step has no D metrics."""
    calls = {"rows": 0, "flow": 0}
    for name, key in (("zbuffer_bucket_rows", "rows"),
                      ("zbuffer_bucket_flow", "flow")):
        real = getattr(cuda_raster, name)

        def counted(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)
        monkeypatch.setattr(cuda_raster, name, counted)
    g, d = _weights(mode)
    tbatch = batch()[1]
    out = []
    for dtype in ("float32", "bfloat16"):
        _, tb = _trainers(pair, mode, train_dtype=dtype, use_vgg=False,
                          use_face=False)
        st = _port_state(tb, mode, g, d)
        w0 = {k: v.clone() for k, v in st.generator.state_dict().items()}
        step = TB.make_train_step(tb)
        ms = [step(st, tbatch)[1] for _ in range(3)]
        out.append(([{k: float(v) for k, v in m.items()} for m in ms],
                    st.generator.state_dict()))
        assert all(np.isfinite(list(m.values())).all() for m in out[-1][0])
        assert any(not torch.equal(w0[k], v) for k, v in out[-1][1].items())
    assert calls == {"rows": 12, "flow": 0}
    assert out[0][0] == out[1][0]
    assert all(torch.equal(v, out[1][1][k]) for k, v in out[0][1].items())
    _, m = TB.make_train_step(tb, train_d=False)(st, tbatch)
    assert "g_total" in m and "d_total" not in m


# -- the CLI and the registry -------------------------------------------------

def test_cli_train_baseline_checkpoints_and_resumes(tmp_path, capsys,
                                                    monkeypatch):
    """cli.train --model texture_warping on the CPU (64², batch 2, the
    full-width ablation generator, the synthetic dataset cut to 4 items:
    2 steps an epoch): epoch 1 writes the four checkpoint files and no
    visuals (no validation pass, as in JAX); a second call with
    --load_epoch -1 resumes and writes epoch 2, Adam's step count going
    on from 2 to 4."""
    real = tcli.dataset_by_name

    def short(name, cfg, ids_file=None, **kw):
        ds = real(name, cfg, ids_file=ids_file, **kw)
        ds.length = 4
        return ds
    monkeypatch.setattr(tcli, "dataset_by_name", short)
    args = ["--model", "texture_warping", "--dataset_mode", "synthetic",
            "--device", "cpu", "--image_size", str(S), "--repeat_num", "1",
            "--d_layers", "2", "--batch_size", "2", "--no-use_vgg",
            "--no-use_face", "--n_threads", "2", "--checkpoints_dir",
            str(tmp_path), "--name", "tw", "--print_freq_s", "0",
            "--display_freq_s", "0", "--nepochs_no_decay", "1"]
    tcli.main(args + ["--nepochs_decay", "0"])
    exp = tmp_path / "tw"
    names = set(os.listdir(exp))
    assert {f"{k}_epoch_1_id_{l}.pth" for k in ("net", "opt")
            for l in "GD"} <= names
    assert not (exp / "visuals").exists() or not os.listdir(exp / "visuals")
    assert '"phase": "val"' not in open(exp / "loss_log.jsonl").read()
    state = tcli.main(args + ["--nepochs_decay", "1", "--load_epoch", "-1"])
    out = capsys.readouterr().out
    assert "resumed from epoch 1" in out and "saved epoch 2" in out
    assert isinstance(state.generator, ConcatGenerator)
    assert state.discriminator.model[0].in_channels == 9
    p = next(state.generator.parameters())
    assert int(state.g_opt.state[p]["step"]) == 4
