"""The background-augmented trainer (``impersonator_trainer_aug``), its
Global + Local and multi-scale discriminators and their converters, the
body-box crop, and the trainer registry, against the JAX package on the
CPU.

Sizes are the JAX package's own aug-trainer tests' (64², conv_dim 8, 2
residual blocks, batch 2, 2-layer PatchGANs; tests/train_ref.py builds
both trainers with the same frozen VGG19 and Sphere20a). The losses are
compared on JAX's body_recovery_flow products, with the JAX loss
functions its train step differentiates. Tolerances and the measured
gaps are in each test's docstring.
"""

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from impersonator_tpu.models.baseline import ConcatGenerator as JConcat
from impersonator_tpu.models.discriminator import \
    GlobalLocalDiscriminator as JGL
from impersonator_tpu.models.discriminator import \
    MultiScaleDiscriminator as JMS
from impersonator_tpu.models.discriminator import \
    crop_resize_bbox as j_crop
from impersonator_tpu.tasks import trainer as JT
from impersonator_tpu.tasks import trainer_aug as JA
from impersonator_tpu_torch import assets as tassets
from impersonator_tpu_torch import models as tmodels
from impersonator_tpu_torch.cli import train as tcli
from impersonator_tpu_torch.config import TrainConfig as TCfg
from impersonator_tpu_torch.data.datasets import SyntheticPairDataset
from impersonator_tpu_torch.data.loader import _collate, stage_batch
from impersonator_tpu_torch.models.baseline import (ConcatGenerator,
                                                    FeatureWarpingGenerator)
from impersonator_tpu_torch.models.discriminator import (
    GlobalLocalDiscriminator, MultiScaleDiscriminator, PatchDiscriminator,
    crop_resize_bbox)
from impersonator_tpu_torch.models.generator import \
    ImpersonatorGenerator as TGen
from impersonator_tpu_torch.ops import cuda_raster
from impersonator_tpu_torch.tasks import factory
from impersonator_tpu_torch.tasks import trainer as TT
from impersonator_tpu_torch.tasks import trainer_aug as TA
from impersonator_tpu_torch.tasks import trainer_baseline as TB
from impersonator_tpu_torch.utils import checkpoint as tckpt
from impersonator_tpu_torch.utils import convert
from tools import convert_weights as cw

from train_ref import (CONV_DIM, REPEAT, S, Pair, capture_loss_fns,  # noqa: F401
                       grads_by_name, l2_gaps, np_tree, one_torch_thread,
                       perturbed, port_inputs, rel)

# every G term but style (VGG, face, BCE mask and its TV smoothing), with
# gradients; the style term (VGG at 224²) with the MSE mask, the doubled
# background batch and no smoothing, forward only
ALL_TERMS = dict(use_vgg=True, use_style=False, use_face=True,
                 mask_bce=True, lambda_mask_smooth=1.0)
STYLE_BG_BOTH = dict(use_vgg=False, use_style=True, lambda_style=2.0,
                     use_face=False, mask_bce=False, bg_both=True,
                     lambda_mask_smooth=0.0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2).contiguous()


# -- the crop and the discriminators ------------------------------------------

# [min_x, max_x, min_y, max_y] in pixels: inside, the whole image, over
# the border, degenerate (span <= 1: a repeated row / column), and
# fractional edges at the far border
BOXES = np.array([[3.2, 50.7, 10.1, 60.3], [0, 64, 0, 64],
                  [-5.0, 20.0, 40.0, 70.0], [30.0, 30.5, 10.0, 11.0],
                  [62.5, 64.0, 0.0, 1.0], [12.0, 13.9, 63.0, 64.0]],
                 np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_crop_resize_bbox_matches_jax(dtype):
    """crop_resize_bbox on six boxes (inside, whole, over the border,
    degenerate, at the far edges) to 64² and 32x48: float32 within 1e-5
    of JAX's (measured 1.8e-7); a bf16 image (the local D's input under
    --train_dtype bfloat16, the boxes float32) equal to JAX's bf16 crop
    (the sampler's JAX arithmetic; measured equal)."""
    imgs = np.random.default_rng(1).uniform(-1, 1, (6, S, S, 6)).astype(
        np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    for oh, ow in ((S, S), (32, 48)):
        want = np.asarray(j_crop(jnp.asarray(imgs).astype(jdt),
                                 jnp.asarray(BOXES), oh, ow).astype(
                                     jnp.float32))
        got = crop_resize_bbox(_nchw(imgs).to(tdt), _t(BOXES), oh, ow)
        assert got.dtype == tdt and got.shape == (6, 6, oh, ow)
        got = got.float().permute(0, 2, 3, 1).numpy()
        if dtype == "bfloat16":
            assert np.array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= 1e-5
    # a degenerate box repeats its first column
    assert np.all(got[3] == got[3][:, :1])


def _global_local_params(norm, seed=3):
    jd = JGL(ndf=16, n_layers=2, norm_type=norm)
    p = jax.jit(jd.init)(jax.random.PRNGKey(seed), jnp.zeros((1, S, S, 4)),
                         jnp.zeros((1, S, S, 6)), jnp.zeros((1, 4)))
    p = perturbed(p, seed)
    if norm == "batch":      # running variances stay positive
        p["batch_stats"] = jax.tree_util.tree_map(np.abs, p["batch_stats"])
    return jd, p


@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_global_local_discriminator_matches_jax(norm):
    """GlobalLocalDiscriminator (4-channel global, 6-channel local over the
    body crop) from JAX params perturbed off their init through
    utils.convert.global_local_state_dict_from_jax (strict): the output,
    global then local on the batch axis, within 1e-4 of its largest
    magnitude (measured ≤ 9.2e-6); the registry builds the same module."""
    jd, p = _global_local_params(norm)
    rng = np.random.default_rng(2)
    g = rng.uniform(-1, 1, (2, S, S, 4)).astype(np.float32)
    loc = rng.uniform(-1, 1, (2, S, S, 6)).astype(np.float32)
    rects = BOXES[:2]
    want = np.asarray(jax.jit(jd.apply)(p, g, loc, rects))
    td = tmodels.get_by_name("global_local", global_nc=4, local_nc=6,
                             ndf=16, n_layers=2, norm_type=norm)
    assert isinstance(td, GlobalLocalDiscriminator)
    td.load_state_dict(convert.global_local_state_dict_from_jax(p))
    with torch.no_grad():
        got = td(_nchw(g), _nchw(loc), _t(rects)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (4, 14, 14, 1)
    assert rel(got.numpy(), want) <= 1e-4


def test_multi_scale_discriminator_matches_jax():
    """MultiScaleDiscriminator (3 scales at 64², 32² and 64², 6 channels)
    through multi_scale_state_dict_from_jax: each scale's output within
    1e-4 of its largest magnitude (measured ≤ 4.7e-7)."""
    jd = JMS(n_scales=3, ndf=8, n_layers=2)
    rng = np.random.default_rng(4)
    xs = [rng.uniform(-1, 1, (2, s, s, 6)).astype(np.float32)
          for s in (S, 32, S)]
    p = perturbed(jax.jit(jd.init)(jax.random.PRNGKey(0),
                                   [jnp.asarray(x) for x in xs]), 5)
    want = jax.jit(jd.apply)(p, [jnp.asarray(x) for x in xs])
    td = tmodels.get_by_name("multi_scale", input_nc=6, n_scales=3, ndf=8,
                             n_layers=2)
    assert isinstance(td, MultiScaleDiscriminator)
    td.load_state_dict(convert.multi_scale_state_dict_from_jax(p))
    with torch.no_grad():
        got = td([_nchw(x) for x in xs])
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert rel(a.permute(0, 2, 3, 1).numpy(), b) <= 1e-4
    with pytest.raises(ValueError):
        tmodels.get_by_name("no_such_net")


def _concat_params():
    jg = JConcat(conv_dim=4, repeat_num=1)
    return jg, jax.jit(jg.init)(jax.random.PRNGKey(1),
                                jnp.zeros((1, 32, 32, 4)),
                                jnp.zeros((1, 32, 32, 9)))


@pytest.mark.parametrize("net", ["global_local", "concat"])
def test_adam_state_converts_and_checkpoints(net, tmp_path):
    """Two optax inject_hyperparams(adam) updates of the Global + Local D's
    or the concat generator's params, converted into torch.optim.Adam
    through adam_state_dict_from_optax with the net's converter: a third
    update with the same gradient gives the same params within 1e-6
    (measured ≤ 1.5e-8); the state saved with utils.checkpoint under the
    reference's file names and loaded back is equal."""
    if net == "global_local":
        _, params = _global_local_params("instance")
        conv_fn = convert.global_local_state_dict_from_jax
        module = GlobalLocalDiscriminator(4, 6, 16, 2)
    else:
        _, params = _concat_params()
        params = np_tree(params)
        conv_fn = convert.generator_state_dict_from_jax
        module = ConcatGenerator(tsf_dim=9, conv_dim=4, repeat_num=1)
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=2e-4, b1=0.5,
                                              b2=0.999)
    state = tx.init(params)
    rng = np.random.default_rng(7)
    grads = [jax.tree_util.tree_map(
        lambda v: rng.normal(0, 1e-2, np.shape(v)).astype(np.float32),
        params) for _ in range(3)]
    update = jax.jit(tx.update)
    for g in grads[:2]:
        upd, state = update(g, state, params)
        params = np_tree(optax.apply_updates(params, upd))
    upd, _ = update(grads[2], state, params)
    final = conv_fn(np_tree(optax.apply_updates(params, upd)))
    module.load_state_dict(conv_fn(params))
    opt = TT.adam(module.parameters(), 2e-4, 0.5, 0.999)
    opt.load_state_dict(convert.adam_state_dict_from_optax(
        serialization.to_state_dict(np_tree(state)), conv_fn, module, opt))
    tckpt.save_network(module, str(tmp_path), "D", 3)
    tckpt.save_optimizer(opt, str(tmp_path), "D", 3)
    g_t = conv_fn(grads[2])
    for n, p in module.named_parameters():
        p.grad = g_t[n]
    opt.step()
    for n, p in module.named_parameters():
        assert float((p.detach() - final[n]).abs().max()) <= 1e-6, n
    again = copy.deepcopy(module)
    tckpt.load_network(again, str(tmp_path), "D", 3)
    opt2 = TT.adam(again.parameters(), 1.0, 0.5, 0.999)
    tckpt.load_optimizer(opt2, str(tmp_path), "D", 3)
    assert sorted(os.listdir(tmp_path)) == ["net_epoch_3_id_D.pth",
                                            "opt_epoch_3_id_D.pth"]
    assert opt2.param_groups[0]["lr"] == pytest.approx(2e-4)
    p0 = next(again.parameters())
    assert int(opt2.state[p0]["step"]) == 2


# -- the augmented trainer ----------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    return Pair()


def aug_batch(idx=(0, 1)):
    """(JAX batch NHWC, port batch NCHW) of synthetic_bg items."""
    ds = SyntheticPairDataset(S, with_bg=True)
    host = _collate([ds[i] for i in idx])
    return ({k: jnp.asarray(v) for k, v in host.items()},
            stage_batch(host, "cpu"))


def _trainers(pair, **kw):
    """(JAX aug trainer, port AugTrainer) at 64², conv_dim 8, 2-layer
    Global + Local D, the same frozen nets."""
    jtr, ttr = pair.trainers(model="impersonator_trainer_aug", **kw)
    jtr = dataclasses.replace(jtr, discriminator=JGL(
        ndf=64, n_layers=2, norm_type=jtr.cfg.norm_type))
    return jtr, TA.AugTrainer(**{f.name: getattr(ttr, f.name)
                                 for f in dataclasses.fields(ttr)})


def _states(pair, jtr, ttr):
    """(JAX TrainState, port TrainState) from pair's generator weights and
    one Global + Local D (flax init)."""
    g = cw.convert_generator(pair.sd, repeat=REPEAT)
    d = np_tree(jax.jit(jtr.discriminator.init)(
        jax.random.PRNGKey(5), jnp.zeros((1, S, S, 4)),
        jnp.zeros((1, S, S, 6)), jnp.zeros((1, 4))))
    jstate = JT.TrainState(g, d, jtr.g_tx.init(g), jtr.d_tx.init(d),
                           jnp.zeros((), jnp.int32))
    tgen = TGen(conv_dim=CONV_DIM, repeat_num=REPEAT)
    tgen.load_state_dict(pair.sd)
    tdisc = GlobalLocalDiscriminator(4, 6, 64, 2, ttr.cfg.norm_type)
    tdisc.load_state_dict(convert.global_local_state_dict_from_jax(d))
    return jstate, TA.init_aug_state(ttr, tgen, tdisc)


def _jax_inputs(jtr, jb):
    """JAX's aug preprocessing: body_recovery_flow and the masked Places2
    stream, as its train step builds them."""
    def prep(b):
        out = JT.body_recovery_flow(
            jtr.renderer, jtr.smpl_params, jtr.assets.parents,
            b["images"][:, 0], b["images"][:, 1], b["smpls"][:, 0],
            b["smpls"][:, 1], bg_both=jtr.cfg.bg_both)
        mask = out["input_G_bg"][..., -1:]
        out["input_G_aug_bg"] = jnp.concatenate([b["bg"] * mask, mask], -1)
        return out
    return jax.jit(prep)(jb)


def _run(pair, cfg_kw, grads=True):
    """Both packages' aug G and D losses (and gradients) on JAX's
    preprocessing of synthetic_bg items 0, 1; D's on JAX's fakes in both."""
    jtr, ttr = _trainers(pair, **cfg_kw)
    jstate, ts = _states(pair, jtr, ttr)
    jb, tb = aug_batch()
    g_fn, d_fn = capture_loss_fns(JA.make_aug_train_step(jtr), jstate, jb)
    jin = _jax_inputs(jtr, jb)
    real_src, real_tsf, real_bg = (jb["images"][:, 0], jb["images"][:, 1],
                                   jb["bg"])
    tin = port_inputs(jin)
    treal = (tb["images"][:, 0], tb["images"][:, 1], tb["bg"])
    tg_fn, td_fn = TA.make_aug_loss_fns(ttr)
    gen, disc = ts.generator, ts.discriminator
    out = {}
    if not grads:
        _, (m_j, fake_bg_j, fake_j) = jax.jit(g_fn)(
            jstate.g_params, jstate.d_params, jin, real_src, real_tsf,
            real_bg)
        with torch.no_grad():
            _, (m_t, fake_bg_t, fake_t) = tg_fn(gen, disc, tin, *treal)
        out.update(m_j={k: float(v) for k, v in m_j.items()},
                   m_t={k: float(v) for k, v in m_t.items()},
                   fake=(fake_t.permute(0, 2, 3, 1).numpy(),
                         np.asarray(fake_j)))
        return out
    (_, (m_j, fake_bg_j, fake_j)), gg_j = jax.jit(jax.value_and_grad(
        g_fn, has_aux=True))(jstate.g_params, jstate.d_params, jin,
                             real_src, real_tsf, real_bg)
    (_, dm_j), dg_j = jax.jit(jax.value_and_grad(d_fn, has_aux=True))(
        jstate.d_params, fake_bg_j, fake_j, real_bg, real_tsf, jin)
    total, (m_t, fake_bg_t, fake_t) = tg_fn(gen, disc, tin, *treal)
    gg_t = grads_by_name(gen, total)
    d_loss, dm_t = td_fn(disc, _nchw(fake_bg_j), _nchw(fake_j), treal[2],
                         treal[1], tin)
    dg_t = grads_by_name(disc, d_loss)
    assert all(p.grad is None for p in disc.parameters())
    out.update(
        m_j={k: float(v) for k, v in {**m_j, **dm_j}.items()},
        m_t={k: float(v) for k, v in {**m_t, **dm_t}.items()},
        fake=(fake_t.detach().permute(0, 2, 3, 1).numpy(),
              np.asarray(fake_j)),
        fake_bg=(fake_bg_t.detach().permute(0, 2, 3, 1).numpy(),
                 np.asarray(fake_bg_j)),
        g=(gg_t, convert.generator_state_dict_from_jax(np_tree(gg_j))),
        d=(dg_t, convert.global_local_state_dict_from_jax(np_tree(dg_j))))
    return out


@pytest.fixture(scope="module")
def runs(pair):
    return {"all": _run(pair, ALL_TERMS),
            "style_bg_both": _run(pair, STYLE_BG_BOTH, grads=False)}


@pytest.mark.parametrize("cfg", ["all", "style_bg_both"])
def test_aug_losses_match_jax(runs, cfg):
    """Every G term of the aug loss (VGG and style each over both the
    target and the restored Places2 background) and the Global + Local
    D's loss on fixed inputs within 1e-4 relative of JAX's (measured ≤
    1.1e-6), a term that is on never 0, and the fake target and the
    restored background within 1e-4 of their largest magnitude (the
    generator's bound; measured ≤ 3.8e-5). With bg_both the background
    batch is [src, aug, tsf]."""
    r = runs[cfg]
    assert set(r["m_t"]) == set(r["m_j"])
    for k, ref in r["m_j"].items():
        got = r["m_t"][k]
        assert np.isfinite(got), k
        assert abs(got - ref) <= 1e-4 * max(abs(ref), 1e-12), (k, got, ref)
    on = {"all": ["g_adv", "g_rec", "g_tsf", "g_face", "g_mask",
                  "g_mask_smooth", "d_loss", "d_real", "d_fake"],
          "style_bg_both": ["g_adv", "g_rec", "g_style", "g_mask"]}[cfg]
    for k in on:
        assert r["m_t"][k] != 0.0, k
    for key in ("fake", "fake_bg") if cfg == "all" else ("fake",):
        a, b = r[key]
        assert a.shape == b.shape
        assert rel(a, b) <= 1e-4, key


def test_aug_gradients_match_jax(runs):
    """G's gradient with every term on within the base trainer's 1e-2 per
    tensor and 5e-3 over all (L2) of JAX's (measured 4.0e-3 / 9.7e-4;
    each package's float32 gradient is ~3.2e-3 per tensor from the
    port's float64 one); the
    Global + Local D's gradient on the same fakes within 1e-3 per tensor
    and over all of JAX's (measured ≤ 5.6e-6), the biases of the convs
    before an instance norm (0 in exact arithmetic, in both halves) held
    below 1e-5 of the whole gradient's norm in both instead."""
    r = runs["all"]
    gg_t, gg_j = r["g"]
    assert set(gg_t) == set(gg_j)
    per, total = l2_gaps(gg_t, gg_j)
    assert per <= 1e-2 and total <= 5e-3, (per, total)
    dg_t, dg_j = r["d"]
    norm = float(torch.cat([v.flatten() for v in dg_j.values()]).norm())
    noise = [k for k, v in dg_j.items() if float(v.norm()) <= 1e-5 * norm]
    assert sorted(noise) == [f"{m}.model.{i}.bias"
                             for m in ("global_model", "local_model")
                             for i in (2, 5)]
    for k in noise:
        assert float(dg_t[k].norm()) <= 1e-5 * norm, k
    keep = [k for k in dg_j if k not in noise]
    per, _ = l2_gaps({k: dg_t[k] for k in keep}, {k: dg_j[k] for k in keep})
    _, total = l2_gaps(dg_t, dg_j)
    assert per <= 1e-3 and total <= 1e-3, (per, total)


def test_aug_bf16_losses_match_jax_bf16(pair):
    """Both packages' aug losses in bf16 (--train_dtype bfloat16: G, both
    D halves and VGG on bf16 copies of the float32 weights, the body
    rects and T float32, the local crop through the sampler's bf16 JAX
    arithmetic) on JAX's preprocessing, every term but style on: each
    loss within 1e-2 relative of JAX's (the base trainer's bf16 bound,
    tests/test_torch_train_loop.py; measured ≤ 2.4e-3) and the fake
    target's mean gap within 1.5e-2 (measured 5.9e-3)."""
    r = _run(pair, dict(ALL_TERMS, train_dtype="bfloat16"), grads=False)
    for k, ref in r["m_j"].items():
        assert abs(r["m_t"][k] - ref) <= 1e-2 * max(abs(ref), 1e-6), k
    gap = np.abs(r["fake"][0] - r["fake"][1])
    assert gap.mean() <= 1.5e-2, gap.mean()


def _small(pair, **kw):
    """A port AugTrainer without the frozen nets, and a fresh state of a
    conv_dim 8 generator and a 2-layer Global + Local D (seed 0)."""
    _, ttr = _trainers(pair, use_vgg=False, use_style=False, use_face=False,
                       **kw)
    rng = torch.Generator().manual_seed(0)
    gen = TGen(conv_dim=CONV_DIM, repeat_num=REPEAT)
    TT.init_weights(gen, rng)
    return ttr, ttr.init_state(gen, seed=0)


def test_aug_remat_matches_no_remat(pair):
    """--remat recomputes G's forward in the backward pass: one aug step
    with it and one without, from the same weights, give the same losses
    and the same updated G and D weights, bit for bit."""
    tb = aug_batch()[1]
    out = []
    for remat in (False, True):
        ttr, st = _small(pair, remat=remat)
        st, m = TA.make_aug_train_step(ttr)(st, tb)
        out.append(({k: float(v) for k, v in m.items()},
                    {**st.generator.state_dict(),
                     **st.discriminator.state_dict()}))
    assert out[0][0] == out[1][0]
    for k, v in out[0][1].items():
        assert torch.equal(v, out[1][1][k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_aug_steps_launch_both_kernels_and_keep_masters(pair, dtype,
                                                        monkeypatch):
    """Two G+D steps and one G-only step: each rasterises once through
    zbuffer_bucket_rows (the source) and once through zbuffer_bucket_flow
    (the target with the flow); the losses are finite, both nets move,
    the G-only step leaves D and has no D metrics; under bf16 the master
    weights, their gradients and Adam's moments stay float32 and the
    losses are within 5e-2 (|a - b| / max(|a|, 1)) of the float32 step's
    (the base trainer's bound)."""
    calls = {"zbuffer_bucket_rows": 0, "zbuffer_bucket_flow": 0}
    for name in calls:
        real = getattr(cuda_raster, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(cuda_raster, name, counted)
    tb = aug_batch()[1]
    ttr, st = _small(pair, train_dtype=dtype)
    w0 = {n: {k: v.clone() for k, v in net.state_dict().items()}
          for n, net in (("G", st.generator), ("D", st.discriminator))}
    step = TA.make_aug_train_step(ttr)
    ms = [step(st, tb)[1] for _ in range(2)]
    d_before = {k: v.clone() for k, v in st.discriminator.state_dict().items()}
    st, m_g = TA.make_aug_train_step(ttr, train_d=False)(st, tb)
    assert calls == {"zbuffer_bucket_rows": 3, "zbuffer_bucket_flow": 3}
    assert "d_loss" in ms[0] and "d_loss" not in m_g
    assert all(np.isfinite(float(v)) for m in ms + [m_g] for v in m.values())
    assert all(torch.equal(v, d_before[k])
               for k, v in st.discriminator.state_dict().items())
    for n, net in (("G", st.generator), ("D", st.discriminator)):
        assert any(not torch.equal(v, w0[n][k])
                   for k, v in net.state_dict().items()), n
    for net, opt in ((st.generator, st.g_opt),
                     (st.discriminator, st.d_opt)):
        for p in net.parameters():
            assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
            assert opt.state[p]["exp_avg"].dtype == torch.float32
    if dtype == "bfloat16":
        ttr32, st32 = _small(pair)
        _, m32 = TA.make_aug_train_step(ttr32)(st32, tb)
        for k in ("g_total", "g_rec", "g_adv", "g_mask", "d_loss"):
            a, b = float(m32[k]), float(ms[0][k])
            assert abs(a - b) / max(abs(a), 1.0) < 5e-2, (k, a, b)


def test_cli_train_aug_checkpoints_and_resumes(tmp_path, capsys,
                                               monkeypatch):
    """cli.train --model impersonator_trainer_aug on the CPU with
    --dataset_mode auto and no SMPL model: the synthetic_bg pairs (cut to
    4 items: 2 steps an epoch at batch 2), the full-width generator and
    the Global + Local D; epoch 1 writes the four checkpoint files and no
    validation pass; a second call with --load_epoch -1 resumes into
    epoch 2 and Adam's step count goes on from 2 to 4."""
    real = tcli.dataset_by_name
    names = []

    def short(name, cfg, ids_file=None, **kw):
        names.append(name)
        ds = real(name, cfg, ids_file=ids_file, **kw)
        ds.length = 4
        return ds
    monkeypatch.setattr(tcli, "dataset_by_name", short)
    args = ["--model", "impersonator_trainer_aug", "--device", "cpu",
            "--image_size", str(S), "--repeat_num", "1", "--d_layers", "2",
            "--batch_size", "2", "--no-use_vgg", "--no-use_face",
            "--n_threads", "2", "--checkpoints_dir", str(tmp_path),
            "--name", "aug", "--print_freq_s", "0", "--display_freq_s", "0",
            "--nepochs_no_decay", "1"]
    tcli.main(args + ["--nepochs_decay", "0"])
    assert names == ["synthetic_bg"]
    exp = tmp_path / "aug"
    assert {f"{k}_epoch_1_id_{l}.pth" for k in ("net", "opt")
            for l in "GD"} <= set(os.listdir(exp))
    log = open(exp / "loss_log.jsonl").read()
    assert '"phase": "val"' not in log and "d_loss" in log
    state = tcli.main(args + ["--nepochs_decay", "1", "--load_epoch", "-1"])
    out = capsys.readouterr().out
    assert "resumed from epoch 1" in out and "saved epoch 2" in out
    assert isinstance(state.discriminator, GlobalLocalDiscriminator)
    p = next(state.generator.parameters())
    assert int(state.g_opt.state[p]["step"]) == 4


def test_factory_builds_every_trainer():
    """tasks.factory.get_by_name routes the four trainer names of this
    slice to their trainers (none raises "not ported"), each building
    its own nets: the LWB generator with the Global + Local D for the aug
    trainer, the ablation generator with the 9-channel PatchGAN for each
    baseline; an unknown name raises ValueError."""
    assets = tassets.synthetic_assets()
    want = {"impersonator_trainer_aug": (TGen, GlobalLocalDiscriminator),
            "concat": (ConcatGenerator, PatchDiscriminator),
            "texture_warping": (ConcatGenerator, PatchDiscriminator),
            "feature_warping": (FeatureWarpingGenerator,
                                PatchDiscriminator)}
    for name, (gen_cls, disc_cls) in want.items():
        cfg = TCfg(model=name, image_size=S, repeat_num=1, d_layers=2,
                   use_vgg=False, use_face=False)
        tr = factory.get_by_name(name, cfg, device="cpu", assets=assets)
        assert tr.device.type == "cpu"
        assert type(tr.new_generator()) is gen_cls
        disc = tr.new_discriminator()
        assert type(disc) is disc_cls
        if name == "texture_warping":
            assert tr.new_generator().tsf_model.encoders[0][0].in_channels \
                == 6
        if name != "impersonator_trainer_aug":
            assert isinstance(tr, TB.BaselineTrainer)
            assert disc.model[0].in_channels == 9
    with pytest.raises(ValueError):
        factory.get_by_name("no_such_model", cfg, device="cpu")
