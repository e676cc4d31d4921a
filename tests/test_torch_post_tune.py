"""Test-time post-tune: the port's losses, face nets and tune loop against
the JAX package on the CPU, float32, 64², conv_dim 8, 2 residual blocks,
with seeded random weights carried across (the real face, VGG and
prior-pose files are not in the repository).

The port runs the raster through the bucket kernels' plain twins, the
JAX package through its brute path; their flows differ by up to ~7e-4
(the reference's CPU FMA contraction, ROADMAP.md), which bounds T and
T_cycle at 1e-3 as the raster tests do. Where a comparison should see
the tune arithmetic alone, both packages get the same pair batch.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from impersonator_tpu import config
from impersonator_tpu.models import HumanModelRecovery as JHMR
from impersonator_tpu.models import facenet as jface
from impersonator_tpu.models import losses as jL
from impersonator_tpu.models.generator import ImpersonatorGenerator as JGen
from impersonator_tpu.ops import sampler as jsampler
from impersonator_tpu.tasks import imitator as JI
from impersonator_tpu.tasks import post_tune as JP
from impersonator_tpu.tasks import swapper as JS
from impersonator_tpu_torch import assets as tassets
from impersonator_tpu_torch.config import TestConfig as TConfig
from impersonator_tpu_torch.models import facenet as tface
from impersonator_tpu_torch.models import losses as tL
from impersonator_tpu_torch.models.generator import \
    ImpersonatorGenerator as TGen
from impersonator_tpu_torch.models.hmr import HumanModelRecovery as THMR
from impersonator_tpu_torch.ops import sampler as tsampler
from impersonator_tpu_torch.tasks import imitator as TI
from impersonator_tpu_torch.tasks import post_tune as TP
from impersonator_tpu_torch.tasks import swapper as TS
from impersonator_tpu_torch.tasks import viewer as TV
from impersonator_tpu_torch.utils import convert
from tools import convert_weights as cw

import torch_ref

S, CONV_DIM, REPEAT, LR = 64, 8, 2, 2e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


def _rel(a, b):
    """max |a - b| / max |b|."""
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def nets():
    """Reference-layout generator weights; flax-initialised Sphere20a,
    SENet50 (perturbed BatchNorm statistics), Vgg19 and HMR params; and
    the port's modules loaded from them."""
    rng = np.random.default_rng(51)
    sd = {**torch_ref.make_bg_sd(rng, 4, CONV_DIM, REPEAT),
          **torch_ref.make_resunet_sd(rng, "src_model", 6, CONV_DIM, REPEAT),
          **torch_ref.make_resunet_sd(rng, "tsf_model", 6, CONV_DIM, REPEAT)}
    key = jax.random.PRNGKey(7)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    sphere = _np_tree(jax.jit(jface.Sphere20a().init)(
        k1, jnp.zeros((1, 112, 96, 3))))
    senet = _np_tree(jax.jit(jface.SENet50().init)(
        k2, jnp.zeros((1, 64, 64, 3))))
    senet["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.normal(0, 0.1, v.shape) if path[-1].key == "mean"
                         else rng.uniform(0.5, 1.5, v.shape))
        .astype(np.float32), senet["batch_stats"])
    vgg = _np_tree(jax.jit(jL.Vgg19().init)(k3, jnp.zeros((1, 32, 32, 3))))
    hmr = _np_tree(jax.jit(JHMR().init)(k4, jnp.zeros((1, 224, 224, 3))))
    hmr["params"]["regressor"]["mean_theta"] = np.zeros(85, np.float32)
    port = {"sphere": tface.Sphere20a(), "senet": tface.SENet50(),
            "vgg": tL.Vgg19(), "hmr": THMR()}
    for name, fn, tree in (
            ("sphere", convert.sphere20a_state_dict_from_jax, sphere),
            ("senet", convert.senet50_state_dict_from_jax, senet),
            ("vgg", convert.vgg19_state_dict_from_jax, vgg),
            ("hmr", convert.hmr_state_dict_from_jax, hmr)):
        port[name].load_state_dict(fn(tree), strict=True)
        port[name].eval().requires_grad_(False)
    ref = {"sphere": (jface.Sphere20a(), sphere),
           "senet": (jface.SENet50(), senet), "vgg": (jL.Vgg19(), vgg),
           "hmr": (JHMR(), hmr)}
    return sd, port, ref


def _port_gen(sd):
    gen = TGen(conv_dim=CONV_DIM, repeat_num=REPEAT)
    gen.load_state_dict(sd, strict=True)
    return TI.ImitatorNets(gen)


def _jax_nets(sd):
    gen = JGen(bg_dim=4, src_dim=6, tsf_dim=6, conv_dim=CONV_DIM,
               repeat_num=REPEAT)
    return JI.ImitatorNets(gen, cw.convert_generator(sd, repeat=REPEAT),
                           JHMR(), None, None, None)


def _theta(rng, cam=0.9, pose=0.05):
    t = np.zeros(85, np.float32)
    t[0] = cam
    t[3:75] = rng.normal(0, pose, 72)
    return t


def _image(seed, s=S):
    return np.random.default_rng(seed).uniform(-1, 1, (s, s, 3)) \
        .astype(np.float32)


def _tasks(sd, assets, port_cls=TI.Imitator, ref_cls=JI.Imitator, **kw):
    port = port_cls(TConfig(image_size=S, repeat_num=REPEAT,
                            compute_dtype="float32", **kw),
                    assets=tassets.synthetic_assets(), nets=_port_gen(sd),
                    device="cpu")
    ref = ref_cls(config.TestConfig(image_size=S, repeat_num=REPEAT,
                                    compute_dtype="float32", **kw),
                  assets=assets, nets=_jax_nets(sd))
    return port, ref


def _gen_state(port_gen, jax_params):
    """(port state dict, JAX params as a port state dict)."""
    return ({k: v.detach() for k, v in port_gen.state_dict().items()},
            convert.generator_state_dict_from_jax(_np_tree(jax_params)))


# -- sampler, face nets, VGG ---------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", [(112, 96), (224, 224), (1, 5)])
def test_resize_bilinear_align_matches_jax(dtype, size):
    x = np.random.default_rng(1).uniform(-1, 1, (2, 64, 48, 3)) \
        .astype(np.float32)
    ref = jsampler.resize_bilinear_align(
        jnp.asarray(x, getattr(jnp, dtype)), *size).astype(jnp.float32)
    out = tsampler.resize_bilinear_align(
        torch.from_numpy(x).to(getattr(torch, dtype)), *size)
    assert out.shape == (2, *size, 3)
    # bf16: equal; float32: XLA may fuse the lerp's multiply-adds
    tol = 0.0 if dtype == "bfloat16" else 2e-7
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("name", ["sphere", "senet", "vgg"])
def test_feature_nets_match_jax(nets, name):
    """Every output of Sphere20a (112×96), SENet50 (64², its five stages
    and the embedding) and Vgg19 (32², four features) within 1e-5 of the
    JAX net's largest magnitude."""
    _, port, ref = nets
    shape = {"sphere": (2, 112, 96, 3), "senet": (1, 64, 64, 3),
             "vgg": (2, 32, 32, 3)}[name]
    x = np.random.default_rng(2).uniform(-1, 1, shape).astype(np.float32)
    net, params = ref[name]
    out_j = jax.jit(net.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        out_t = port[name](torch.from_numpy(x).permute(0, 3, 1, 2))
    if name == "senet":
        out_j, out_t = [*out_j[0], out_j[1]], [*out_t[0], out_t[1]]
    assert len(out_t) == len(out_j) == {"sphere": 5, "senet": 6,
                                        "vgg": 4}[name]
    for a, b in zip(out_t, out_j):
        a = _nhwc(a) if a.ndim == 4 else a.numpy()
        assert a.shape == b.shape
        assert _rel(a, b) <= 1e-5


# -- the losses ----------------------------------------------------------------

def _kps(rng, b):
    return rng.uniform(-0.8, 0.8, (b, 19, 2)).astype(np.float32)


def _loss_pair(name, nets):
    """(port value, JAX value) of one loss on the same seeded inputs."""
    _, port, ref = nets
    rng = np.random.default_rng(3)
    a = rng.uniform(-1, 1, (2, S, S, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (2, S, S, 3)).astype(np.float32)
    ta, tb, ja, jb = _t(a), _t(b), jnp.asarray(a), jnp.asarray(b)
    kps1, kps2 = _kps(rng, 2), _kps(rng, 2)
    if name in ("vgg_loss", "style_loss"):
        vnet, vparams = ref["vgg"]
        fj = [vnet.apply(vparams, x) for x in (ja, jb)]
        with torch.no_grad():
            ft = [port["vgg"](x.permute(0, 3, 1, 2)) for x in (ta, tb)]
        fn = name
        return getattr(tL, fn)(*ft), getattr(jL, fn)(*fj)
    if name in ("head_bbox", "body_bbox"):
        fn = f"{name}_from_kps"
        return getattr(tL, fn)(_t(kps1)), getattr(jL, fn)(jnp.asarray(kps1))
    if name == "crop_resize":
        bbox = jL.head_bbox_from_kps(jnp.asarray(kps1))
        return (tL.crop_resize_fractional(ta, _t(bbox), 112, 96),
                jL.crop_resize_fractional(ja, bbox, 112, 96))
    if name == "face_loss_from_feats":
        f1 = [rng.normal(0, 1, (2, 8, 4, 4)).astype(np.float32)
              for _ in range(3)]
        f2 = [rng.normal(0, 1, (2, 8, 4, 4)).astype(np.float32)
              for _ in range(3)]
        return (tL.face_loss_from_feats([_t(x) for x in f1],
                                        [_t(x) for x in f2]),
                jL.face_loss_from_feats([jnp.asarray(x) for x in f1],
                                        [jnp.asarray(x) for x in f2]))
    if name.startswith("face_loss"):
        net = "senet" if name.endswith("senet") else "sphere"
        kw_t, kw_j = {}, {}
        if name.endswith("kps"):
            kw_t = {"kps1": _t(kps1), "kps2": _t(kps2)}
            kw_j = {"kps1": jnp.asarray(kps1), "kps2": jnp.asarray(kps2)}
        elif name.endswith("bbox"):
            bb = np.asarray(jL.body_bbox_from_kps(jnp.asarray(kps1)))
            kw_t, kw_j = {"bbox1": _t(bb)}, {"bbox1": jnp.asarray(bb)}
        jnet, jparams = ref[net]
        with torch.no_grad():
            out_t = tL.face_loss(port[net], ta[:1], tb[:1], **kw_t) \
                if net == "senet" else tL.face_loss(port[net], ta, tb, **kw_t)
        out_j = (jL.face_loss(jnet, jparams, ja[:1], jb[:1], **kw_j)
                 if net == "senet"
                 else jL.face_loss(jnet, jparams, ja, jb, **kw_j))
        return out_t, out_j
    if name == "hmr_loss":
        x = rng.uniform(-1, 1, (2, 224, 224, 3)).astype(np.float32)
        y = rng.uniform(-1, 1, (2, 224, 224, 3)).astype(np.float32)
        jnet, jparams = ref["hmr"]
        with torch.no_grad():
            out_t = tL.hmr_loss(port["hmr"], _t(x), _t(y))
        return out_t, jL.hmr_loss(jnet, jparams, jnp.asarray(x),
                                  jnp.asarray(y))
    if name == "lsgan_loss":
        return tL.lsgan_loss(ta, -1.0), jL.lsgan_loss(ja, -1.0)
    if name == "tv_smooth":
        return tL.tv_smooth(ta[..., :1]), jL.tv_smooth(ja[..., :1])
    pa, pb = (a + 1) / 2, (b > 0).astype(np.float32)       # probabilities
    if name == "bce":
        pa[0, 0, 0, 0], pa[0, 0, 1, 0] = 0.0, 1.0           # clipped ends
        return tL.bce(_t(pa), _t(pb)), jL.bce(jnp.asarray(pa),
                                              jnp.asarray(pb))
    return getattr(tL, name)(ta, tb), getattr(jL, name)(ja, jb)


LOSSES = ["vgg_loss", "style_loss", "head_bbox", "body_bbox", "crop_resize",
          "face_loss_from_feats", "face_loss_kps", "face_loss_bbox",
          "face_loss_resize", "face_loss_senet", "hmr_loss", "lsgan_loss",
          "tv_smooth", "l1", "bce", "mse"]


@pytest.mark.parametrize("name", LOSSES)
def test_losses_match_jax(nets, name):
    """Each loss and helper on the same inputs: within 1e-5 of the JAX
    value's largest magnitude (float32 sums in another order; the face
    and VGG features carry ~1e-6 of their own)."""
    out_t, out_j = _loss_pair(name, nets)
    out_t = np.asarray(out_t.detach())
    assert out_t.shape == np.shape(out_j)
    assert np.isfinite(out_t).all()
    assert _rel(out_t, out_j) <= 1e-5, (name, out_t, out_j)


def test_face_loss_detaches_its_second_images(nets):
    """Gradient reaches imgs1 and not imgs2 (JAX's stop_gradient on the
    second features)."""
    sphere = nets[1]["sphere"]
    rng = np.random.default_rng(4)
    a, b = (_t(rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32))
            .requires_grad_(True) for _ in range(2))
    tL.face_loss(sphere, a, b).backward()
    assert float(a.grad.abs().sum()) > 0 and b.grad is None


# -- priors, schedule, batch helpers -----------------------------------------

def test_prior_poses_match_jax(tmp_path):
    theta = _theta(np.random.default_rng(5))[None]
    np.testing.assert_array_equal(
        TP.default_prior_poses(torch.from_numpy(theta), n=6).numpy(),
        np.asarray(JP.default_prior_poses(jnp.asarray(theta), n=6)))
    arr = np.random.default_rng(6).normal(0, 1, (4, 85)).astype(np.float32)
    for i, obj in enumerate((arr, {"cams": arr[:, :3], "pose": arr[:, 3:75],
                                   "shape": arr[:, 75:]})):
        path = tmp_path / f"priors_{i}.pkl"
        path.write_bytes(pickle.dumps(obj))
        np.testing.assert_array_equal(TP.load_prior_poses(str(path)).numpy(),
                                      np.asarray(JP.load_prior_poses(
                                          str(path))))


def test_swapper_tune_lr_and_step_budget_match_jax():
    for i in range(60):
        for total in (50, 30):
            assert TP.swapper_tune_lr(i, total_iters=total) == \
                JP.swapper_tune_lr(i, total_iters=total)
    for n, e, b in ((8, 5, 4), (5, 3, 2), (3, 1, 8)):
        assert TP.post_tune_steps(n, e, b) == JP.post_tune_steps(n, e, b)


def test_merge_pair_batches_keeps_mask_kinds_grouped():
    def mk(src_v, tsf_v, other_v):
        return {"pseudo_masks": torch.cat(
                    [torch.full((2, 1, 1, 1), float(src_v)),
                     torch.full((2, 1, 1, 1), float(tsf_v))]),
                "T": torch.full((2, 1, 1, 2), float(other_v))}
    merged = TP.merge_pair_batches(mk(1, 2, 5), mk(3, 4, 6))
    assert merged["pseudo_masks"].reshape(-1).tolist() == \
        [1, 1, 3, 3, 2, 2, 4, 4]
    assert merged["T"][:, 0, 0, 0].tolist() == [5, 5, 6, 6]


# -- the pair batch and one tune step ---------------------------------------

@pytest.fixture(scope="module")
def pair_batches(nets, assets):
    """Both packages' float32 Imitators (front warp on) personalised on
    the same image and θ, four default priors, and each package's pair
    batch of them."""
    sd = nets[0]
    port, ref = _tasks(sd, assets, front_warp=True)
    img, theta = _image(8), _theta(np.random.default_rng(9))
    theta[3:6] = (0.0, np.pi, 0.0)          # facing the camera
    port.personalize(img, src_smpl=theta)
    ref.personalize(img, src_smpl=theta)
    priors = np.array(JP.default_prior_poses(ref.src_info["theta"], n=4))
    bt = TP.build_meta_pairs(port, torch.from_numpy(priors))
    bj = _np_tree(jax.jit(lambda pr: JP.build_meta_pairs(ref, pr))(
        jnp.asarray(priors)))
    return port, ref, bt, bj


def test_build_meta_pairs_matches_jax(pair_batches):
    _, _, bt, bj = pair_batches
    assert set(bt) == set(bj)
    for k, v in bt.items():
        assert tuple(v.shape) == bj[k].shape, k
        assert not v.requires_grad, k
    for k in ("src_fim", "tsf_fim", "pseudo_masks"):
        np.testing.assert_array_equal(bt[k].numpy(), bj[k], k)
    assert (bt["tsf_fim"] >= 0).float().mean() > 0.02
    for k in ("T", "T_cycle"):
        np.testing.assert_allclose(bt[k].numpy(), bj[k], atol=1e-3,
                                   err_msg=k)
    for k in ("src_inputs", "images_src", "j2d_src", "j2d_tsf"):
        np.testing.assert_allclose(bt[k].numpy(), bj[k], atol=1e-5,
                                   err_msg=k)
    # the warped source and the untuned preds: the T gap through a warp
    # of per-pixel noise, as tests/test_torch_slice.py bounds the preds
    for k in ("tsf_inputs", "init_preds"):
        np.testing.assert_allclose(bt[k].numpy(), bj[k], atol=1e-2,
                                   err_msg=k)


def _grad_tx():
    """An optax transformation that leaves the params and keeps the
    gradient in its state."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree_util.tree_map(jnp.zeros_like, p)},
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g),
                              {"g": g}))


def test_tune_step_gradient_matches_jax(pair_batches, nets):
    """One minibatch of JAX's pair batch through both losses, face loss
    on: the losses within 1e-4 relative, and the generator's gradient
    (jax.value_and_grad of the JAX step's loss against the port's
    backward) within 5e-2 per tensor and 2e-2 over all tensors, each
    as |g_port - g_jax| / |g_jax| in the L2 norm. The float32 gradient of
    this net is that ill-conditioned: the port's float32 gradient is
    2.2e-2 per tensor (9.8e-4 over all) from its own float64 one, and the
    largest single elements differ by up to ~6e-2 of their tensor's
    largest magnitude.

    The pairs' structure anchors are swapped (each pair gets the other's
    init_preds): the anchor is the untuned generator's own output, so on
    the real batch L1(init_preds, fake_tsf) compares an image with itself
    and its gradient is the sign of each package's rounding noise."""
    port, ref, _, bj = pair_batches
    jsphere, jparams = nets[2]["sphere"]
    idx = np.asarray([2, 0])
    mb = {k: (v[np.concatenate([idx, idx + 4])] if k == "pseudo_masks"
              else v[idx]) for k, v in bj.items()}
    mb["init_preds"] = mb["init_preds"][::-1]
    bg = np.repeat(np.asarray(ref.src_info["bg"]), 2, 0)
    step = JP.make_tune_step(ref, _grad_tx(), jsphere, jparams,
                             front_warp=True)
    _, state, metrics_j = step(ref.nets.gen_params,
                               _grad_tx().init(ref.nets.gen_params),
                               {k: jnp.asarray(v) for k, v in mb.items()},
                               jnp.asarray(bg))
    gen = port.nets.generator
    gen.zero_grad(set_to_none=True)
    total, metrics_t = TP.tune_loss(gen, port.renderer,
                                    {k: _t(v) for k, v in mb.items()},
                                    _t(bg), nets[1]["sphere"],
                                    front_warp=True)
    total.backward()
    for k, v in metrics_t.items():
        v, ref_v = float(v.detach()), float(metrics_j[k])
        assert abs(v - ref_v) <= 1e-4 * abs(ref_v), (k, v, ref_v)
    assert float(metrics_t["fid"]) > 0
    grads_j = convert.generator_state_dict_from_jax(_np_tree(state["g"]))
    n_live, worst, gt, gj = 0, 0.0, [], []
    for k, p in gen.named_parameters():
        if p.grad is None:          # the background stream: not in the loss
            assert np.abs(grads_j[k].numpy()).max() == 0.0, k
            continue
        n_live += 1
        worst = max(worst, float((p.grad - grads_j[k]).norm()
                                 / grads_j[k].norm()))
        gt.append(p.grad.flatten())
        gj.append(grads_j[k].flatten())
    gt, gj = torch.cat(gt), torch.cat(gj)
    assert n_live > 50
    assert worst <= 5e-2, worst                             # measured 2.6e-2
    assert float((gt - gj).norm() / gj.norm()) <= 2e-2      # measured 6.5e-3
    gen.zero_grad(set_to_none=True)


# -- the tune loops ------------------------------------------------------------

def _assert_adam_close(w_t, w_j, w_0, steps):
    """The port's and JAX's weights after ``steps`` Adam steps (lr LR,
    β 0.5 / 0.999) from w_0: every weight within 2·steps·1.1·lr (a step
    moves a weight by at most ~1.05·lr whatever its gradient's size, so
    this admits two runs whose steps differ in sign: the first step's
    structure gradient is the sign of rounding noise), and the two
    updates w - w_0 at a cosine of at least 0.7 (measured 0.81 after 3
    steps of adaptive_personalize, 0.87 after 4 of the swapper tune;
    unrelated updates give ~0)."""
    for k, v in w_t.items():
        assert float((v - w_j[k]).abs().max()) <= 2 * steps * 1.1 * LR, k
    dt = torch.cat([(w_t[k] - w_0[k]).flatten() for k in w_t])
    dj = torch.cat([(w_j[k] - w_0[k]).flatten() for k in w_t])
    assert float(dt @ dj) >= 0.7 * float(dt.norm() * dj.norm())


def test_adaptive_personalize_trajectory_matches_jax(nets, assets):
    """Three Adam steps (four priors, batch 4, three epochs) with the face
    loss in both packages from the same weights: each step's cycle loss
    and the last step's losses within 5e-3 relative (the structure loss
    compares two nearly equal images, so the raster gap weighs most
    there: measured 3.0e-3), and the final weights as
    _assert_adam_close bounds them."""
    sd, port_nets, ref_nets = nets
    port, ref = _tasks(sd, assets)
    img, theta = _image(10), _theta(np.random.default_rng(11))
    port.personalize(img, src_smpl=theta)
    ref.personalize(img, src_smpl=theta)
    priors = np.array(JP.default_prior_poses(ref.src_info["theta"], n=4))
    m_t = TP.adaptive_personalize(port, torch.from_numpy(priors), epochs=3,
                                  lr=LR, face=port_nets["sphere"])
    m_j = JP.adaptive_personalize(ref, jnp.asarray(priors), epochs=3, lr=LR,
                                  face=ref_nets["sphere"][0],
                                  face_params=ref_nets["sphere"][1])
    assert m_t["n_steps"] == m_j["n_steps"] == 3
    np.testing.assert_allclose(m_t["cyc_history"], m_j["cyc_history"],
                               rtol=5e-3)
    for k in ("cyc", "str", "fid", "msk", "total"):
        assert abs(m_t[k] - float(m_j[k])) <= 5e-3 * abs(float(m_j[k])), k
    w_t, w_j = _gen_state(port.nets.generator, ref.nets.gen_params)
    _assert_adam_close(w_t, w_j, _port_gen(sd).generator.state_dict(), 3)
    # the refreshed source state: personalised under the tuned weights
    fresh = TI.Imitator(port.cfg, assets=port.assets, nets=port.nets,
                        device="cpu")
    fresh.personalize(img, src_smpl=theta)
    for k in ("bg", "fim", "p2verts"):
        assert torch.equal(port.src_info[k], fresh.src_info[k]), k


def test_post_tune_improves_cycle_and_affects_inference(assets):
    """tests/test_tasks.py's post-tune test on the port (32², 1 residual
    block, the default bf16 compute dtype, seeded random nets): the cycle
    loss falls over the epochs, the step count is the reference's budget,
    and inference after the tune differs from inference before it (the
    bf16 compute copy is rebuilt from the tuned master)."""
    rng = np.random.default_rng(5)
    cfg = TConfig(image_size=32, repeat_num=1)
    imit = TI.Imitator(cfg, assets=tassets.synthetic_assets(), device="cpu")
    src = rng.uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    theta = np.zeros((85,), np.float32)
    theta[0] = 0.9
    imit.personalize(src, src_smpl=theta)
    tgt = np.tile(theta, (2, 1)).astype(np.float32)
    tgt[:, 3:75] += rng.normal(0, 0.1, (2, 72)).astype(np.float32)
    before = imit.inference_by_smpls(tgt, batch=2)

    priors = TP.default_prior_poses(imit.src_info["theta"], n=4)
    m_first = TP.adaptive_personalize(imit, prior_smpls=priors, epochs=1,
                                      batch_size=2)
    m_last = TP.adaptive_personalize(imit, prior_smpls=priors, epochs=4,
                                     batch_size=2)
    assert m_last["cyc"] < m_first["cyc"], (m_first, m_last)
    assert m_last["n_steps"] == TP.post_tune_steps(4, 4, 2) == 8
    hist = m_last["cyc_history"]
    assert len(hist) == 4
    assert hist[-1] < hist[0] and hist[-1] < hist[1], hist
    after = imit.inference_by_smpls(tgt, batch=2)
    assert torch.isfinite(after).all()
    assert float((after - before).abs().max()) > 1e-4
    assert imit.compute_nets.generator.tsf_model.img_reg[0].weight.dtype \
        == torch.bfloat16


def test_post_tune_swapper_matches_jax(nets, assets):
    """Four iterations of the two-pair swapper tune (lr 2e-4, inside the
    schedule's fixed part): the last step's losses within 5e-3 relative
    of JAX's, the final weights as _assert_adam_close bounds them; both
    states are then
    those of a fresh swap_setup under the tuned weights, with their part
    encodings, and the swap changed."""
    sd = nets[0]
    port, ref = _tasks(sd, assets, TS.Swapper, JS.Swapper)
    imgs = [_image(12), _image(13)]
    rng = np.random.default_rng(14)
    thetas = [_theta(rng), _theta(rng, 0.85, 0.08)]
    for task in (port, ref):
        task.swap_setup(imgs[0], imgs[1], *thetas)
    before = port.swap()
    m_t = TP.post_tune_swapper(port, iters=4)
    m_j = JP.post_tune_swapper(ref, iters=4)
    for k in ("cyc", "str", "msk", "total"):
        assert abs(m_t[k] - float(m_j[k])) <= 5e-3 * abs(float(m_j[k])), k
    w_t, w_j = _gen_state(port.nets.generator, ref.nets.gen_params)
    _assert_adam_close(w_t, w_j, _port_gen(sd).generator.state_dict(), 4)
    fresh = TS.Swapper(port.cfg, assets=port.assets, nets=port.nets,
                       device="cpu")
    fresh.swap_setup(imgs[0], imgs[1], *thetas)
    after = port.swap()
    assert torch.equal(after, fresh.swap())
    assert "part" in port.src_info and "part" in port.tsf_info
    assert float((after - before).abs().max()) > 1e-4


def test_viewer_post_personalize(nets, assets):
    """Viewer.post_personalize (two priors, one epoch, no face loss): one
    step, the source state that of a fresh personalise under the tuned
    weights with its vertices restored, and the views changed."""
    sd = nets[0]
    port = TV.Viewer(TConfig(image_size=S, repeat_num=REPEAT,
                             compute_dtype="float32"),
                     assets=tassets.synthetic_assets(), nets=_port_gen(sd),
                     device="cpu")
    img, theta = _image(15), _theta(np.random.default_rng(16))
    port.personalize(img, theta)
    yaws = [0.0, 90.0]
    before = port.view_sweep(yaws)
    priors = TP.default_prior_poses(port.src_info["theta"], n=2)
    metrics = port.post_personalize(priors, epochs=1)
    assert metrics["n_steps"] == 1 and metrics["fid"] == 0.0
    fresh = TV.Viewer(port.cfg, assets=port.assets, nets=port.nets,
                      device="cpu")
    fresh.personalize(img, theta)
    assert torch.equal(port.src_info["verts"], fresh.src_info["verts"])
    after = port.view_sweep(yaws)
    assert torch.equal(after, fresh.view_sweep(yaws))
    assert float((after - before).abs().max()) > 1e-4
