"""Port parity of the image-driven imitation leg: HMR (through the weight
bridge, with non-trivial BatchNorm statistics), the host resize, and
Imitator.personalize(src_img) + Imitator.inference against the JAX
package's, on the same numpy inputs and weights, float32 on the CPU.

Tolerances. HMR's random-weight features grow to ~10^3 through 16 blocks,
so θ is compared relative to its own scale (1e-4 of max |θ|: float32 sums
in another order over 50 convs). The resize differs from cv2's in the
last bits of its source coordinates (computed in float32 in another
order), which moves a bilinear sample by up to ~2e-5 per unit of
neighbour difference: 2e-4 on [-1, 1] images. Imitation preds are held
at 1e-2 as in tests/test_torch_slice.py, except where the two sides'
face-index maps differ: HMR's ~1e-7 θ gap moves vertices by ulps, which
can flip a pixel centre lying on a shared edge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impersonator_tpu import config
from impersonator_tpu.models.generator import ImpersonatorGenerator as JGen
from impersonator_tpu.models.hmr import HumanModelRecovery as JHMR
from impersonator_tpu.tasks import imitator as JI
from impersonator_tpu.utils.cv_utils import resize_img_hwc as jresize
from impersonator_tpu_torch.config import TestConfig as TConfig
from impersonator_tpu_torch.models.generator import \
    ImpersonatorGenerator as TGen
from impersonator_tpu_torch.models.hmr import HumanModelRecovery as THMR
from impersonator_tpu_torch.tasks import imitator as TI
from impersonator_tpu_torch.utils.convert import hmr_state_dict_from_jax
from impersonator_tpu_torch.utils.cv_utils import resize_img_hwc as tresize
from tools import convert_weights as cw

import torch_ref

S, CONV_DIM, REPEAT = 64, 8, 2


@pytest.fixture(scope="module")
def jax_hmr():
    """The JAX HMR with flax-initialised params and perturbed BatchNorm
    statistics and affine parameters (numpy, seeded)."""
    net = JHMR()
    tree = jax.jit(net.init)(jax.random.PRNGKey(5),
                             jnp.zeros((1, 224, 224, 3)))
    tree = jax.tree_util.tree_map(np.asarray, tree)
    rng = np.random.default_rng(3)

    def perturb(node, key):
        if isinstance(node, dict):
            return {k: perturb(v, k) for k, v in node.items()}
        if key == "mean":
            return rng.normal(0, 0.1, node.shape).astype(np.float32)
        if key == "var":
            return rng.uniform(0.5, 2.0, node.shape).astype(np.float32)
        if key in ("scale", "bias") and node.ndim == 1:
            return (node + rng.normal(0, 0.1, node.shape)).astype(np.float32)
        return node

    tree = {"params": perturb(tree["params"], None),
            "batch_stats": perturb(tree["batch_stats"], None)}
    mt = np.zeros(85, np.float32)
    mt[0] = 0.9
    tree["params"]["regressor"]["mean_theta"] = mt
    return net, tree


def test_hmr_matches_jax(jax_hmr):
    net, tree = jax_hmr
    port = THMR().eval()
    sd = hmr_state_dict_from_jax(tree)
    port.load_state_dict(sd, strict=True)
    # the bridge is convert_hmr's exact inverse, running stats included
    back = cw.convert_hmr(port.state_dict())
    for coll in ("params", "batch_stats"):
        flat_a = jax.tree_util.tree_leaves_with_path(back[coll])
        flat_b = dict(jax.tree_util.tree_leaves_with_path(tree[coll]))
        assert len(flat_a) == len(flat_b)
        for path, leaf in flat_a:
            np.testing.assert_array_equal(leaf, flat_b[path])

    img = np.random.default_rng(0).uniform(-1, 1, (2, 224, 224, 3)) \
        .astype(np.float32)
    theta_j = np.asarray(jax.jit(net.apply)(tree, jnp.asarray(img)))
    with torch.no_grad():
        theta_t = port(torch.from_numpy(img)).numpy()
    assert theta_t.shape == (2, 85)
    scale = np.abs(theta_j).max()
    np.testing.assert_allclose(theta_t, theta_j, atol=1e-4 * scale)
    assert np.abs(theta_j[0] - theta_j[1]).max() > 1e-3 * scale


@pytest.mark.parametrize("tf32", [True, False])
def test_hmr_scopes_full_fp32(assets, tf32):
    """HMR's convs and matmuls run with both TF32 flags off whatever the
    process set, and building and running an Imitator leaves the
    process's flags as they were."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    seen = []
    try:
        for f in flags:
            f.allow_tf32 = tf32
        imit = TI.Imitator(TConfig(image_size=S, repeat_num=REPEAT),
                           assets=assets, device="cpu")
        hmr = imit.nets.hmr
        for m in (hmr.resnet.conv1, hmr.regressor.fc_blocks.fc1):
            m.register_forward_hook(lambda *_: seen.append(
                [f.allow_tf32 for f in flags]))
        imit.regress_smpl(np.zeros((1, 224, 224, 3), np.float32))
        assert seen == [[False, False]] * 4       # fc1 runs 3 IEF steps
        assert [f.allow_tf32 for f in flags] == [tf32, tf32]
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


@pytest.mark.parametrize("case", ["pm1_256", "u8_300x200", "f01_224",
                                  "f01_100x150"])
def test_resize_matches_cv2(case):
    rng = np.random.default_rng(len(case))
    img = {"pm1_256": lambda: rng.uniform(-1, 1, (256, 256, 3)),
           "u8_300x200": lambda: rng.integers(0, 256, (300, 200, 3))
           .astype(np.uint8),
           "f01_224": lambda: rng.uniform(0, 1, (224, 224, 3)),
           "f01_100x150": lambda: rng.uniform(0, 1, (100, 150, 3))}[case]()
    if img.dtype == np.float64:
        img = img.astype(np.float32)
    want, got = jresize(img, 224), tresize(img, 224)
    assert got.dtype == np.float32 and got.shape == (224, 224, 3)
    np.testing.assert_allclose(got, want, atol=2e-4)
    if case == "pm1_256":                     # [-1, 1] in -> [-3, 1] out
        assert got.min() < -2.5 and got.max() <= 1.0


def _nets(assets):
    """Port nets (generator from reference-layout random weights, HMR
    from build_nets' seeded init with its fc3 scaling) and the same
    weights as JAX ImitatorNets."""
    rng = np.random.default_rng(21)
    sd = {**torch_ref.make_bg_sd(rng, 4, CONV_DIM, REPEAT),
          **torch_ref.make_resunet_sd(rng, "src_model", 6, CONV_DIM, REPEAT),
          **torch_ref.make_resunet_sd(rng, "tsf_model", 6, CONV_DIM, REPEAT)}
    tgen = TGen(conv_dim=CONV_DIM, repeat_num=REPEAT)
    tgen.load_state_dict(sd, strict=True)
    thmr = TI.build_nets(TConfig(repeat_num=REPEAT), assets).hmr
    jnets = JI.ImitatorNets(
        JGen(bg_dim=4, src_dim=6, tsf_dim=6, conv_dim=CONV_DIM,
             repeat_num=REPEAT),
        cw.convert_generator(sd, repeat=REPEAT), JHMR(),
        cw.convert_hmr(thmr.state_dict()))
    return TI.ImitatorNets(tgen, thmr), jnets


def test_inference_matches_jax(assets):
    tnets, jnets = _nets(assets)
    rng = np.random.default_rng(8)
    y, x = np.mgrid[0:S, 0:S].astype(np.float32) / S
    src_img = np.stack([np.sin(6 * x + y), np.cos(4 * y - x),
                        np.sin(5 * x * y)], -1).astype(np.float32) * 0.8
    tgt = rng.uniform(-1, 1, (3, 224, 224, 3)).astype(np.float32)

    tcfg = TConfig(image_size=S, repeat_num=REPEAT, compute_dtype="float32")
    imit_t = TI.Imitator(tcfg, assets=assets, nets=tnets, device="cpu")
    src_t = imit_t.personalize(src_img)
    preds_t = imit_t.inference(tgt, batch=2).numpy()

    jcfg = config.TestConfig(image_size=S, repeat_num=REPEAT,
                             compute_dtype="float32")
    imit_j = JI.Imitator(jcfg, assets=assets, nets=jnets)
    src_j = imit_j.personalize(src_img)
    preds_j = np.asarray(imit_j.inference(tgt, batch=2))

    # HMR saw the renormalised [-3, 1] source, on both sides
    img224 = tresize(src_img, 224)
    assert img224.min() < -2.0
    theta_src = imit_t.regress_smpl(img224[None]).numpy()
    np.testing.assert_array_equal(src_t["theta"].numpy(), theta_src)
    np.testing.assert_allclose(src_t["theta"].numpy(),
                               np.asarray(src_j["theta"]), atol=1e-5)
    assert np.abs(theta_src - tnets.hmr.regressor.mean_theta.numpy()) \
        .max() < 0.2                              # θ stays near mean_theta
    np.testing.assert_allclose(imit_t.first_cam.numpy(),
                               np.asarray(imit_j.first_cam), atol=1e-5)

    fim_t, fim_j = src_t["fim"].numpy(), np.asarray(src_j["fim"])
    assert (fim_t >= 0).mean() > 0.02
    assert (fim_t != fim_j).sum() <= 4
    assert preds_t.shape == (3, S, S, 3)
    assert np.isfinite(preds_t).all()
    far = (np.abs(preds_t - preds_j) > 1e-2).any(-1)
    assert far.sum() <= 0.01 * far.size, far.sum()
