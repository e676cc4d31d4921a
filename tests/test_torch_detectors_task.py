"""``has_detector`` in the port against the JAX package
(tests/test_tasks.py:316-360): the loud fallback where Mask R-CNN cannot
be built, ``detector is None``, a detector's body mask taking the place
of the eroded silhouette for the background, the kept mask and
post-tune's refresh with it, for the Imitator and the Swapper; the
silhouette detector itself. Both packages at 64², conv_dim 8, 2
residual blocks, float32, on the same weights; backgrounds within the
1e-3 the port's external-mask test holds (tests/test_torch_swap_view.py).
"""

import numpy as np
import pytest
import torch

from impersonator_tpu import config as jconfig
from impersonator_tpu.models import HumanModelRecovery as JHMR
from impersonator_tpu.models.generator import ImpersonatorGenerator as JGen
from impersonator_tpu.tasks import imitator as JI
from impersonator_tpu.tasks import swapper as JS
from impersonator_tpu.utils import detectors as jdet
from impersonator_tpu_torch import assets as tassets
from impersonator_tpu_torch.config import TestConfig as TCfg
from impersonator_tpu_torch.models.generator import \
    ImpersonatorGenerator as TGen
from impersonator_tpu_torch.tasks import imitator as TI
from impersonator_tpu_torch.tasks import swapper as TS
from impersonator_tpu_torch.tasks import viewer as TV
from impersonator_tpu_torch.tasks.post_tune import adaptive_personalize
from impersonator_tpu_torch.utils import detectors as tdet
from tools import convert_weights as cw

import torch_ref
from torch_threads import one_torch_thread  # noqa: F401

S, CONV_DIM, REPEAT = 64, 8, 2
BG_TOL = 1e-3


@pytest.fixture(scope="module")
def gen_sd():
    rng = np.random.default_rng(41)
    return {**torch_ref.make_bg_sd(rng, 4, CONV_DIM, REPEAT),
            **torch_ref.make_resunet_sd(rng, "src_model", 6, CONV_DIM,
                                        REPEAT),
            **torch_ref.make_resunet_sd(rng, "tsf_model", 6, CONV_DIM,
                                        REPEAT)}


def _port(cls, sd, **kw):
    gen = TGen(conv_dim=CONV_DIM, repeat_num=REPEAT)
    gen.load_state_dict(sd, strict=True)
    cfg = TCfg(image_size=S, repeat_num=REPEAT, compute_dtype="float32",
               **kw)
    return cls(cfg, assets=tassets.synthetic_assets(),
               nets=TI.ImitatorNets(gen, None, None), device="cpu")


def _jax(cls, sd, assets, **kw):
    gen = JGen(bg_dim=4, src_dim=6, tsf_dim=6, conv_dim=CONV_DIM,
               repeat_num=REPEAT)
    cfg = jconfig.TestConfig(image_size=S, repeat_num=REPEAT,
                             compute_dtype="float32", **kw)
    nets = JI.ImitatorNets(gen, cw.convert_generator(sd, repeat=REPEAT),
                           JHMR(), None, None, None)
    return cls(cfg, assets=assets, nets=nets)


class FakeDetector:
    """A body mask over a fixed box; records each image it is given."""

    def __init__(self):
        self.calls = []

    def inference(self, img_hwc):
        self.calls.append((type(img_hwc), img_hwc.shape))
        m = np.zeros((1, S, S, 1), np.float32)
        m[:, 16:48, 16:48] = 1.0
        return np.array([16, 48, 16, 48]), m


def _inputs():
    rng = np.random.default_rng(2)
    src = rng.uniform(-1, 1, (S, S, 3)).astype(np.float32)
    theta = np.zeros((85,), np.float32)
    theta[0] = 0.9
    theta[3:75] = rng.normal(0, 0.05, 72)
    return src, theta


def _bg(state):
    return np.asarray(state["bg"])


def test_build_detector_falls_back_loudly_as_jax(capsys):
    """has_detector asks for Mask R-CNN, which neither package can build
    here: both print the fallback and give the silhouette detector;
    without it, the silhouette detector quietly."""
    for mod in (tdet, jdet):
        det = mod.build_detector(True, 9)
        out = capsys.readouterr().out
        assert isinstance(det, mod.SilhouetteDetector) and det.ks == 9
        assert "falling back" in out, mod
        assert isinstance(mod.build_detector(False), mod.SilhouetteDetector)
        assert capsys.readouterr().out == ""
    with pytest.raises(RuntimeError, match="pretrained"):
        tdet.MaskRCNNDetector()


@pytest.mark.parametrize("body", [True, False])
def test_silhouette_detector_matches_jax(body):
    """The eroded background channel of a conditioning map, inverted, and
    the bbox of its pixels (the whole frame when there are none)."""
    rng = np.random.default_rng(5)
    cond = rng.uniform(0, 1, (1, S, S, 3)).astype(np.float32)
    cond[..., -1] = 1.0
    if body:
        cond[0, 10:40, 22:50, -1] = 0.0
    bt, mt = tdet.SilhouetteDetector(5).inference_from_cond(
        torch.from_numpy(cond))
    bj, mj = jdet.SilhouetteDetector(5).inference_from_cond(cond)
    np.testing.assert_array_equal(bt, np.asarray(bj))
    assert bt.dtype == np.int32 and mt.shape == (1, S, S, 1)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert (mt.numpy().sum() > 0) == body


def test_imitator_detector_mask_matches_jax(gen_sd, assets, capsys):
    """The Imitator: loud fallback and detector None in both packages;
    personalise without, then with a detector: its body mask moves bg
    (> 1e-6) equally in both packages, is kept as _src_body_mask, and
    post-tune's refresh personalises with it again (a zero learning
    rate, so the refreshed bg equals the detected one)."""
    port = _port(TI.Imitator, gen_sd, has_detector=True)
    out_t = capsys.readouterr().out
    ref = _jax(JI.Imitator, gen_sd, assets, has_detector=True)
    out_j = capsys.readouterr().out
    assert port.detector is None and ref.detector is None
    assert "falling back" in out_t and "falling back" in out_j

    src, theta = _inputs()
    base_t = port.personalize(src, src_smpl=theta)
    base_j = ref.personalize(src, src_smpl=theta)
    assert port._src_body_mask is None
    np.testing.assert_allclose(_bg(base_t), _bg(base_j), atol=BG_TOL)

    port.detector, ref.detector = FakeDetector(), FakeDetector()
    det_t = port.personalize(src, src_smpl=theta)
    det_j = ref.personalize(src, src_smpl=theta)
    assert port.detector.calls == [(np.ndarray, (S, S, 3))]
    assert port.detector.calls == ref.detector.calls
    assert np.abs(_bg(det_t) - _bg(base_t)).max() > 1e-6
    np.testing.assert_allclose(_bg(det_t), _bg(det_j), atol=BG_TOL)
    np.testing.assert_array_equal(port._src_body_mask.numpy(),
                                  np.asarray(ref._src_body_mask))

    port.detector = None          # the refresh must not ask it again
    adaptive_personalize(port, prior_smpls=theta[None], epochs=1, lr=0.0,
                         batch_size=1)
    np.testing.assert_array_equal(_bg(port.src_info), _bg(det_t))
    refreshed_j = ref._personalize_jit(det_j["img"], det_j["theta"],
                                       ext_body_mask=ref._src_body_mask)
    np.testing.assert_allclose(_bg(port.src_info), _bg(refreshed_j),
                               atol=BG_TOL)


def test_swapper_detector_mask_matches_jax(gen_sd, assets, capsys):
    """The Swapper: fallback, then a detector's mask for both images of
    swap_setup, as JAX's; the Viewer keeps no detector's mask."""
    port = _port(TS.Swapper, gen_sd, has_detector=True)
    ref = _jax(JS.Swapper, gen_sd, assets, has_detector=True)
    assert "falling back" in capsys.readouterr().out
    assert port.detector is None and ref.detector is None
    src, theta = _inputs()
    tgt = np.ascontiguousarray(-src[::-1])
    port.swap_setup(src, tgt, theta, theta)
    base = _bg(port.src_info)
    port.detector, ref.detector = FakeDetector(), FakeDetector()
    port.swap_setup(src, tgt, theta, theta)
    ref.swap_setup(src, tgt, theta, theta)
    assert len(port.detector.calls) == len(ref.detector.calls) == 2
    assert np.abs(_bg(port.src_info) - base).max() > 1e-6
    for a, b in ((port.src_info, ref.src_info),
                 (port.tsf_info, ref.tsf_info)):
        np.testing.assert_allclose(_bg(a), _bg(b), atol=BG_TOL)
    assert port._src_body_mask is None

    viewer = _port(TV.Viewer, gen_sd, has_detector=True)
    viewer.detector = FakeDetector()
    viewer.personalize(src, theta)
    assert viewer.detector.calls == [] and viewer._src_body_mask is None
