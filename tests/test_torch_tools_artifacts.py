"""The port's post-tune and training-convergence artifact tools against
the repo's JAX ones on the CPU, float32, 64², with the same weights
(a reference-layout generator at conv_dim 8 carried into JAX by
``tools/convert_weights``; the trainers' other nets as
``tests/train_ref.py`` shares them):

* ``posttune_artifact``: the structured source within 1e-6 (one fim,
  the same elementwise maps), the "before" self-imitation SSIM within
  1e-5 (``cli.evaluate``'s ssim bound), the held-out cycle SSIM within
  1e-3 (its warp back goes through T_cycle, which the two rasters give
  within 1e-3), and the first epoch's cycle loss within 5e-3 relative
  (``tests/test_torch_post_tune.py``'s trajectory bound);
* ``trainconv_artifact``: the learnable set's images within 1e-6 and
  the first train step's losses on it within 1e-4 relative
  (``tests/test_torch_train_step.py``'s first-step bound)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from impersonator_tpu import config as jconfig
from impersonator_tpu.metrics.metrics import ssim as jssim
from impersonator_tpu.models import HumanModelRecovery as JHMR
from impersonator_tpu.models.generator import ImpersonatorGenerator as JGen
from impersonator_tpu.tasks import imitator as JI
from impersonator_tpu.tasks import post_tune as JP
from impersonator_tpu.tasks import trainer as JT
from impersonator_tpu_torch.data.loader import stage_batch
from impersonator_tpu_torch.models.generator import \
    ImpersonatorGenerator as TGen
from impersonator_tpu_torch.tasks import imitator as TI
from impersonator_tpu_torch.tasks import post_tune as TP
from impersonator_tpu_torch.tasks import trainer as TT
from tools import convert_weights as cw

from train_ref import CONV_DIM, REPEAT, Pair, gen_sd
from torch_threads import one_torch_thread  # noqa: F401

S = 64


def test_posttune_artifact_first_epoch_matches_jax_tool(assets):
    from impersonator_tpu_torch.tools import posttune_artifact as port
    from tools import posttune_artifact as jax_tool
    sd = gen_sd(91)
    gen = TGen(conv_dim=CONV_DIM, repeat_num=REPEAT)
    gen.load_state_dict(sd, strict=True)
    imit_t, theta = port.build(S, 0, torch.device("cpu"), "float32",
                               nets=TI.ImitatorNets(gen))
    imit_j = JI.Imitator(
        jconfig.TestConfig(image_size=S, repeat_num=REPEAT,
                           compute_dtype="float32"),
        assets=assets, nets=JI.ImitatorNets(
            JGen(bg_dim=4, src_dim=6, tsf_dim=6, conv_dim=CONV_DIM,
                 repeat_num=REPEAT),
            cw.convert_generator(sd, repeat=REPEAT), JHMR(), None, None,
            None))
    src_j = jax_tool.structured_src_img(imit_j, theta, S)
    np.testing.assert_allclose(imit_t.src_info["img"][0].numpy(), src_j,
                               atol=1e-6)
    imit_j.personalize(src_j, src_smpl=theta)

    held_j = JP.default_prior_poses(imit_j.src_info["theta"], n=1,
                                    scale=0.12, seed=1000)
    held_t = TP.default_prior_poses(imit_t.src_info["theta"], n=1,
                                    scale=0.12, seed=1000)
    before_j = {**jax_tool._self_metrics(imit_j, jssim, None),
                **jax_tool._heldout_metrics(imit_j, held_j, jssim, None)}
    before_t = {**port.self_metrics(imit_t, None),
                **port.heldout_metrics(imit_t, held_t, None)}
    assert list(before_t) == list(before_j)
    assert abs(before_t["self_ssim"] - before_j["self_ssim"]) <= 1e-5
    assert abs(before_t["heldout_cycle_ssim"]
               - before_j["heldout_cycle_ssim"]) <= 1e-3

    pri_j = JP.default_prior_poses(imit_j.src_info["theta"], n=2,
                                   scale=0.12, seed=0)
    pri_t = TP.default_prior_poses(imit_t.src_info["theta"], n=2,
                                   scale=0.12, seed=0)
    np.testing.assert_allclose(pri_t.numpy(), np.asarray(pri_j), atol=1e-6)
    m_j = JP.adaptive_personalize(imit_j, pri_j, epochs=1, use_face=False,
                                  batch_size=2, seed=0)
    m_t = TP.adaptive_personalize(imit_t, pri_t, epochs=1, use_face=False,
                                  batch_size=2, seed=0)
    assert m_t["n_steps"] == int(m_j["n_steps"]) == 1
    np.testing.assert_allclose(m_t["cyc_history"],
                               [float(c) for c in m_j["cyc_history"]],
                               rtol=5e-3)


def test_trainconv_artifact_first_step_matches_jax_tool():
    from impersonator_tpu_torch.tools import trainconv_artifact as port
    from tools import trainconv_artifact as jax_tool
    pair = Pair()
    jtr, ttr = pair.trainers(use_face=False, use_style=False,
                             use_vgg=True, train_dtype="float32")
    data_j = jax_tool.make_learnable_batchset(jtr, 2, seed=0)
    data_t = port.make_learnable_batchset(ttr, 2, seed=0)
    np.testing.assert_array_equal(data_t["smpls"], data_j["smpls"])
    np.testing.assert_allclose(data_t["images"], data_j["images"],
                               atol=1e-6)
    assert float(np.abs(data_t["images"]).max()) > 0.5

    jstate, tstate = pair.states(jtr, ttr)
    _, mj = jax.jit(JT.make_train_step(jtr, train_d=True))(
        jstate, {k: jnp.asarray(v) for k, v in data_j.items()})
    _, mt = TT.make_train_step(ttr, train_d=True)(
        tstate, stage_batch(data_t, "cpu"))
    for k in port.KEYS:
        ref = float(mj[k])
        assert np.isfinite(float(mt[k])), k
        assert abs(float(mt[k]) - ref) <= 1e-4 * max(abs(ref), 1e-3), \
            (k, float(mt[k]), ref)
