"""The trainer's loss functions against the JAX package on the CPU, on
fixed inputs: JAX's body_recovery_flow products of two synthetic pairs
feed both packages' g_loss_fn / d_loss_fn (64², conv_dim 8, 2 residual
blocks, a 2-layer PatchGAN, the JAX trainer's VGG19 and Sphere20a
weights), so that only the loss arithmetic is compared. Each term, and
the G and D gradients, are held at the tolerances stated in each test.
"""

import jax
import numpy as np
import pytest
import torch

from impersonator_tpu.tasks import trainer as JT
from impersonator_tpu_torch.tasks import trainer as TT

from train_ref import (Pair, batch, disc_weights, gen_weights, l2_gaps,
                       port_inputs)
from torch_threads import one_torch_thread  # noqa: F401

# every G term on: VGG at full resolution, style at 224², face, BCE mask
# and its TV smoothing
ALL_TERMS = dict(use_vgg=True, use_style=True, lambda_style=2.0,
                 use_face=True, mask_bce=True, lambda_mask_smooth=1.0)
# the MSE mask, the doubled background batch, no smoothing term
MSE_BG_BOTH = dict(use_vgg=False, use_face=False, mask_bce=False,
                   bg_both=True, lambda_mask_smooth=0.0)
# the face term alone
FACE_ONLY = dict(use_vgg=False, use_face=True, lambda_D_prob=0.0,
                 lambda_rec=0.0, lambda_mask=0.0, lambda_mask_smooth=0.0)


def _run(pair, cfg_kw, grads: bool):
    """Both packages' G (and D) losses, and with ``grads`` their
    gradients, on JAX's body_recovery_flow products of batch items 0, 1."""
    jtr, ttr = pair.trainers(**cfg_kw)
    jstate, tstate = pair.states(jtr, ttr)
    jb, tb = batch()
    jin = jax.jit(lambda b: JT.body_recovery_flow(
        jtr.renderer, jtr.smpl_params, jtr.assets.parents,
        b["images"][:, 0], b["images"][:, 1], b["smpls"][:, 0],
        b["smpls"][:, 1], bg_both=jtr.cfg.bg_both))(jb)
    real_src, real_tsf = jb["images"][:, 0], jb["images"][:, 1]
    g_fn, d_fn = JT.make_loss_fns(jtr)
    out = {}
    if grads:
        (_, (m_j, fake_j)), gg_j = jax.jit(jax.value_and_grad(
            g_fn, has_aux=True))(jstate.g_params, jstate.d_params, jin,
                                 real_src, real_tsf)
        (_, dm_j), dg_j = jax.jit(jax.value_and_grad(d_fn, has_aux=True))(
            jstate.d_params, fake_j, real_tsf, jin["input_G_tsf"][..., 3:])
        m_j.update(dm_j)
        out["g_grads_j"], out["d_grads_j"] = gen_weights(gg_j), \
            disc_weights(dg_j)
    else:
        _, (m_j, fake_j) = jax.jit(g_fn)(jstate.g_params, jstate.d_params,
                                         jin, real_src, real_tsf)
    tin = port_inputs(jin)
    g_fn_t, d_fn_t = TT.make_loss_fns(ttr)
    gen, disc = tstate.generator, tstate.discriminator
    with torch.set_grad_enabled(grads):
        total, (m_t, fake_t) = g_fn_t(gen, disc, tin, tb["images"][:, 0],
                                      tb["images"][:, 1])
        if grads:
            names = [n for n, _ in gen.named_parameters()]
            out["g_grads_t"] = dict(zip(names, torch.autograd.grad(
                total, list(gen.parameters()))))
            d_loss, dm_t = d_fn_t(disc, fake_t, tb["images"][:, 1],
                                  tin["input_G_tsf"][:, 3:])
            names = [n for n, _ in disc.named_parameters()]
            out["d_grads_t"] = dict(zip(names, torch.autograd.grad(
                d_loss, list(disc.parameters()))))
            m_t.update(dm_t)
            assert all(p.grad is None for p in disc.parameters())
    out["m_j"] = {k: float(v) for k, v in m_j.items()}
    out["m_t"] = {k: float(v) for k, v in m_t.items()}
    out["fake"] = (fake_t.detach().permute(0, 2, 3, 1).numpy(),
                   np.asarray(fake_j))
    return out


@pytest.fixture(scope="module")
def runs():
    pair = Pair()
    return {"all": _run(pair, ALL_TERMS, grads=True),
            "mse": _run(pair, MSE_BG_BOTH, grads=False),
            "face": _run(pair, FACE_ONLY, grads=True)}


@pytest.mark.parametrize("cfg", ["all", "mse", "face"])
def test_loss_terms_match_jax(runs, cfg):
    """Every G and D term on fixed inputs within 1e-5 relative of JAX's
    (float32 sums in another order; the VGG and face features carry
    ~1e-6 of their own), a term that is off both 0, and the fake target
    within 1e-4 of its largest magnitude (the generator's bound,
    tests/test_torch_train_parts.py; measured 3.7e-5)."""
    r = runs[cfg]
    assert set(r["m_t"]) == set(r["m_j"])
    for k, ref in r["m_j"].items():
        got = r["m_t"][k]
        assert np.isfinite(got), k
        assert abs(got - ref) <= 1e-5 * max(abs(ref), 1e-12), (k, got, ref)
    on = {"all": ["g_adv", "g_rec", "g_tsf", "g_style", "g_face", "g_mask",
                  "g_mask_smooth", "d_loss"],
          "mse": ["g_adv", "g_rec", "g_mask"], "face": ["g_face"]}[cfg]
    for k in on:
        assert r["m_t"][k] != 0.0, k
    if cfg == "face":
        assert r["m_t"]["g_total"] == pytest.approx(r["m_t"]["g_face"])
    fake_t, fake_j = r["fake"]
    assert fake_t.shape == fake_j.shape
    assert np.abs(fake_t - fake_j).max() <= 1e-4 * np.abs(fake_j).max()


@pytest.mark.parametrize("cfg", ["all", "face"])
def test_generator_gradient_matches_jax(runs, cfg):
    """G's gradient (the port's autograd against jax.value_and_grad of
    the same loss) per tensor and over all tensors, each |g_port -
    g_jax| / |g_jax| in the L2 norm: within 1e-2 and 5e-3 (measured
    1.8e-3 and 6.3e-4 with every term on, 1.6e-3 and 6.4e-4 for the face
    term alone). The face term alone sends G a non-zero gradient: unlike
    post-tune's, its first images are the fakes."""
    r = runs[cfg]
    g_t, g_j = r["g_grads_t"], r["g_grads_j"]
    assert set(g_t) == set(g_j)
    per, total = l2_gaps(g_t, g_j)
    assert per <= 1e-2, per
    assert total <= 5e-3, total
    norm = float(torch.cat([v.flatten() for v in g_t.values()]).norm())
    assert norm > 0
    if cfg == "face":
        # the face term reaches both streams that draw fake_tsf
        for part in ("tsf_model", "bg_model"):
            assert any(float(v.abs().max()) > 0 for k, v in g_t.items()
                       if k.startswith(part)), part


def test_discriminator_gradient_matches_jax(runs):
    """D's LSGAN gradient on the same step's fake (detached), in the L2
    norm: within 1e-3 over all tensors and per tensor (measured 9.1e-5
    over all). The biases of the convs before an instance norm get a
    gradient that is 0 in exact arithmetic (the norm subtracts their
    mean), so both packages' are rounding noise: those stay below 1e-5 of
    the whole gradient's norm in both and are left out of the per-tensor
    bound. G's backward left no gradient on D's parameters (_run)."""
    g_t, g_j = runs["all"]["d_grads_t"], runs["all"]["d_grads_j"]
    norm = float(torch.cat([v.flatten() for v in g_j.values()]).norm())
    noise = [k for k, v in g_j.items() if float(v.norm()) <= 1e-5 * norm]
    assert sorted(noise) == ["model.2.bias", "model.5.bias"]
    for k in noise:
        assert float(g_t[k].norm()) <= 1e-5 * norm, k
    per, _ = l2_gaps({k: g_t[k] for k in g_j if k not in noise},
                     {k: g_j[k] for k in g_j if k not in noise})
    _, total = l2_gaps(g_t, g_j)
    assert per <= 1e-3, per
    assert total <= 1e-3, total
