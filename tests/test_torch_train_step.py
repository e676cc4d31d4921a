"""The port's train step against the JAX package's on the CPU: three G+D
steps from the same weights and fresh Adam states (64², batch 2,
conv_dim 8, 2 residual blocks, a 2-layer PatchGAN, VGG and face losses
on, float32), each package running its own body_recovery_flow on the
same synthetic batches; then the G-only step, the eval-only step and
the visuals.

Each package rasterises for itself (the port's plain twins, JAX's brute
path: fim equal, T within 1e-3), so the fakes, and so the losses and
gradients, differ by that gap warped through per-pixel noise images, on
top of the float32 rounding that tests/test_torch_train_losses.py holds
on fixed inputs. The bounds below are stated at each test."""

import jax
import numpy as np
import pytest
import torch

from impersonator_tpu.tasks import trainer as JT
from impersonator_tpu_torch.tasks import trainer as TT

from train_ref import Pair, batch, disc_weights, gen_weights
from torch_threads import one_torch_thread  # noqa: F401

LR = 2e-4
STEPS = 3


def _weights(state):
    return {**{"G." + k: v.detach().clone()
               for k, v in state.generator.state_dict().items()},
            **{"D." + k: v.detach().clone()
               for k, v in state.discriminator.state_dict().items()}}


def _jax_weights(state):
    return {**{"G." + k: v for k, v in gen_weights(state.g_params).items()},
            **{"D." + k: v for k, v in disc_weights(state.d_params).items()}}


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.fixture(scope="module")
def trajectory(pair):
    """Both packages' weights before and after each of STEPS steps, and
    each step's metrics, on batches of items (0, 1), (2, 3), (4, 5)."""
    jtr, ttr = pair.trainers()
    jstate, tstate = pair.states(jtr, ttr)
    jstep = jax.jit(JT.make_train_step(jtr, train_d=True))
    tstep = TT.make_train_step(ttr, train_d=True)
    w = [(_weights(tstate), _jax_weights(jstate))]
    m = []
    for i in range(STEPS):
        jb, tb = batch((2 * i, 2 * i + 1))
        jstate, mj = jstep(jstate, jb)
        tstate, mt = tstep(tstate, tb)
        m.append(({k: float(v) for k, v in mt.items()},
                  {k: float(v) for k, v in mj.items()}))
        w.append((_weights(tstate), _jax_weights(jstate)))
    assert tstate.step == int(jstate.step) == STEPS
    return w, m


def test_train_step_matches_jax(trajectory):
    """Step 1: every metric within 1e-4 relative (measured ≤ 9.1e-6), and
    the first Adam step (±lr on a weight whose gradient is well above
    eps) the same, within lr/2, on all but 1e-2 of the weights that moved
    (measured 1.2e-3: the sign of a near-zero gradient component can flip
    with the raster gap); every G and D tensor moved."""
    w, m = trajectory
    (w0, _), (w1_t, w1_j) = w[0], w[1]
    mt, mj = m[0]
    assert set(mt) == set(mj)
    for k, ref in mj.items():
        assert np.isfinite(mt[k]), k
        assert abs(mt[k] - ref) <= 1e-4 * max(abs(ref), 1e-3), (k, mt[k], ref)
    moved = differ = 0
    for k, v0 in w0.items():
        if not v0.is_floating_point() or "running_" in k:
            continue
        assert not torch.equal(w1_t[k], v0), k
        moved += int((w1_j[k] != v0).sum())
        differ += int(((w1_t[k] - w1_j[k]).abs() > 0.5 * LR).sum())
    assert moved > 0.99 * sum(v.numel() for k, v in w0.items()
                              if "running_" not in k)
    assert differ <= 1e-2 * moved, differ / moved


def test_three_step_trajectory_matches_jax(trajectory):
    """Three steps: each step's G total and D loss within 1e-3 relative
    (measured ≤ 1.1e-4), every weight within 2·steps·1.1·lr of JAX's (a
    step moves a weight by at most ~1.05·lr; measured 9.5e-4), and the
    two packages' updates w3 - w0 at a cosine of at least 0.99 (measured
    0.9988; unrelated updates give ~0)."""
    w, m = trajectory
    for mt, mj in m:
        for k in ("g_total", "d_loss"):
            assert abs(mt[k] - mj[k]) <= 1e-3 * abs(mj[k]), (k, mt[k], mj[k])
    w0, (w3_t, w3_j) = w[0][0], w[-1]
    keys = [k for k in w0 if w0[k].is_floating_point()]
    for k in keys:
        assert float((w3_t[k] - w3_j[k]).abs().max()) <= \
            2 * STEPS * 1.1 * LR, k
    dt = torch.cat([(w3_t[k] - w0[k]).flatten() for k in keys])
    dj = torch.cat([(w3_j[k] - w0[k]).flatten() for k in keys])
    assert float(dt @ dj) >= 0.99 * float(dt.norm() * dj.norm())


def test_g_only_step_leaves_the_discriminator(pair):
    """train_d=False: G moves, D's weights stay bit for bit, and neither
    G's backward nor the step leaves D a gradient or an Adam state (G
    keeps its float32 gradient until the next update); the metrics have
    no D terms."""
    jtr, ttr = pair.trainers()
    _, st = pair.states(jtr, ttr)
    before = _weights(st)
    st, metrics = TT.make_train_step(ttr, train_d=False)(st, batch()[1])
    after = _weights(st)
    assert not any(k.startswith("d_") for k in metrics)
    for k, v in before.items():
        assert torch.equal(after[k], v) == k.startswith("D."), k
    assert all(p.grad is None for p in st.discriminator.parameters())
    assert all(p.grad.dtype == torch.float32
               for p in st.generator.parameters())
    assert not st.d_opt.state and st.step == 1


def test_eval_only_and_visuals_match_jax(pair):
    """The validation step: the same metrics as JAX's eval step within
    1e-4 relative (measured ≤ 4.5e-6), with no parameter or optimiser
    change; the visuals: the same seven images (B, S, S, 3) as JAX's, the
    real ones equal, the background (its masks come from fim, equal)
    within 1e-4 (measured 1.5e-5) and the rest within 5e-3 (T's gap
    through a warp of noise images; measured ≤ 6.2e-4)."""
    jtr, ttr = pair.trainers()
    jstate, tstate = pair.states(jtr, ttr)
    jb, tb = batch((6, 7))
    before = _weights(tstate)
    mj = jax.jit(JT.make_train_step(jtr, eval_only=True))(jstate, jb)
    mt = TT.make_train_step(ttr, eval_only=True)(tstate, tb)
    assert set(mt) == set(mj)
    for k, ref in mj.items():
        ref = float(ref)
        assert abs(float(mt[k]) - ref) <= 1e-4 * max(abs(ref), 1e-3), k
    after = _weights(tstate)
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert not tstate.g_opt.state and tstate.step == 0

    vj = jax.jit(JT.make_visuals_fn(jtr))(jstate, jb)
    vt = TT.make_visuals_fn(ttr)(tstate, tb)
    assert set(vt) == set(vj)
    for k, v in vt.items():
        ref = np.asarray(vj[k])
        assert tuple(v.shape) == ref.shape and v.dtype == torch.float32, k
        tol = {"1_real_img": 0.0, "6_real_tsf": 0.0,
               "5_fake_bg": 1e-4}.get(k, 5e-3)
        np.testing.assert_allclose(v.numpy(), ref, atol=tol, err_msg=k)
