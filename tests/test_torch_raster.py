"""Port parity of the bucket z-buffer kernels' plain twins
(impersonator_tpu_torch.ops.cuda_raster, reached through
rasterizer.rasterize_{fim_wim,flow}_bucket on CPU tensors) against the
JAX Pallas kernels run in interpret mode, as the JAX tests run them.

fim must match exactly and background values exactly. Weights and flow
are compared at 1e-3: XLA's CPU backend always contracts the kernel's
multiply-adds into FMAs (it has no switch to stop it), and the
cancellation in the barycentric rows (p1x*p2y - p2x*p1y at pixel-index
magnitudes, times 1/denom) turns that last-ulp difference into up to
7e-4 on a 256² body (measured). The port is instead held bit for bit to
the Pallas body's written float32 arithmetic by a numpy transliteration
(numpy rounds every product), which is what the CUDA kernel, built with
--fmad=false, computes too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impersonator_tpu.ops import rasterizer as jrast
from impersonator_tpu.ops import smpl as jsmpl
from impersonator_tpu_torch.ops import flow as tflow
from impersonator_tpu_torch.ops import rasterizer as trast

from test_rasterizer import _random_faces
from torch_threads import one_torch_thread  # noqa: F401

NEAR, FAR = jrast.DEFAULT_NEAR, jrast.DEFAULT_FAR
XLA_FMA_TOL = 1e-3


def _body(assets, n=2, seed=0):
    """n posed synthetic bodies in raster space, (n, nf, 3, 3)."""
    rng = np.random.default_rng(seed)
    theta = np.zeros((n, 85), np.float32)
    theta[:, 0] = 0.9
    theta[1:, 3:75] = rng.normal(0, 0.05, (n - 1, 72))
    p = jsmpl.SMPLParams.from_assets(assets)
    d = jsmpl.get_details(p, jnp.asarray(theta), assets.parents)
    return np.array(jrast.project_to_raster_space(d["verts"], d["cam"],
                                                  p.faces))


def _random_oversized():
    """Random scatter + one oversized front face (as
    test_rasterizer.test_bucket_matches_brute_random_and_oversized)."""
    rng = np.random.default_rng(33)
    nf = 300
    centers = rng.uniform(-0.9, 0.9, (1, nf, 1, 2))
    offsets = rng.uniform(-0.2, 0.2, (1, nf, 3, 2))
    z = rng.uniform(1.5, 3.0, (1, nf, 3, 1))
    fv = np.concatenate([centers + offsets, z], axis=-1).astype(np.float32)
    fv[0, 0, :, :2] = [[-0.95, -0.95], [0.95, -0.9], [0.0, 0.95]]
    fv[0, 0, :, 2] = 1.2
    return fv


def _fuzz(seed):
    """Hostile scene of test_rasterizer.test_bucket_matches_brute_fuzz:
    back faces, collinear degenerates, near-plane violators, a dense
    overlap cluster, two batch entries."""
    rng = np.random.default_rng(seed)
    nf = 240
    fv = _random_faces(rng, 2, nf)
    flip = rng.random((2, nf)) < 0.5
    fv[flip] = fv[flip][:, ::-1]
    for bi in range(2):
        for fn_ in rng.choice(nf, 5, replace=False):
            a, b2 = fv[bi, fn_, 0, :2], fv[bi, fn_, 1, :2]
            fv[bi, fn_, 2, :2] = a + 2.0 * (b2 - a)
    fv[:, -8:, :, 2] = 0.05
    fv[:, 100:140, :, :2] = (rng.uniform(-0.1, 0.1, (2, 40, 3, 2))
                             .astype(np.float32))
    return fv


def _src(nf, seed=5):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (1, nf, 3, 2)).astype(np.float32)


def _compare(fv, s, tile, span, txb):
    src = _src(fv.shape[1])
    fim_j, wim_j = jrast.rasterize_fim_wim_bucket(
        jnp.asarray(fv), s, tile=tile, span=span, txb=txb, interpret=True)
    fimf_j, t_j = jrast.rasterize_flow_bucket(
        jnp.asarray(fv), jnp.asarray(src), s, tile=tile, span=span, txb=txb,
        interpret=True)
    fim_t, wim_t = trast.rasterize_fim_wim_bucket(torch.from_numpy(fv), s,
                                                  tile=tile, span=span)
    fimf_t, t_t = trast.rasterize_flow_bucket(
        torch.from_numpy(fv), torch.from_numpy(src), s, tile=tile, span=span)
    fim_j, wim_j, fimf_j, t_j = map(np.asarray, (fim_j, wim_j, fimf_j, t_j))
    fim_t, wim_t, fimf_t, t_t = (x.numpy() for x in
                                 (fim_t, wim_t, fimf_t, t_t))
    assert fim_t.dtype == np.int32 and fim_t.shape == fim_j.shape
    np.testing.assert_array_equal(fim_t, fim_j)
    np.testing.assert_array_equal(fimf_t, fimf_j)
    np.testing.assert_array_equal(fimf_t, fim_t)
    bg = fim_t < 0
    assert (wim_t[bg] == 0.0).all() and (t_t[bg] == -2.0).all()
    np.testing.assert_allclose(wim_t, wim_j, atol=XLA_FMA_TOL)
    np.testing.assert_allclose(t_t, t_j, atol=XLA_FMA_TOL)
    # fused flow == raster + correspondence_flow within blend-order ulps
    t_two = tflow.correspondence_flow(torch.from_numpy(src),
                                      torch.from_numpy(fim_t),
                                      torch.from_numpy(wim_t)).numpy()
    np.testing.assert_allclose(t_t, t_two, atol=1e-5)
    return fim_t


@pytest.mark.parametrize("s,tile,span,txb", [(64, 8, 4, 4), (256, 16, 2, 1)])
def test_bucket_kernels_match_jax_body(assets, s, tile, span, txb):
    fim = _compare(_body(assets), s, tile, span, txb)
    assert (fim >= 0).sum() > 100


def test_bucket_kernels_match_jax_random_oversized_and_empty():
    fv = _random_oversized()
    fim = _compare(fv, 64, 8, 3, 2)
    assert (fim == 0).sum() > 100            # the oversized face won
    fv_far = fv.copy()
    fv_far[..., 2] = 30.0                    # every face behind far
    fim_e = _compare(fv_far, 64, 8, 3, 2)
    assert (fim_e == -1).all()


@pytest.mark.parametrize("seed", [7, 19, 42])
def test_bucket_kernels_match_jax_fuzz(seed):
    fim = _compare(_fuzz(seed), 64, 8, 3, 2)
    assert (fim >= 0).mean() > 0.3


def _pallas_body_numpy(fv, src, s, near, far, keep):
    """The Pallas bucket body's per-pixel arithmetic
    (pallas_raster.py:219-319) in float32 numpy, over every kept face:
    (fim, wim, T) with the vertical flip applied."""
    f32 = np.float32
    b, nf = fv.shape[:2]
    sf = f32(s)
    yi, xi = np.meshgrid(np.arange(s, dtype=f32), np.arange(s, dtype=f32),
                         indexing="ij")
    xi, yi = xi.reshape(-1, 1), yi.reshape(-1, 1)
    xp = (f32(2.0) * xi + f32(1.0) - sf) / sf
    yp = (f32(2.0) * yi + f32(1.0) - sf) / sf
    fim = np.full((b, s * s), -1, np.int32)
    wim = np.zeros((b, s * s, 3), f32)
    flow = np.full((b, s * s, 2), -2.0, f32)
    for bi in range(b):
        ids = keep[bi]
        d = fv[bi, ids].reshape(-1, 9).T[:, None, :]          # (9, 1, n)
        fx0, fy0, fz0, fx1, fy1, fz1, fx2, fy2, fz2 = d
        h = f32(0.5)
        p0x, p0y = h * (fx0 * sf + sf - f32(1)), h * (fy0 * sf + sf - f32(1))
        p1x, p1y = h * (fx1 * sf + sf - f32(1)), h * (fy1 * sf + sf - f32(1))
        p2x, p2y = h * (fx2 * sf + sf - f32(1)), h * (fy2 * sf + sf - f32(1))
        denom = (p2x * (p0y - p1y) + p0x * (p1y - p2y)
                 + p1x * (p2y - p0y))
        rden = f32(1) / np.where(denom == 0, f32(1), denom)
        t0 = (yp - fy0) * (fx1 - fx0) - (xp - fx0) * (fy1 - fy0)
        t1 = (yp - fy1) * (fx2 - fx1) - (xp - fx1) * (fy2 - fy1)
        t2 = (yp - fy2) * (fx0 - fx2) - (xp - fx2) * (fy0 - fy2)
        inside = (t0 >= 0) & (t1 >= 0) & (t2 >= 0)
        w0 = np.clip(((p1y - p2y) * rden) * xi + ((p2x - p1x) * rden) * yi
                     + (p1x * p2y - p2x * p1y) * rden, f32(0), f32(1))
        w1 = np.clip(((p2y - p0y) * rden) * xi + ((p0x - p2x) * rden) * yi
                     + (p2x * p0y - p0x * p2y) * rden, f32(0), f32(1))
        w2 = np.clip(((p0y - p1y) * rden) * xi + ((p1x - p0x) * rden) * yi
                     + (p0x * p1y - p1x * p0y) * rden, f32(0), f32(1))
        wsum = w0 + w1 + w2
        rws = f32(1) / np.where(wsum == 0, f32(1), wsum)
        w0, w1, w2 = w0 * rws, w1 * rws, w2 * rws
        zp = f32(1) / (w0 * (f32(1) / fz0) + w1 * (f32(1) / fz1)
                       + w2 * (f32(1) / fz2))
        valid = inside & (zp > near) & (zp < far)
        zm = np.where(valid, zp, np.inf)
        at = valid & (zm == zm.min(1, keepdims=True))
        win = np.where(at, ids[None, :], np.iinfo(np.int32).max).min(1)
        has = at.any(1)
        lane = np.argmax(at & (ids[None, :] == win[:, None]), axis=1)
        px = np.nonzero(has)[0]
        ln = lane[px]
        sx = src[0, ids].reshape(-1, 6)[ln]
        ws = np.stack([w0[px, ln], w1[px, ln], w2[px, ln]], -1)
        fim[bi, px] = win[px]
        wim[bi, px] = ws
        flow[bi, px, 0] = ws[:, 0] * sx[:, 0] + ws[:, 1] * sx[:, 2] \
            + ws[:, 2] * sx[:, 4]
        flow[bi, px, 1] = ws[:, 0] * sx[:, 1] + ws[:, 1] * sx[:, 3] \
            + ws[:, 2] * sx[:, 5]
    return (fim.reshape(b, s, s)[:, ::-1], wim.reshape(b, s, s, 3)[:, ::-1],
            flow.reshape(b, s, s, 2)[:, ::-1])


@pytest.mark.parametrize("scene", ["body", "fuzz"])
def test_plain_matches_pallas_body_arithmetic(assets, scene):
    """Bit-level: the plain twins reproduce the Pallas body's float32
    arithmetic exactly (weights and flow equal, not just close)."""
    fv = _body(assets) if scene == "body" else _fuzz(7)
    s, tile, span = 64, 8, 3
    src = _src(fv.shape[1])
    t_fv = torch.from_numpy(fv)
    _, _, starts, order = trast._bucket_sort(t_fv, s, tile, span, FAR)
    n_tiles = (s // tile) ** 2
    keep = [order[bi, :int(starts[bi, n_tiles + 1])].numpy()
            for bi in range(fv.shape[0])]
    fim_n, wim_n, t_n = _pallas_body_numpy(fv, src, s, NEAR, FAR, keep)
    fim_t, wim_t = trast.rasterize_fim_wim_bucket(t_fv, s, tile=tile,
                                                  span=span)
    _, t_t = trast.rasterize_flow_bucket(t_fv, torch.from_numpy(src), s,
                                         tile=tile, span=span)
    np.testing.assert_array_equal(fim_t.numpy(), fim_n)
    np.testing.assert_array_equal(wim_t.numpy(), wim_n)
    np.testing.assert_array_equal(t_t.numpy(), t_n)
