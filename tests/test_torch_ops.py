"""Port parity of the geometry and image ops: the same numpy inputs go
through impersonator_tpu (JAX, CPU) and impersonator_tpu_torch (torch,
CPU) and the outputs are compared at float32 tolerances."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impersonator_tpu.ops import flow as jflow
from impersonator_tpu.ops import morphology as jmorph
from impersonator_tpu.ops import rasterizer as jrast
from impersonator_tpu.ops import sampler as jsampler
from impersonator_tpu.ops import smpl as jsmpl
from impersonator_tpu_torch.ops import flow as tflow
from impersonator_tpu_torch.ops import morphology as tmorph
from impersonator_tpu_torch.ops import rasterizer as trast
from impersonator_tpu_torch.ops import sampler as tsampler
from impersonator_tpu_torch.ops import smpl as tsmpl
from torch_threads import one_torch_thread  # noqa: F401


def _thetas(rng, n):
    theta = np.zeros((n, 85), np.float32)
    theta[:, 0] = 0.9
    theta[:, 1:3] = rng.uniform(-0.1, 0.1, (n, 2))
    theta[:, 3:75] = rng.normal(0, 0.2, (n, 72))
    theta[:, 75:] = rng.normal(0, 0.5, (n, 10))
    return theta


def _both_details(assets, theta):
    jd = jsmpl.get_details(jsmpl.SMPLParams.from_assets(assets),
                           jnp.asarray(theta), assets.parents)
    td = tsmpl.get_details(tsmpl.SMPLParams.from_assets(assets, "cpu"),
                           torch.from_numpy(theta), assets.parents)
    return jd, td


def test_get_details_matches_jax(assets):
    theta = _thetas(np.random.default_rng(0), 3)
    jd, td = _both_details(assets, theta)
    for k in ("verts", "j2d", "j3d", "cam", "pose", "shape"):
        np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]),
                                   atol=1e-5, err_msg=k)


def test_project_to_raster_space_matches_jax(assets):
    theta = _thetas(np.random.default_rng(1), 2)
    jd, td = _both_details(assets, theta)
    fj = jrast.project_to_raster_space(jd["verts"], jd["cam"],
                                       jnp.asarray(assets.faces))
    faces = torch.from_numpy(assets.faces.astype(np.int64))
    ft = trast.project_to_raster_space(td["verts"], td["cam"], faces)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=1e-5)


@pytest.mark.parametrize("s,tile,span", [(64, 8, 4), (256, 16, 2)])
def test_bucket_sort_matches_jax(assets, s, tile, span):
    theta = _thetas(np.random.default_rng(2), 2)
    jd, _ = _both_details(assets, theta)
    fv = np.array(jrast.project_to_raster_space(
        jd["verts"], jd["cam"], jnp.asarray(assets.faces)))
    vj, fj, sj, oj = jrast._bucket_sort(jnp.asarray(fv), s, tile, span, 128,
                                        jrast.DEFAULT_FAR)
    vt, ft, st, ot = trast._bucket_sort(torch.from_numpy(fv), s, tile, span,
                                        jrast.DEFAULT_FAR)
    nf = fv.shape[1]
    # the JAX table is lane-major (B, 9, nf_pad); the port's face-major
    np.testing.assert_array_equal(
        vt.numpy(), np.asarray(vj)[:, :, :nf].transpose(0, 2, 1))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj)[:, 0, :nf])
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj)[:, 0])
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))


def test_brute_rasterizer_matches_jax(assets):
    theta = _thetas(np.random.default_rng(3), 2)
    jd, _ = _both_details(assets, theta)
    fv = np.array(jrast.project_to_raster_space(
        jd["verts"], jd["cam"], jnp.asarray(assets.faces)))
    fim_j, wim_j = jrast.rasterize_fim_wim(jnp.asarray(fv), 48)
    fim_t, wim_t = trast.rasterize_fim_wim(torch.from_numpy(fv), 48)
    np.testing.assert_array_equal(fim_t.numpy(), np.asarray(fim_j))
    # XLA's CPU backend contracts the barycentric multiply-adds into FMAs;
    # the cancellation in the rows amplifies that ulp (see
    # test_torch_raster's module docstring): measured 2.9e-4 here
    np.testing.assert_allclose(wim_t.numpy(), np.asarray(wim_j), atol=1e-3)
    assert (fim_t.numpy() >= 0).mean() > 0.02


def _fim(rng, b, s, nf):
    fim = rng.integers(-1, nf, (b, s, s)).astype(np.int32)
    fim[:, : s // 4] = -1
    return fim


def test_encode_fim_and_visibility_match_jax(assets):
    rng = np.random.default_rng(4)
    fim = _fim(rng, 2, 16, assets.nf)
    table = assets.map_fn("uv_seg")
    np.testing.assert_allclose(
        tflow.encode_fim(torch.from_numpy(fim),
                         torch.from_numpy(table)).numpy(),
        np.asarray(jflow.encode_fim(jnp.asarray(fim), jnp.asarray(table))),
        atol=1e-6)
    f2pts = rng.uniform(-1, 1, (2, assets.nf, 3, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tflow.visible_f2pts(torch.from_numpy(f2pts),
                            torch.from_numpy(fim)).numpy(),
        np.asarray(jflow.visible_f2pts(jnp.asarray(f2pts), jnp.asarray(fim))))


def test_correspondence_flow_matches_jax(assets):
    rng = np.random.default_rng(5)
    fim = _fim(rng, 2, 16, assets.nf)
    wim = rng.dirichlet(np.ones(3), (2, 16, 16)).astype(np.float32)
    src = rng.uniform(-1, 1, (1, assets.nf, 3, 2)).astype(np.float32)
    tj = np.asarray(jflow.correspondence_flow(
        jnp.asarray(src), jnp.asarray(fim), jnp.asarray(wim)))
    tt = tflow.correspondence_flow(torch.from_numpy(src),
                                   torch.from_numpy(fim),
                                   torch.from_numpy(wim)).numpy()
    np.testing.assert_allclose(tt, tj, atol=1e-6)
    assert (tt[fim < 0] == -2.0).all()


@pytest.mark.parametrize("mode,ks", [("erode", 3), ("erode", 7),
                                     ("dilate", 5)])
def test_morph_matches_jax(mode, ks):
    rng = np.random.default_rng(6)
    # a block with speckle, touching the border (exercises the pad value)
    mask = np.zeros((2, 24, 24, 1), np.float32)
    mask[:, 0:18, 4:20] = 1.0
    mask[rng.random(mask.shape) < 0.05] = 1.0
    mask[rng.random(mask.shape) < 0.02] = 0.0
    out_j = np.asarray(jmorph.morph(jnp.asarray(mask), ks=ks, mode=mode))
    out_t = tmorph.morph(torch.from_numpy(mask), ks=ks, mode=mode).numpy()
    np.testing.assert_allclose(out_t, out_j, atol=1e-6)
    assert 0 < out_t.mean() < 1


@pytest.mark.parametrize("src_batch", [1, 3])
def test_grid_sample_matches_jax(src_batch):
    """Bilinear warp incl. the -2 background (samples exactly 0), points
    off the image edge and a batch-1 source over a batch-3 grid."""
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (src_batch, 12, 10, 5)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (3, 9, 11, 2)).astype(np.float32)
    grid[:, :3] = -2.0
    out_j = np.asarray(jsampler.grid_sample(jnp.asarray(x),
                                            jnp.asarray(grid)))
    out_t = tsampler.grid_sample(torch.from_numpy(x),
                                 torch.from_numpy(grid)).numpy()
    assert out_t.shape == (3, 9, 11, 5)
    np.testing.assert_allclose(out_t, out_j, atol=1e-6)
    assert (out_t[:, :3] == 0.0).all()


def test_resize_flow_matches_jax():
    rng = np.random.default_rng(8)
    t = rng.uniform(-1, 1, (2, 32, 32, 2)).astype(np.float32)
    t[:, :8] = -2.0
    for h, w in ((16, 16), (8, 4), (32, 32)):
        out_j = np.asarray(jsampler.resize_flow(jnp.asarray(t), h, w))
        out_t = tsampler.resize_flow(torch.from_numpy(t), h, w).numpy()
        np.testing.assert_allclose(out_t, out_j, atol=1e-6)
