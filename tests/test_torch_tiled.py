"""Port parity of the fixed-slot tiled path: the plain twin of the
``zbuffer_tiles`` kernel, ``rasterize_fim_wim_tiled``,
``raster_tile_stats`` and the renderer's three-way gate, against the JAX
package on the same numpy inputs.

Tolerances. The twin reproduces the Pallas body's float32 arithmetic bit
for bit (held to a numpy transliteration here, as the CUDA kernel, built
with --fmad=false, computes it too). Against JAX on the CPU, weights are
compared at 1e-3: XLA's CPU backend contracts the body's multiply-adds
into FMAs and the barycentric rows cancel (ROADMAP Queue 3). On meshes
with faces of a pixel or less (the 12,880-face body at 256², a 63,480-face
body) that gap grows as 1/area: a row product such as p1x*p2y is up to S²
and moves by an ulp of it, S²·2^-23, which the weight divides by the
face's doubled area in px². So on those scenes a pixel's weights are held
to max(1e-3, 2·S²·2^-23 / |area|) (measured at most 0.45 of that). The
same contraction moves the depth of near-coincident faces by an ulp: on
the 256² body one pixel in 65,536 changes its winner (two faces 0.01
apart in depth crossing inside the torso); fim is exact on every other
scene.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impersonator_tpu import assets as jassets
from impersonator_tpu.ops import pallas_raster
from impersonator_tpu.ops import rasterizer as jrast
from impersonator_tpu.tasks.renderer import SMPLRenderer as JRenderer
from impersonator_tpu_torch import assets as tassets
from impersonator_tpu_torch.ops import cuda_raster
from impersonator_tpu_torch.ops import rasterizer as trast
from impersonator_tpu_torch.tasks.renderer import SMPLRenderer as TRenderer

from test_rasterizer import _random_faces, _smpl_face_verts
from test_torch_raster import _body, _random_oversized
from torch_threads import one_torch_thread  # noqa: F401

NEAR, FAR = jrast.DEFAULT_NEAR, jrast.DEFAULT_FAR
XLA_FMA_TOL = 1e-3


def _scene(name, assets=None):
    """(face verts (B, nf, 3, 3), s, tile, cap, span)."""
    if name == "random":
        return _random_faces(np.random.default_rng(11), 2, 40), 32, 8, 40, 2
    if name == "oversized":
        return _random_oversized(), 64, 8, 64, 3
    if name == "overflow":       # cap 4 drops candidates in most tiles
        return _random_faces(np.random.default_rng(9), 1, 30), 32, 8, 4, 2
    return _body(assets), 64, 8, 288, 10


def _jax_zbuffer_tiles(packed, cand, valid, s, tile, chunk=8):
    """JAX zbuffer_tiles (interpret mode) on the port's slots, gathered
    into its (B, T, 9, slots) layout; output untiled and flipped."""
    b, n_tiles, slots = cand.shape
    pad = (-slots) % chunk
    cand = np.pad(cand, ((0, 0), (0, 0), (0, pad)))
    valid = np.pad(valid, ((0, 0), (0, 0), (0, pad)))
    cdata = np.take_along_axis(packed[:, None], cand[..., None], axis=2)
    fim, w0, w1, w2 = pallas_raster.zbuffer_tiles(
        jnp.asarray(cdata.transpose(0, 1, 3, 2)),
        jnp.asarray(cand[:, :, None]), jnp.asarray(valid[:, :, None]),
        s, tile, NEAR, FAR, chunk=chunk, interpret=True)
    g = s // tile

    def untile(a):
        a = np.asarray(a).reshape(b, g, g, tile, tile)
        return a.transpose(0, 1, 3, 2, 4).reshape(b, s, s)[:, ::-1]

    return untile(fim), np.stack([untile(w) for w in (w0, w1, w2)], -1)


def _tiles_body_numpy(packed, cand, valid, s, tile):
    """The Pallas fixed-slot body's per-pixel arithmetic
    (pallas_raster.py:80-134) in float32 numpy over all slots at once:
    (fim, wim) with the vertical flip applied."""
    f32 = np.float32
    b, n_tiles, slots = cand.shape
    g = s // tile
    p = np.arange(tile * tile)
    t = np.arange(n_tiles)
    yi = ((t // g)[:, None] * tile + p // tile).astype(f32)[..., None]
    xi = ((t % g)[:, None] * tile + p % tile).astype(f32)[..., None]
    sf = f32(s)
    xp = (f32(2) * xi + f32(1) - sf) / sf
    yp = (f32(2) * yi + f32(1) - sf) / sf
    fim = np.full((b, n_tiles, tile * tile), -1, np.int32)
    wim = np.zeros((b, n_tiles, tile * tile, 3), f32)
    for bi in range(b):
        d = packed[bi][cand[bi]].transpose(2, 0, 1)[:, :, None, :]
        fx0, fy0, fz0, fx1, fy1, fz1, fx2, fy2, fz2 = d    # (T, 1, slots)
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
        wsum = np.where(wsum == 0, f32(1), wsum)
        w0, w1, w2 = w0 / wsum, w1 / wsum, w2 / wsum
        with np.errstate(divide="ignore", invalid="ignore"):
            zp = f32(1) / (w0 / fz0 + w1 / fz1 + w2 / fz2)
        ok = inside & (valid[bi][:, None, :] != 0) & (zp > NEAR) & (zp < FAR)
        zm = np.where(ok, zp, np.inf)
        lane = np.argmin(zm, axis=-1)                     # first minimum
        has = np.take_along_axis(ok, lane[..., None], -1)[..., 0]
        ws = np.stack([np.take_along_axis(w, lane[..., None], -1)[..., 0]
                       for w in (w0, w1, w2)], -1)
        fim[bi] = np.where(has, cand[bi][np.arange(n_tiles)[:, None], lane],
                           -1)
        wim[bi] = np.where(has[..., None], ws, f32(0))

    def untile(a):
        a = a.reshape((b, g, g, tile, tile) + a.shape[3:])
        return a.swapaxes(2, 3).reshape((b, s, s) + a.shape[5:])[:, ::-1]

    return untile(fim), untile(wim)


def _slots(fv, s, tile, cap, span):
    packed, cand, valid = trast._tiled_candidates(
        torch.from_numpy(fv), s, tile, cap, span, FAR)
    return packed.numpy(), cand.numpy(), valid.numpy()


@pytest.mark.parametrize("name", ["random", "oversized", "overflow", "body"])
def test_tiles_twin_matches_pallas_kernel(assets, name):
    """The twin against JAX's zbuffer_tiles in interpret mode, and bit
    for bit against the Pallas body's float32 arithmetic."""
    fv, s, tile, cap, span = _scene(name, assets)
    packed, cand, valid = _slots(fv, s, tile, cap, span)
    fim_t, wim_t = cuda_raster.zbuffer_tiles(
        *(torch.from_numpy(a) for a in (packed, cand, valid)), s, tile,
        NEAR, FAR)
    fim_t, wim_t = fim_t.numpy(), wim_t.numpy()
    fim_j, wim_j = _jax_zbuffer_tiles(packed, cand, valid, s, tile)
    np.testing.assert_array_equal(fim_t, fim_j)
    assert (wim_t[fim_t < 0] == 0.0).all()
    np.testing.assert_allclose(wim_t, wim_j, atol=XLA_FMA_TOL)
    fim_n, wim_n = _tiles_body_numpy(packed, cand, valid, s, tile)
    np.testing.assert_array_equal(fim_t, fim_n)
    np.testing.assert_array_equal(wim_t, wim_n)
    assert (fim_t >= 0).mean() > 0.05
    if name == "oversized":
        assert (fim_t == 0).sum() > 100          # the oversized face won
        assert (valid[:, :, 0] == 1).all()       # ... from the first slot


def test_tiles_twin_slot_order_breaks_ties():
    """Two coincident faces: the one in the earlier slot wins, whatever
    its face id (the oversized slots come first)."""
    tri = np.array([[-0.6, -0.6, 2.0], [0.6, -0.6, 2.0], [0.0, 0.6, 2.0]],
                   np.float32)
    packed = torch.from_numpy(np.stack([tri, tri]).reshape(1, 2, 9))
    s, tile = 16, 8
    n_tiles = (s // tile) ** 2
    for order in ([0, 1], [1, 0]):
        cand = torch.tensor(order, dtype=torch.int32).expand(1, n_tiles, 2)
        valid = torch.ones_like(cand)
        fim, _ = cuda_raster.zbuffer_tiles(packed, cand.contiguous(), valid,
                                           s, tile, NEAR, FAR)
        covered = fim[fim >= 0]
        assert covered.numel() > 20 and (covered == order[0]).all()


def _fma_tol(fv, fim, s):
    """Per-pixel weight tolerance against XLA-on-CPU (see the module
    docstring): max(1e-3, 2·S²·2^-23 / |doubled area of the winner|)."""
    b = fv.shape[0]
    f = np.clip(fim, 0, None).reshape(b, -1)
    v = np.take_along_axis(fv, f[..., None, None], 1).astype(np.float64)
    p = 0.5 * (v[..., :2] * s + s - 1)
    area = (p[..., 2, 0] * (p[..., 0, 1] - p[..., 1, 1])
            + p[..., 0, 0] * (p[..., 1, 1] - p[..., 2, 1])
            + p[..., 1, 0] * (p[..., 2, 1] - p[..., 0, 1]))
    tol = np.maximum(XLA_FMA_TOL, 2.0 * s * s * 2.0 ** -23 / np.abs(area))
    return tol.reshape(fim.shape)[..., None]


def _tiled_both(fv, s, tile, cap, span):
    port = trast.rasterize_fim_wim_tiled(torch.from_numpy(fv), s, tile=tile,
                                         cap=cap, span=span)
    port = tuple(x.numpy() for x in port)
    jax_out = {}
    for backend in ("pallas", "xla"):
        f, w = jrast.rasterize_fim_wim_tiled(
            jnp.asarray(fv), s, tile=tile, cap=cap, span=span, chunk=64,
            backend=backend)
        jax_out[backend] = np.asarray(f), np.asarray(w)
    return port, jax_out


@pytest.mark.parametrize("scene", ["random32", "overflow32", "body256"])
def test_tiled_raster_matches_jax(scene):
    if scene == "body256":
        fv = _body(jassets.bench_assets(), n=1)
        s, tile, cap, span, max_flips = 256, 8, 288, 3, 1
    else:
        fv, s, tile, cap, span = _scene(scene[:-2])
        max_flips = 0
    (fim_t, wim_t), jax_out = _tiled_both(fv, s, tile, cap, span)
    assert fim_t.dtype == np.int32 and fim_t.shape == (fv.shape[0], s, s)
    tol = _fma_tol(fv, fim_t, s)
    for backend, (fim_j, wim_j) in jax_out.items():
        agree = fim_t == fim_j
        assert (~agree).sum() <= max_flips, (backend, (~agree).sum())
        gap = np.abs(wim_t - wim_j)
        assert (gap <= tol)[agree].all(), (backend, gap[agree].max())
    assert (fim_t >= 0).mean() > 0.05


def test_tile_stats_match_jax(assets):
    cases = [(np.asarray(_smpl_face_verts(jassets.bench_assets())),
              dict(image_size=256, tile=8, cap=288, span=3)),
             (np.asarray(_smpl_face_verts(assets, cam_scale=8.0)),
              dict(image_size=256, tile=8, cap=16, ex=2)),
             (_random_oversized(), dict(image_size=64, tile=8, cap=8,
                                        span=3))]
    for fv, kw in cases:
        got = trast.raster_tile_stats(torch.tensor(fv), **kw)
        want = jrast.raster_tile_stats(jnp.asarray(fv), **kw)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)
    assert int(got["dropped_pairs"][0]) > 0


def _jax_route(r: JRenderer):
    """The JAX gate of render_fim_wim (renderer.py:73-93)."""
    tile, _, _ = r.tile_params()
    if r._bucket_config() is not None:
        return "bucket"
    return "tiled" if tile and r.faces.shape[0] > 256 else "brute"


@pytest.mark.parametrize("rings,segments,s,want", [
    (2, 4, 64, "brute"), (11, 28, 256, "bucket"), (11, 28, 60, "brute"),
    (24, 60, 64, "tiled")])
def test_renderer_gate_matches_jax(monkeypatch, rings, segments, s, want):
    """The port routes where the JAX gate would if "TPU" meant "the
    port"; on a mesh over 60,000 faces the tiled route gives JAX's fim."""
    ja = jassets.synthetic_assets(rings=rings, segments=segments)
    ta = tassets.synthetic_assets(rings=rings, segments=segments)
    jr = JRenderer.create(ja, image_size=s)
    tr = TRenderer.create(ta, "cpu", image_size=s)
    assert tr.tile_params() == jr.tile_params()
    with monkeypatch.context() as m:
        m.setattr(jax, "default_backend", lambda: "tpu")
        assert tr.raster_route() == _jax_route(jr) == want
    if want != "tiled":
        return
    cam = np.array([[0.9, 0.0, 0.0]], np.float32)
    verts = ja.v_template[None]
    _, fim_j, wim_j = jr.render_fim_wim(jnp.asarray(cam), jnp.asarray(verts))
    fv, fim_t, wim_t = tr.render_fim_wim(torch.from_numpy(cam),
                                         torch.from_numpy(verts))
    np.testing.assert_array_equal(fim_t.numpy(), np.asarray(fim_j))
    gap = np.abs(wim_t.numpy() - np.asarray(wim_j))
    assert (gap <= _fma_tol(fv.numpy(), fim_t.numpy(), s)).all()
    assert (fim_t >= 0).float().mean() > 0.02
    stats = tr.tile_stats(fv)
    assert int(stats["dropped_pairs"][0]) == 0
