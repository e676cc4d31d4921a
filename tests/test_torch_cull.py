"""The bucket kernel's warp cull is exact.

``csrc/zbuffer_bucket.cu`` skips a (warp, face) pair when no pixel centre
of the warp can pass the face's inside test; its plain mirror
``ops.cuda_raster.bucket_warp_masks_plain`` computes the same masks in the
same float32 order. Every (pixel, candidate) pair whose inside test passes
as the plain twin computes it (``cuda_raster._pair_weights``) must lie in
a (warp, face) pair the mask keeps, on bodies, random, fuzz and degenerate
scenes; on the bench bodies the mask must keep few pairs.
"""

import numpy as np
import pytest
import torch

from impersonator_tpu_torch.assets import bench_assets
from impersonator_tpu_torch.ops import cuda_raster as cr
from impersonator_tpu_torch.ops import rasterizer as rast
from impersonator_tpu_torch.ops import smpl as smpl_ops
from impersonator_tpu_torch.scenes import degenerate_scene

from test_torch_raster import _fuzz, _random_oversized
from torch_threads import one_torch_thread  # noqa: F401

KEEP_MAX = 0.10      # share of (warp, face) pairs kept on the 256² bodies


def _bench_bodies():
    """Two posed 12,880-face bench bodies in raster space, as the bench
    poses them: theta0 (cam 0.9) plus N(0, 0.05) pose noise."""
    assets = bench_assets()
    params = smpl_ops.SMPLParams.from_assets(assets, torch.device("cpu"))
    rng = np.random.default_rng(0)
    theta = np.zeros((2, 85), np.float32)
    theta[:, 0] = 0.9
    theta[:, 3:75] += rng.normal(0, 0.05, (2, 72)).astype(np.float32)
    d = smpl_ops.get_details(params, torch.from_numpy(theta), assets.parents)
    return rast.project_to_raster_space(d["verts"], d["cam"], params.faces)


def _scene(name, s):
    if name == "bodies":
        return _bench_bodies()
    if name == "random_oversized":
        return torch.from_numpy(_random_oversized())
    if name == "degenerate":
        return torch.from_numpy(degenerate_scene(s))
    return torch.from_numpy(_fuzz(int(name[4:])))


def _masks(fv, s, tile, span):
    """(sorted verts, warp masks, candidate positions, share of the
    (warp, face) pairs the masks keep)."""
    verts, _, starts, _ = rast._bucket_sort(fv, s, tile, span,
                                            rast.DEFAULT_FAR)
    masks, pos = cr.bucket_warp_masks_plain(verts, starts, s, tile, span)
    n_warps = (tile // cr.WARP_W) * (tile // cr.WARP_H)
    kept = sum(int(((masks >> w) & 1).sum()) for w in range(n_warps))
    return verts, masks, pos, kept / max(1, int((pos >= 0).sum()) * n_warps)


def _cull_vs_inside(fv, s, tile, span):
    """Mask bits against the inside test on every candidate pair: returns
    (passing pairs, passing pairs whose pixel lies outside the face's
    integer pixel bbox); fails on a passing pair the mask drops."""
    verts, masks, pos, _ = _masks(fv, s, tile, span)
    b, n_tiles, npx = fv.shape[0], (s // tile) ** 2, tile * tile
    xi, yi, xp, yp = cr._tile_pixels(s, tile, fv.device)
    warp = cr.warp_of_pixel(tile)[None, None, :, None]
    bidx = torch.arange(b)[:, None, None]
    chunk = max(1, cr._PLAIN_BLOCK // (b * n_tiles * npx))
    passing = outside = 0
    for c0 in range(0, pos.shape[-1], chunk):
        p = pos[..., c0:c0 + chunk]
        d = verts[bidx, p.clamp(min=0)]                 # (B, T, C, 9)
        inside = cr._pair_weights(d, xi, yi, xp, yp, float(s))[0]
        inside &= (p >= 0)[:, :, None, :]
        bit = (masks[..., c0:c0 + chunk][:, :, None, :] >> warp) & 1
        dropped = inside & (bit == 0)
        assert not dropped.any(), (
            f"the cull drops {int(dropped.sum())} passing pairs")
        passing += int(inside.sum())
        x0, x1, y0, y1 = (v[:, :, None] for v in rast._pixel_bbox(
            d[..., 0::3], d[..., 1::3], s))
        in_bbox = (xi >= x0) & (xi <= x1) & (yi >= y0) & (yi <= y1)
        outside += int((inside & ~in_bbox).sum())
    return passing, outside


@pytest.mark.parametrize("name,s,tile,span", [
    ("bodies", 64, 16, 2),
    ("bodies", 256, 16, 2),
    ("random_oversized", 64, 8, 3),
    ("fuzz7", 64, 8, 3),
    ("fuzz19", 64, 8, 3),
    ("fuzz42", 64, 8, 3),
    ("degenerate", 64, 8, 3),
    ("degenerate", 256, 16, 2),
])
def test_cull_keeps_every_passing_pair(name, s, tile, span):
    passing, outside = _cull_vs_inside(_scene(name, s), s, tile, span)
    assert passing > 100
    if name == "degenerate":
        # pixels pass beyond the faces' bboxes: a bbox cull would drop them
        assert outside > 0


def test_cull_keeps_few_pairs_on_bodies():
    share = _masks(_bench_bodies(), 256, 16, 2)[-1]
    assert 0.0 < share <= KEEP_MAX
