"""The hand-written CUDA kernels against their plain twins, on the card.

Marked ``cuda``: skips where torch sees no GPU. This file imports no JAX,
so on a GPU host without JAX it runs without the JAX-side conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from impersonator_tpu_torch.assets import bench_assets
from impersonator_tpu_torch.ops import cuda_raster
from impersonator_tpu_torch.ops import rasterizer as rast
from impersonator_tpu_torch.ops import smpl as smpl_ops
from impersonator_tpu_torch.scenes import degenerate_scene, tie_scene

pytestmark = pytest.mark.cuda

S, TILE, SPAN = 256, 16, 2


def _sorted(fv, s=S, tile=TILE, span=SPAN):
    """Bucket-sorted inputs of both kernels, with the first item's source
    xy as the flow's source."""
    verts, fid, starts, order = rast._bucket_sort(fv, s, tile, span,
                                                  rast.DEFAULT_FAR)
    b, nf = fv.shape[0], fv.shape[1]
    src = fv[0:1, ..., :2].reshape(1, nf, 6).expand(b, nf, 6)
    srcxy = torch.gather(src, 1, order[..., None].expand(b, nf, 6))
    return verts, fid, starts, srcxy.contiguous(), fv


@pytest.fixture(scope="module")
def bodies():
    """Four posed 12,880-face bodies at 256² on the card, bucket-sorted,
    with the first pose's source xy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    assets = bench_assets()
    params = smpl_ops.SMPLParams.from_assets(assets, dev)
    rng = np.random.default_rng(0)
    theta = np.zeros((4, 85), np.float32)
    theta[:, 0] = 0.9
    theta[1:, 3:75] = rng.normal(0, 0.05, (3, 72))
    d = smpl_ops.get_details(params, torch.from_numpy(theta).to(dev),
                             assets.parents)
    return _sorted(rast.project_to_raster_space(d["verts"], d["cam"],
                                                params.faces))


@pytest.fixture(scope="module", params=["bodies", "degenerate"])
def scene(request, bodies):
    """(name, bucket inputs): the bodies, and the degenerate scene that
    the warp cull must keep where the inside test passes."""
    if request.param == "bodies":
        return request.param, bodies
    fv = torch.from_numpy(degenerate_scene(S)).cuda()
    return request.param, _sorted(fv)


def test_rows_kernel_matches_plain(scene):
    name, (verts, fid, starts, _, _) = scene
    args = (S, TILE, SPAN, rast.DEFAULT_NEAR, rast.DEFAULT_FAR)
    before = cuda_raster.zbuffer_bucket_rows.launches
    fim_k, wim_k = cuda_raster.zbuffer_bucket_rows(verts, fid, starts, *args)
    torch.cuda.synchronize()
    assert cuda_raster.zbuffer_bucket_rows.launches == before + 1
    fim_p, wim_p = cuda_raster.zbuffer_bucket_rows_plain(verts, fid, starts,
                                                         *args)
    assert torch.equal(fim_k, fim_p)
    if name == "bodies":
        assert (fim_k >= 0).float().mean() > 0.02
    assert torch.allclose(wim_k, wim_p, rtol=0, atol=2e-4)


def test_flow_kernel_matches_plain(scene):
    _, (verts, fid, starts, srcxy, _) = scene
    args = (S, TILE, SPAN, rast.DEFAULT_NEAR, rast.DEFAULT_FAR)
    fim_k, t_k = cuda_raster.zbuffer_bucket_flow(verts, fid, srcxy, starts,
                                                 *args)
    torch.cuda.synchronize()
    fim_p, t_p = cuda_raster.zbuffer_bucket_flow_plain(verts, fid, srcxy,
                                                       starts, *args)
    assert torch.equal(fim_k, fim_p)
    assert (t_k[fim_k < 0] == -2.0).all()
    assert torch.allclose(t_k, t_p, rtol=0, atol=1e-5)


def test_kernels_match_plain_at_tile_8():
    """The 8-px tile instantiation (2 warps a tile), which the renderer
    takes where the image does not divide by 16: the degenerate scene at
    64², span 3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    s, tile, span = 64, 8, 3
    fv = torch.from_numpy(degenerate_scene(s)).cuda()
    verts, fid, starts, srcxy, _ = _sorted(fv, s, tile, span)
    args = (s, tile, span, rast.DEFAULT_NEAR, rast.DEFAULT_FAR)
    fim_k, wim_k = cuda_raster.zbuffer_bucket_rows(verts, fid, starts, *args)
    fimf_k, t_k = cuda_raster.zbuffer_bucket_flow(verts, fid, srcxy, starts,
                                                  *args)
    torch.cuda.synchronize()
    fim_p, wim_p = cuda_raster.zbuffer_bucket_rows_plain(verts, fid, starts,
                                                         *args)
    _, t_p = cuda_raster.zbuffer_bucket_flow_plain(verts, fid, srcxy, starts,
                                                   *args)
    assert torch.equal(fim_k, fim_p) and torch.equal(fimf_k, fim_p)
    assert (fim_k >= 0).float().mean() > 0.05
    assert torch.allclose(wim_k, wim_p, rtol=0, atol=2e-4)
    assert torch.allclose(t_k, t_p, rtol=0, atol=1e-5)


def _tiles_vs_plain(fv, cap, span=3, tile=8):
    slots = rast._tiled_candidates(fv, S, tile, cap, span, rast.DEFAULT_FAR)
    return _slots_vs_plain(slots, tile)


def _slots_vs_plain(slots, tile, s=S):
    """zbuffer_tiles on the card against its twin on the same slots."""
    args = (s, tile, rast.DEFAULT_NEAR, rast.DEFAULT_FAR)
    before = cuda_raster.zbuffer_tiles.launches
    fim_k, wim_k = cuda_raster.zbuffer_tiles(*slots, *args)
    torch.cuda.synchronize()
    assert cuda_raster.zbuffer_tiles.launches == before + 1
    fim_p, wim_p = cuda_raster.zbuffer_tiles_plain(*slots, *args)
    assert torch.equal(fim_k, fim_p)
    assert (wim_k[fim_k < 0] == 0.0).all()
    assert torch.allclose(wim_k, wim_p, rtol=0, atol=2e-4)
    return fim_k


def test_tiles_kernel_matches_plain_and_rows(bodies):
    """On the bodies at the renderer's 256² point (tile 8, cap 288, span
    3) the fixed-slot kernel equals its twin and the bucket kernel's fim
    (both are the brute z-buffer's)."""
    verts, fid, starts, _, fv = bodies
    fim = _tiles_vs_plain(fv, 288)
    fim_rows, _ = cuda_raster.zbuffer_bucket_rows(
        verts, fid, starts, S, TILE, SPAN, rast.DEFAULT_NEAR,
        rast.DEFAULT_FAR)
    assert torch.equal(fim, fim_rows)
    assert (fim >= 0).float().mean() > 0.02


def test_tiles_kernel_matches_plain_on_cap_overflow():
    """3,000 random faces of a few pixels at cap 4: most tiles overflow,
    and kernel and twin drop the same candidates."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(9)
    xy = rng.uniform(-0.8, 0.8, (2, 3000, 1, 2)) \
        + rng.uniform(-0.03, 0.03, (2, 3000, 3, 2))
    z = rng.uniform(1.5, 3.0, (2, 3000, 3, 1))
    fv = torch.from_numpy(np.concatenate([xy, z], -1).astype(np.float32))
    fv = fv.cuda()
    stats = rast.raster_tile_stats(fv, S, rast.DEFAULT_FAR, 8, 4, 3)
    assert int(stats["dropped_pairs"].min()) > 0
    fim = _tiles_vs_plain(fv, 4)
    assert (fim >= 0).float().mean() > 0.05


def _tie_slots(**kw):
    """The tie scene's slots on the card (tests skip without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kw.setdefault("s", S)
    kw.setdefault("tile", 8)
    return tuple(torch.from_numpy(a).cuda() for a in tie_scene(**kw))


def test_tiles_kernel_matches_plain_on_ties():
    """Equal-depth faces listed on both sides of every share boundary of
    the kernel's split, with stray face ids: the lowest slot wins."""
    fim = _slots_vs_plain(_tie_slots(), 8)
    assert (fim >= 0).float().mean() > 0.05


def test_tiles_kernel_without_live_slots():
    """No slot live anywhere: every pixel is background."""
    slots = _tie_slots(live=0.0)
    fim = _slots_vs_plain(slots, 8)
    assert (fim == -1).all()


def test_tiles_kernel_at_full_cap():
    """Every tile holds exactly cap = 288 live slots (the 16 oversized
    slots dead), the most the renderer's 256² point lists."""
    packed, cand, valid = _tie_slots(live=1.0)
    valid[..., :16] = 0
    fim = _slots_vs_plain((packed, cand, valid.contiguous()), 8)
    assert (fim >= 0).float().mean() > 0.05


@pytest.mark.parametrize("tile,slots", [(8, 700), (16, 304), (32, 304),
                                        (4, 40)])
def test_tiles_kernel_at_other_shapes(tile, slots):
    """Tiles of one, four and sixteen warps' pixels per part, and more
    slots than one staging window holds (the kernel's other paths)."""
    fim = _slots_vs_plain(_tie_slots(tile=tile, slots=slots, batch=1), tile)
    assert (fim >= 0).float().mean() > 0.05


def test_tiles_kernel_on_the_tiled_route():
    """The renderer's tiled route on four posed 63,480-face bodies at
    256²: render_fim_wim launches the kernel once, and on its slots the
    kernel equals its twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from impersonator_tpu_torch.assets import synthetic_assets
    from impersonator_tpu_torch.tasks.renderer import SMPLRenderer
    dev = torch.device("cuda")
    big = synthetic_assets(rings=24, segments=60)
    r = SMPLRenderer.create(big, dev, image_size=S)
    assert r.raster_route() == "tiled"
    params = smpl_ops.SMPLParams.from_assets(big, dev)
    rng = np.random.default_rng(0)
    theta = np.zeros((4, 85), np.float32)
    theta[:, 0] = 0.9
    theta[:, 3:75] = rng.normal(0, 0.05, (4, 72))
    d = smpl_ops.get_details(params, torch.from_numpy(theta).to(dev),
                             big.parents)
    before = cuda_raster.zbuffer_tiles.launches
    fv, fim_r, wim_r = r.render_fim_wim(d["cam"], d["verts"])
    torch.cuda.synchronize()
    assert cuda_raster.zbuffer_tiles.launches == before + 1
    tile, cap, span = r.tile_params()
    fim = _tiles_vs_plain(fv, cap, span, tile)
    assert torch.equal(fim, fim_r)
    assert (fim >= 0).float().mean() > 0.02


def _to(state, dev):
    """A personalised state (tensors, and the feature lists) on dev."""
    def move(v):
        if torch.is_tensor(v):
            return v.to(dev)
        if isinstance(v, (list, tuple)):
            return type(v)(move(x) for x in v)
        return v
    return {k: move(v) for k, v in state.items()}


def test_swap_and_view_on_the_card_match_the_cpu():
    """Swapper.swap and Viewer.view_sweep at 64² on the card, float32
    with TF32 off, against the same seeded tasks on the CPU: swap_setup
    launches zbuffer_bucket_rows twice and a view batch
    zbuffer_bucket_flow once; the swap on the card from the CPU's two
    states, and the views' tail from the CPU's raster, are within 1e-2 of
    the CPU's; the flow kernel on the CPU's rotated meshes gives the CPU
    twin's fim and its flow within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from impersonator_tpu_torch.assets import synthetic_assets
    from impersonator_tpu_torch.config import TestConfig
    from impersonator_tpu_torch.ops.projection import euler_to_matrix
    from impersonator_tpu_torch.tasks import swapper as sw
    from impersonator_tpu_torch.tasks import viewer as vw
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    cfg = TestConfig(image_size=64, repeat_num=2, compute_dtype="float32")
    assets = synthetic_assets()
    rng = np.random.default_rng(3)
    src, tgt = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    th_src = np.zeros(85, np.float32)
    th_src[0] = 0.9
    th_tgt = th_src.copy()
    th_tgt[3:75] = rng.normal(0, 0.1, 72)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        swappers, viewers = {}, {}
        for d in (dev, cpu):
            swappers[d] = sw.Swapper(cfg, assets, device=d)
            rows = cuda_raster.zbuffer_bucket_rows.launches
            swappers[d].swap_setup(src, tgt, th_src, th_tgt)
            torch.cuda.synchronize()
            if d == dev:
                assert cuda_raster.zbuffer_bucket_rows.launches == rows + 2
            viewers[d] = vw.Viewer(cfg, assets, device=d)
            viewers[d].personalize(src, th_src)
        s_g, s_c = swappers[dev], swappers[cpu]
        for part in ("body", "all"):
            out = s_g.swap(target_part=part)
            assert out.shape == (1, 64, 64, 3) and torch.isfinite(out).all()
            left = [i for i in sw.PART_IDS["all"]
                    if i not in sw.PART_IDS[part]]
            tail = sw.swap_core(s_g.nets, s_g.renderer,
                                _to(s_c.src_info, dev), _to(s_c.tsf_info, dev),
                                s_g.left_faces(part), sw.PART_IDS[part],
                                left)
            ref = s_c.swap(target_part=part)
            assert torch.allclose(tail.cpu(), ref, rtol=0, atol=1e-2)

        v_g, v_c = viewers[dev], viewers[cpu]
        yaws = [0.0, 90.0, 180.0, 270.0]
        flow = cuda_raster.zbuffer_bucket_flow.launches
        views = v_g.view_sweep(yaws)
        torch.cuda.synchronize()
        assert cuda_raster.zbuffer_bucket_flow.launches == flow + 1
        assert views.shape == (4, 64, 64, 3) and torch.isfinite(views).all()
        rots = torch.stack([euler_to_matrix([0.0, y, 0.0]) for y in yaws])
        st_c = v_c.src_info
        mesh = vw.rotate_verts(st_c["verts"], rots, torch.zeros(4, 3))
        cam = st_c["cam"].expand(4, 3)
        fim_c, t_c = v_c.renderer.render_flow(cam, mesh, st_c["p2verts"])
        fim_g, t_g = v_g.renderer.render_flow(cam.to(dev), mesh.to(dev),
                                              st_c["p2verts"].to(dev))
        assert torch.equal(fim_g.cpu(), fim_c)
        assert (fim_c[1] >= 0).float().mean() > 0.02
        assert torch.allclose(t_g.cpu(), t_c, rtol=0, atol=1e-5)
        tail = vw.view_from_flow(v_g.nets, v_g.renderer, _to(st_c, dev),
                                 fim_c.to(dev), t_c.to(dev))
        ref = vw.view_from_flow(v_c.nets, v_c.renderer, st_c, fim_c, t_c)
        assert torch.allclose(tail.cpu(), ref, rtol=0, atol=1e-2)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
