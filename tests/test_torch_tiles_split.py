"""The fixed-slot kernel's split of a tile across parts gives the serial
walk's bits.

``csrc/zbuffer_tiles.cu`` lists a tile's live slots in slot order, lets
each of k parts walk one contiguous share of the list with a strict <,
and merges the parts' minima by (z, slot). Its plain mirror
``ops.cuda_raster.zbuffer_tiles_split_plain`` does the same in PyTorch;
here it is held bit for bit (fim, and weights up to the sign of 0.0) to
the serial twin ``zbuffer_tiles_plain`` for k = 1..4, on the tiled
path's scenes and on a scene of exact depth ties whose equal faces sit on
both sides of every share boundary. The tie scene is also held to the
JAX package's ``zbuffer_tiles`` (interpret mode).
"""

import numpy as np
import pytest
import torch

from impersonator_tpu_torch.ops import cuda_raster as cr
from impersonator_tpu_torch.scenes import tie_scene

from test_torch_tiled import (FAR, NEAR, _jax_zbuffer_tiles, _scene,
                              _slots, _tiles_body_numpy)
from torch_threads import one_torch_thread  # noqa: F401

TIE_S, TIE_TILE = 32, 8


def _inputs(name, assets):
    """(packed, cand, valid) as tensors, s, tile."""
    if name == "tie":
        arrays, s, tile = tie_scene(TIE_S, TIE_TILE), TIE_S, TIE_TILE
    else:
        fv, s, tile, cap, span = _scene(name, assets)
        arrays = _slots(fv, s, tile, cap, span)
    return tuple(torch.from_numpy(a) for a in arrays), s, tile


@pytest.mark.parametrize("parts", [1, 2, 3, 4])
@pytest.mark.parametrize("name", ["body", "random", "oversized", "overflow",
                                  "tie"])
def test_split_matches_serial_twin(assets, name, parts):
    slots, s, tile = _inputs(name, assets)
    fim_s, wim_s = cr.zbuffer_tiles_plain(*slots, s, tile, NEAR, FAR)
    fim_k, wim_k = cr.zbuffer_tiles_split_plain(*slots, s, tile, NEAR, FAR,
                                                parts=parts)
    assert torch.equal(fim_k, fim_s)
    assert torch.equal(wim_k, wim_s)
    assert (fim_s >= 0).float().mean() > 0.05


def test_tie_scene_ties_cross_share_boundaries():
    """The tie scene does what it is for: at four parts, many pixels have
    their least z reached in two or more shares."""
    (packed, cand, valid), s, tile = _inputs("tie", None)
    live = cr._live_slots(packed, cand, valid)
    pos = torch.cumsum(live.int(), -1) - 1
    n = live.sum(-1, keepdim=True)
    share = sum((pos >= p * n // 4).int() for p in range(1, 4))
    zs = torch.stack([cr._tiles_minima(packed, cand, live & (share == p), s,
                                       tile, NEAR, FAR)[0]
                      for p in range(4)])
    least = zs.amin(0)
    tied = ((zs == least) & (least < FAR)).sum(0) >= 2
    assert tied.float().mean() > 0.1


def test_tie_scene_matches_pallas_kernel():
    """The serial twin on tie scenes against the Pallas body's float32
    arithmetic (numpy transliteration, bit for bit) and against JAX's
    zbuffer_tiles in interpret mode. XLA on the CPU contracts the body's
    multiply-adds into FMAs, which moves the depths of distinct coplanar
    triangles by an ulp (ROADMAP Queue 3), so JAX is held on a scene of
    one triangle under 40 face ids: there every tie is exact in any
    arithmetic, and fim must be the lowest live slot's face."""
    for shapes in (6, 1):
        packed, cand, valid = tie_scene(TIE_S, TIE_TILE, stray_ids=False,
                                        shapes=shapes)
        fim_t, wim_t = cr.zbuffer_tiles(
            *(torch.from_numpy(a) for a in (packed, cand, valid)), TIE_S,
            TIE_TILE, NEAR, FAR)
        fim_t, wim_t = fim_t.numpy(), wim_t.numpy()
        fim_n, wim_n = _tiles_body_numpy(packed, cand, valid, TIE_S,
                                         TIE_TILE)
        np.testing.assert_array_equal(fim_t, fim_n)
        np.testing.assert_array_equal(wim_t, wim_n)
        assert (fim_t >= 0).mean() > 0.05
    fim_j, _ = _jax_zbuffer_tiles(packed, cand, valid, TIE_S, TIE_TILE)
    np.testing.assert_array_equal(fim_t, fim_j)
