"""Bilinear warping and resizing with the reference's torch-1.2 semantics
(``align_corners=True``, zero padding), torch port of
``impersonator_tpu/ops/sampler.py``.

``grid_sample_patched`` (:69-131) has no port of its own: it is a TPU
row-gather layout of the same arithmetic as ``grid_sample``, and
:func:`grid_sample_nchw` computes that arithmetic."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from impersonator_tpu_torch.ops.cuda_warp import warp_bilinear
from impersonator_tpu_torch.utils.profiling import span


def grid_sample_nchw(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """x (B, C, H, W) with B in {1, N}; grid (N, Ho, Wo, 2) float32 in
    [-1, 1], (x, y) order -> (N, C, Ho, Wo) in x's dtype. A batch-1 x is
    expanded over the grid's batch, not copied. Any corner outside the
    image reads 0, so the background flow -2 samples exactly 0.

    A float32 x goes through F.grid_sample. A half-precision x follows
    the JAX package's arithmetic, one rounding per operation: the lerp
    weights are cast to x's dtype and the interpolation runs in it
    (:func:`ops.cuda_warp.warp_bilinear`: the hand-written kernel on a
    CUDA device, its plain twin on the CPU; both give the same bits and
    the same gradients)."""
    with span("warp"):
        if x.dtype == grid.dtype:
            return F.grid_sample(x.expand(grid.shape[0], *x.shape[1:]), grid,
                                 mode="bilinear", padding_mode="zeros",
                                 align_corners=True)
        return warp_bilinear(x, grid)


def grid_sample(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """NHWC :func:`grid_sample_nchw`: x (B, H, W, C) -> (N, Ho, Wo, C)."""
    return grid_sample_nchw(x.permute(0, 3, 1, 2), grid).permute(0, 2, 3, 1)


def _interp_axis(arr: torch.Tensor, coords: torch.Tensor,
                 axis: int) -> torch.Tensor:
    """Linear interpolation of ``arr`` along ``axis`` at float32 source
    coordinates already inside [0, n - 1]: ``a * (1 - t) + b * t`` in
    arr's dtype (the JAX package's order)."""
    lo = coords.floor().long()
    hi = (lo + 1).clamp(max=arr.shape[axis] - 1)
    shape = [1] * arr.ndim
    shape[axis] = coords.shape[0]
    t = (coords - lo).reshape(shape).to(arr.dtype)
    a = arr.index_select(axis, lo)
    b = arr.index_select(axis, hi)
    return a * (1 - t) + b * t


def resize_bilinear_align(x: torch.Tensor, out_h: int,
                          out_w: int) -> torch.Tensor:
    """Bilinear resize with align_corners=True, NHWC: (B, H, W, C) ->
    (B, out_h, out_w, C), rows first, then columns."""
    h, w = x.shape[1], x.shape[2]
    if (h, w) == (out_h, out_w):
        return x

    def coords(n_in, n_out):
        if n_out == 1:
            return torch.zeros(1, dtype=torch.float32, device=x.device)
        return torch.arange(n_out, dtype=torch.float32,
                            device=x.device) * ((n_in - 1) / (n_out - 1))

    return _interp_axis(_interp_axis(x, coords(h, out_h), 1),
                        coords(w, out_w), 2)


def resize_bilinear_torch(x: torch.Tensor, out_h: int,
                          out_w: int) -> torch.Tensor:
    """Bilinear resize with align_corners=False (half-pixel centres, edge
    samples clamped, no antialiasing), NHWC: (B, H, W, C) -> (B, out_h,
    out_w, C), rows first, then columns (``ops/sampler.py:168`` of the
    JAX package; the metric nets' preprocess at 299², 160², 224² and
    112×96)."""
    h, w = x.shape[1], x.shape[2]
    if (h, w) == (out_h, out_w):
        return x

    def coords(n_in, n_out):
        src = (torch.arange(n_out, dtype=torch.float32, device=x.device)
               + 0.5) * (n_in / n_out) - 0.5
        return src.clamp(0.0, n_in - 1)

    return _interp_axis(_interp_axis(x, coords(h, out_h), 1),
                        coords(w, out_w), 2)


def resize_flow(t: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize a flow T (B, H, W, 2) to (B, out_h, out_w, 2): bilinear with
    align_corners=True; values are positions in [-1, 1], so no rescale."""
    if tuple(t.shape[1:3]) == (out_h, out_w):
        return t
    out = F.interpolate(t.permute(0, 3, 1, 2), size=(out_h, out_w),
                        mode="bilinear", align_corners=True)
    return out.permute(0, 2, 3, 1)

def warp_feature(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The Liquid Warping Block's warp: x (B, H, W, C) sampled at the
    flow T (B, Ho, Wo, 2) resized to x's (H, W)."""
    return grid_sample(x, resize_flow(t, x.shape[1], x.shape[2]))
