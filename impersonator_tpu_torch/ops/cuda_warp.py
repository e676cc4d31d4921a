"""The half-precision bilinear warp: CUDA wrapper and its plain PyTorch
twin.

``csrc/warp_bilinear.cu`` (built and loaded by ``utils.native_build``)
replaces no TPU kernel: the JAX package's ``grid_sample`` and
``grid_sample_patched`` (``impersonator_tpu/ops/sampler.py``) are plain
jnp, and :func:`warp_bilinear_plain` is their arithmetic in PyTorch. The
kernel computes that arithmetic in one pass (the source says why and
what bounds it) and gives the twin's bits.

:func:`warp_bilinear` picks the route from what it is given: a CPU tensor
runs the twin; a CUDA tensor launches the kernel, also where autograd
records the call, whose gradients :func:`warp_bilinear_backward` then
computes in PyTorch with the twin's backward ops in the twin's order.
``warp_bilinear.launches`` counts kernel launches; a CPU call does not
count.
"""

from __future__ import annotations

import ctypes

import torch

from impersonator_tpu_torch.utils import native_build

# x dtypes the kernel takes, and its entry point for each
ENTRY = {torch.bfloat16: "warp_bilinear_bf16",
         torch.float16: "warp_bilinear_f16"}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# the entry points: (restype, argtypes)
SYMBOLS = {name: (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _L, _L, _L,
                       _L, _L, _L, _L, _P])
           for name in ENTRY.values()}
CHUNK = 32                  # the source's kChunk: channels a block
MAX_GRID_YZ = 65535         # CUDA's limit on a launch grid's y and z


def _check(x, grid):
    if x.dim() != 4 or grid.dim() != 4 or grid.shape[-1] != 2:
        raise ValueError(f"expected x (B, C, H, W) and grid (N, Ho, Wo, 2), "
                         f"got {tuple(x.shape)} and {tuple(grid.shape)}")
    if x.shape[0] not in (1, grid.shape[0]):
        raise ValueError(f"x's batch {x.shape[0]} is neither 1 nor the "
                         f"grid's {grid.shape[0]}")
    if x.device != grid.device:
        raise ValueError(f"tensors on {x.device} and {grid.device}")


def launch_args(x, grid):
    """(n, c, h, w, ho, wo, x's element strides (batch 0 for a batch-1
    source), the grid's (batch, row, column, between x and y)): the
    kernel's integer arguments."""
    n, ho, wo = grid.shape[0], grid.shape[1], grid.shape[2]
    _, c, h, w = x.shape
    sxb = x.stride(0) if x.shape[0] > 1 else 0
    return (n, c, h, w, ho, wo, sxb, *x.stride()[1:], *grid.stride())


def warp_bilinear(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """x (B, C, H, W) with B in {1, N}, any strides; grid (N, Ho, Wo, 2)
    float32 in [-1, 1], (x, y) order, any strides -> (N, C, Ho, Wo)
    contiguous in x's dtype, the JAX package's bilinear sample with
    align_corners=True and zero padding, one rounding per operation in
    x's dtype. On a CUDA device x is bf16 or fp16."""
    _check(x, grid)
    if x.device.type == "cpu":
        return warp_bilinear_plain(x, grid)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in ENTRY or grid.dtype != torch.float32:
        raise ValueError(f"the kernel takes a bf16 or fp16 x and a float32 "
                         f"grid, got {x.dtype} and {grid.dtype}")
    return _Warp.apply(x, grid)


warp_bilinear.launches = 0


def _launch(x, grid):
    args = launch_args(x, grid)
    n, c, _, _, ho, wo = args[:6]
    if n > MAX_GRID_YZ or -(-c // CHUNK) > MAX_GRID_YZ:
        raise ValueError(f"batch {n} or channels {c} beyond the kernel's grid")
    out = torch.empty((n, c, ho, wo), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = native_build.kernel("warp_bilinear.cu", SYMBOLS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, ENTRY[x.dtype])(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(grid.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), *args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"warp_bilinear launch failed: cudaError {err}")
    warp_bilinear.launches += 1
    return out


class _Warp(torch.autograd.Function):
    """The kernel forward; :func:`warp_bilinear_backward` backward. x is
    kept only when the grid's gradient needs its corners."""

    @staticmethod
    def forward(ctx, x, grid):
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, grid)
        ctx.x_shape = x.shape
        return _launch(x, grid)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        x, grid = ctx.saved_tensors
        return warp_bilinear_backward(grad, x, grid, ctx.x_shape,
                                      *ctx.needs_input_grad)


def _fractions(grid, h, w, dtype):
    """float32 corners x0, y0 and the lerp fractions tx, ty in ``dtype``,
    (N, Ho, Wo) each."""
    fx = (grid[..., 0] + 1.0) * 0.5 * (w - 1)
    fy = (grid[..., 1] + 1.0) * 0.5 * (h - 1)
    x0, y0 = fx.floor(), fy.floor()
    return x0, y0, (fx - x0).to(dtype), (fy - y0).to(dtype)


def _corners(grid, h, w, dtype):
    """tx, ty (N, 1, Ho, Wo) in ``dtype``; the four corners' validity in
    ``dtype`` and clamped flat offsets, (N, 4, Ho, Wo) each."""
    x0, y0, tx, ty = _fractions(grid, h, w, dtype)
    # the four corners (x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1,
    # y0 + 1); a corner outside the image counts 0
    xc = torch.stack([x0, x0 + 1, x0, x0 + 1], 1)
    yc = torch.stack([y0, y0, y0 + 1, y0 + 1], 1)
    valid = (xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1)
    lin = yc.clamp(0, h - 1).long() * w + xc.clamp(0, w - 1).long()
    return tx[:, None], ty[:, None], valid.to(dtype), lin


def warp_bilinear_plain(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """:func:`warp_bilinear` in plain PyTorch (any x dtype; autograd
    records it): float32 coordinates, one gather of the four corners, the
    lerp in x's dtype."""
    n = grid.shape[0]
    xs = x.expand(n, *x.shape[1:])
    _, c, h, w = xs.shape
    ho, wo = grid.shape[1], grid.shape[2]
    tx, ty, valid, lin = _corners(grid, h, w, x.dtype)
    flat = xs.reshape(n, c, h * w)          # a view: (h, w) stay adjacent
    idx = lin.reshape(n, 1, 4 * ho * wo).expand(n, c, 4 * ho * wo)
    v00, v01, v10, v11 = torch.gather(flat, 2, idx).reshape(
        n, c, 4, ho, wo).unbind(2)
    # JAX masks the corner values, (v · valid) · weight; masking the
    # (N, 1, Ho, Wo) weight instead, v · (weight · valid), rounds to the
    # same bf16 value and the same signed zero, with no full-size pass
    a, b = 1 - tx, 1 - ty
    top = v00 * (a * valid[:, 0:1]) + v01 * (tx * valid[:, 1:2])
    bot = v10 * (a * valid[:, 2:3]) + v11 * (tx * valid[:, 3:4])
    return top * b + bot * ty


def warp_bilinear_backward(grad, x, grid, x_shape, need_x, need_grid):
    """The gradients autograd takes through :func:`warp_bilinear_plain`,
    with its backward ops, summed in the order its engine sums them:
    grad (N, C, Ho, Wo) in x's dtype -> (x's gradient or None, the
    grid's or None). ``x`` is read only for the grid's gradient;
    ``x_shape`` is x's shape."""
    n, c, ho, wo = grad.shape
    h, w = x_shape[2], x_shape[3]
    gx = gtx = gty = None
    with torch.no_grad():
        tx, ty, valid, lin = _corners(grid, h, w, grad.dtype)
        idx = lin.reshape(n, 1, 4 * ho * wo).expand(n, c, 4 * ho * wo)
        a, b = 1 - tx, 1 - ty
        wts = (a * valid[:, 0:1], tx * valid[:, 1:2],
               a * valid[:, 2:3], tx * valid[:, 3:4])
        gtop, gbot = grad * b, grad * ty
        if need_x:
            # the four corners' gradients stacked and scattered back, then
            # summed over the batch a batch-1 x was expanded to
            gv = torch.stack([gtop * wts[0], gtop * wts[1], gbot * wts[2],
                              gbot * wts[3]], 2).reshape(n, c, 4 * ho * wo)
            gx = gv.new_zeros((n, c, h * w)).scatter_add_(2, idx, gv)
            gx = gx.reshape(n, c, h, w).sum_to_size(x_shape)
        if need_grid:
            flat = x.expand(n, *x.shape[1:]).reshape(n, c, h * w)
            v = torch.gather(flat, 2, idx).reshape(n, c, 4, ho, wo).unbind(2)
            top = v[0] * wts[0] + v[1] * wts[1]
            bot = v[2] * wts[2] + v[3] * wts[3]
            gw = [(g * vi).sum(1, keepdim=True)
                  for g, vi in zip((gtop, gtop, gbot, gbot), v)]
            # the engine reaches tx from tx · valid3, tx · valid1, then
            # 1 - tx (which it reaches from a · valid2, then a · valid0);
            # ty from bot · ty, then 1 - ty
            ga = gw[2] * valid[:, 2:3] + gw[0] * valid[:, 0:1]
            gtx = gw[3] * valid[:, 3:4] + gw[1] * valid[:, 1:2] + -ga
            gty = (grad * bot).sum(1, keepdim=True) + -(
                grad * top).sum(1, keepdim=True)
    if not need_grid:
        return gx, None
    # from tx and ty back to the grid: the twin's own small graph
    with torch.enable_grad():
        g = grid.detach().requires_grad_(True)
        _, _, ftx, fty = _fractions(g, h, w, grad.dtype)
        gg, = torch.autograd.grad((ftx, fty), g, (gtx[:, 0], gty[:, 0]))
    return gx, gg
