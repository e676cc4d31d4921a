"""The half-precision bilinear warp (``ops/cuda_warp.py``,
``csrc/warp_bilinear.cu``) against its plain twin.

On the CPU: a CPU tensor never reaches the kernel or its counter, the
strides ``launch_args`` hands the kernel address the tensors as the
callers lay them out, and the kernel's autograd Function gives the
twin's gradients bit for bit. Marked ``cuda`` (skipped without a card):
the kernel gives the twin's bits, compared as int16, at the five warps
of an imitation batch of 16 at 256², also where autograd records the
call, and the counts. This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_warp.py
"""

import numpy as np
import pytest
import torch

from impersonator_tpu_torch.ops import cuda_warp
from impersonator_tpu_torch.ops import sampler
from impersonator_tpu_torch.utils import native_build
from torch_threads import one_torch_thread  # noqa: F401

N = 16
# (channels, size) of an imitation batch's five warps at 256²: the source
# image; the encoder's three stages; the six residual blocks' outputs
WARPS = [(3, 256), (128, 128), (256, 64), (512, 32), (3072, 32)]
DTYPES = [torch.bfloat16, torch.float16]


def _grid(n, h, w, seed, device="cpu"):
    """(n, h, w, 2) float32: flows in [-1.1, 1.1], background rows (-2),
    a band exactly on -1 / 1 (the first and last row and column) and one
    far beyond ±1."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(-1.1, 1.1, (n, h, w, 2)).astype(np.float32)
    g[0, : max(1, h // 8)] = -2.0
    band = slice(h // 4, h // 4 + max(1, h // 16))
    g[:, band, :, 0] = rng.choice([-1.0, 1.0], (n, g[:, band].shape[1], w))
    g[:, band, :, 1] = rng.choice([-1.0, 1.0], (n, g[:, band].shape[1], w))
    g[-1, -1, :] = rng.uniform(-40.0, 40.0, (w, 2))
    return torch.from_numpy(g).to(device)


def _source(b, c, h, w, dtype, seed, device="cpu"):
    """(b, c, h, w) values of both signs, with ±inf and zeros of both
    signs on the border the clamped reads of the background hit."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, c, h, w), generator=gen)
    x[:, ::3, 0, 0] = float("inf")
    x[:, 1::3, 0, 0] = -0.0
    x[:, 2::3, 0, -1] = float("-inf")
    x[:, :, -1, -1] = -0.0
    return x.to(dtype).to(device)


def _bits(t):
    return t.contiguous().view(torch.int16)


# -- the CPU ---------------------------------------------------------------

LAYOUTS = ["batch1", "batchN", "nhwc_x", "planar_grid", "resized_grid"]


def _layout(layout, dtype, n=3, c=5, h=9, w=12):
    """x and grid as each caller sends them: the batch-1 source expanded
    (batch stride 0), a batch-N source, the NHWC wrapper's permuted x, a
    grid permuted from (N, 2, Ho, Wo) and resize_flow's grid."""
    grid = _grid(n, 7, 10, seed=1)
    x = _source(1 if layout != "batchN" else n, c, h, w, dtype, seed=2)
    if layout == "nhwc_x":
        x = x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    if layout == "planar_grid":
        grid = grid.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    if layout == "resized_grid":
        grid = sampler.resize_flow(_grid(n, 5, 6, seed=3), h, w)
    return x, grid


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_launch_args_address_the_tensors(layout, dtype):
    """The kernel reads x at b·sxb + c·sxc + y·sxh + x·sxw and the grid at
    n·sgn + y·sgh + x·sgw + k·sgk from their first elements: those
    strides, over each tensor's storage, give x expanded over the grid's
    batch and the grid, without a copy."""
    x, grid = _layout(layout, dtype)
    n, c, h, w, ho, wo, sxb, sxc, sxh, sxw, sgn, sgh, sgw, sgk = \
        cuda_warp.launch_args(x, grid)
    assert (n, c, h, w, ho, wo) == (*grid.shape[:1], *x.shape[1:],
                                    *grid.shape[1:3])
    assert (sxb == 0) == (layout != "batchN")
    xs = torch.as_strided(x, (n, c, h, w), (sxb, sxc, sxh, sxw),
                          x.storage_offset())
    gs = torch.as_strided(grid, (n, ho, wo, 2), (sgn, sgh, sgw, sgk),
                          grid.storage_offset())
    assert torch.equal(_bits(xs), _bits(x.expand(n, -1, -1, -1)))
    assert torch.equal(gs, grid)


@pytest.mark.parametrize("wants", ["x", "grid", "both"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_backward_equals_the_twins_autograd(monkeypatch, layout, dtype,
                                            wants):
    """The kernel's autograd Function, its forward standing in by the
    twin's bits, against autograd through the twin: the same output and
    the same gradients of x and of the grid, bit for bit (on the CPU the
    scatter-add runs in one order)."""
    monkeypatch.setattr(cuda_warp, "_launch", lambda x, grid: (
        cuda_warp.warp_bilinear_plain(x.detach(), grid.detach())))
    x0, grid0 = _layout(layout, dtype)
    x0 = x0.nan_to_num(posinf=3.0, neginf=-3.0)
    grads = []
    for fn in (cuda_warp._Warp.apply, cuda_warp.warp_bilinear_plain):
        x = x0.detach().requires_grad_(wants != "grid")
        grid = grid0.detach().requires_grad_(wants != "x")
        out = fn(x, grid)
        w = torch.linspace(-1, 1, out.numel()).reshape(out.shape)
        (out.float() * w).sum().backward()
        grads.append((out.detach(), x.grad, grid.grad))
    for got, want in zip(*grads):
        assert (got is None) == (want is None)
        if got is not None:
            assert got.shape == want.shape
            bits = _bits if got.dtype != torch.float32 else (
                lambda t: t.contiguous().view(torch.int32))
            assert torch.equal(bits(got), bits(want))


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    """bf16 and fp16 CPU calls, with and without autograd recording them,
    run the twin: the library is never loaded and the counter does not
    move."""
    def no_library(source, table):
        raise AssertionError("a CPU call reached the kernel's library")

    monkeypatch.setattr(native_build, "kernel", no_library)
    before = cuda_warp.warp_bilinear.launches
    grid = _grid(2, 6, 6, seed=4)
    for dtype in DTYPES:
        x = _source(1, 4, 8, 8, dtype, seed=5)
        out = sampler.grid_sample_nchw(x, grid)
        assert torch.equal(_bits(out),
                           _bits(cuda_warp.warp_bilinear_plain(x, grid)))
        xg = x.clone().requires_grad_(True)
        sampler.grid_sample_nchw(xg, grid).float().sum().backward()
        assert xg.grad is not None
        nhwc = sampler.grid_sample(x.permute(0, 2, 3, 1), grid)
        assert torch.equal(_bits(nhwc.permute(0, 3, 1, 2)), _bits(out))
    assert cuda_warp.warp_bilinear.launches == before


# -- the card ----------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("src_batch", [1, N])
@pytest.mark.parametrize("c,s", WARPS)
def test_kernel_equals_the_twin_bit_for_bit(card, c, s, src_batch, dtype):
    """The kernel against the twin at an imitation batch's warps (N = 16):
    background flow, the last row and column, flows beyond ±1, ±inf and
    signed zeros where the background's clamped reads land."""
    x = _source(src_batch, c, s, s, dtype, seed=c + s, device=card)
    grid = _grid(N, s, s, seed=c * s, device=card)
    before = cuda_warp.warp_bilinear.launches
    got = cuda_warp.warp_bilinear(x, grid)
    want = cuda_warp.warp_bilinear_plain(x, grid)
    torch.cuda.synchronize()
    assert cuda_warp.warp_bilinear.launches == before + 1
    assert got.shape == (N, c, s, s) and got.is_contiguous()
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_reads_permuted_views(card, dtype):
    """resize_flow's grid (the generator's warps), a grid permuted from
    (N, 2, Ho, Wo) and the NHWC wrapper's permuted x, read through their
    strides: the twin's bits, and one launch each."""
    x = _source(1, 256, 64, 64, dtype, seed=6, device=card)
    resized = sampler.resize_flow(_grid(N, 256, 256, seed=7, device=card),
                                  64, 64)
    planar = resized.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert not planar.is_contiguous()
    before = cuda_warp.warp_bilinear.launches
    for grid in (resized, planar):
        got = sampler.grid_sample_nchw(x, grid)
        assert torch.equal(_bits(got),
                           _bits(cuda_warp.warp_bilinear_plain(x, grid)))
    x_nhwc = _source(N, 64, 64, 3, dtype, seed=8, device=card)
    g = _grid(N, 48, 40, seed=9, device=card)
    got = sampler.grid_sample(x_nhwc, g)
    want = cuda_warp.warp_bilinear_plain(x_nhwc.permute(0, 3, 1, 2), g)
    assert torch.equal(_bits(got.permute(0, 3, 1, 2)), _bits(want))
    torch.cuda.synchronize()
    assert cuda_warp.warp_bilinear.launches == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("src_batch", [1, N])
def test_recorded_calls_launch_the_kernel(card, src_batch):
    """Grad mode on and x, or x and the grid, requiring grad: the kernel
    runs once, and the output and the gradients are the twin's own under
    autograd (a grid of whole-pixel shifts: every source value meets one
    nonzero weight, so the scatter-add's order cannot round)."""
    s = 32
    x = _source(src_batch, 64, s, s, torch.bfloat16, seed=10, device=card)
    x = x.nan_to_num(posinf=1.0, neginf=-1.0)
    rng = np.random.default_rng(11)
    shift = rng.integers(-3, 4, (N, 1, 1, 2)).astype(np.float32)
    pix = np.stack(np.meshgrid(np.arange(s), np.arange(s), indexing="xy"),
                   -1)[None].astype(np.float32)
    grid = torch.from_numpy((pix + shift) / (s - 1) * 2 - 1).to(card)
    for grid_grad in (False, True):
        grads = []
        for fn in (sampler.grid_sample_nchw, cuda_warp.warp_bilinear_plain):
            xg = x.clone().requires_grad_(True)
            gg = grid.clone().requires_grad_(grid_grad)
            launches = cuda_warp.warp_bilinear.launches
            out = fn(xg, gg)
            (out.float() * torch.linspace(-1, 1, out.numel(), device=card)
             .reshape(out.shape)).sum().backward()
            if fn is sampler.grid_sample_nchw:
                assert cuda_warp.warp_bilinear.launches == launches + 1
            grads.append((out.detach(), xg.grad, gg.grad))
        for a, b in zip(*grads):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a, b)


@pytest.mark.cuda
def test_an_imitation_batch_launches_five_warps(card):
    """One batch of 16 through Imitator.inference_by_smpls in bf16 (64²,
    n_down 3): the source image's warp and the generator's four, all
    through the kernel."""
    from impersonator_tpu_torch.assets import synthetic_assets
    from impersonator_tpu_torch.config import TestConfig
    from impersonator_tpu_torch.tasks.imitator import Imitator
    cfg = TestConfig(image_size=64, repeat_num=2, compute_dtype="bfloat16")
    imitator = Imitator(cfg, synthetic_assets(), device=card)
    rng = np.random.default_rng(12)
    src = rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32)
    theta = np.zeros((N, 85), np.float32)
    theta[:, 0] = 0.9
    theta[:, 3:75] = rng.normal(0, 0.05, (N, 72))
    imitator.personalize(src, theta[0])
    launches = cuda_warp.warp_bilinear.launches
    out = imitator.inference_by_smpls(theta, batch=N)
    torch.cuda.synchronize()
    assert out.shape == (N, 64, 64, 3) and torch.isfinite(out).all()
    assert cuda_warp.warp_bilinear.launches == launches + 5
