"""The z-buffer kernels: CUDA wrappers, their plain PyTorch twins and
the nvcc build.

Counterparts of the Pallas TPU kernels of
``impersonator_tpu/ops/pallas_raster.py``:

* :func:`zbuffer_bucket_rows` (:365) and :func:`zbuffer_bucket_flow`
  (:413) — ``csrc/zbuffer_bucket.cu``, one template with ``FLOW`` as its
  flag, over the bucket-sorted face table of
  ``ops.rasterizer._bucket_sort``;
* :func:`zbuffer_tiles` (:146) — ``csrc/zbuffer_tiles.cu``, the
  fixed-slot z-buffer over the per-tile candidate slots of
  ``ops.rasterizer._tiled_candidates``.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by nvcc at first use into
``_build/`` (one shared library per source, all sources at once) and
loaded with ctypes.

Bucket inputs (the layout ``_bucket_sort`` emits):

* ``verts``  (B, nf, 9) float32, bucket-sorted faces, xyz per vertex;
* ``fid``    (B, nf) int32, the original face id of each sorted face;
* ``srcxy``  (B, nf, 6) float32, source-image xy of each sorted face's
  vertices (flow kernel only);
* ``starts`` (B, T+2) int32 bucket starts: T = (s/tile)², entry T starts
  the oversized range and entry T+1 is the end sentinel.

Fixed-slot inputs: ``packed`` (B, nf, 9) float32 face verts in face-id
order, ``cand`` and ``valid`` (B, T, slots) int32 (a slot's face id, and
whether the slot is live).

Outputs are already in image layout with the raster's vertical flip
applied: fim (B, S, S) int32 (-1 on background) and wim (B, S, S, 3)
(0 on background) or the flow T (B, S, S, 2) (-2 on background).

Each wrapper launches its kernel for a CUDA tensor and raises if it
cannot; for a CPU tensor it runs the plain twin, which takes the same
inputs, walks the same candidates with the same float operations in the
same order and the same tie-break, and so returns the same bits.
``launches`` on each wrapper counts kernel launches.
:func:`bucket_warp_masks_plain` mirrors the bucket kernel's exact warp
cull (which faces each warp of a tile tests), and
:func:`zbuffer_tiles_split_plain` the fixed-slot kernel's split of a
tile's slots across teams of warps, for the tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C entry points of each source and their argument types
SYMBOLS = {
    "zbuffer_bucket.cu": {
        "zbuffer_bucket_rows": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                _F, _P],
        "zbuffer_bucket_flow": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _F, _F, _P],
    },
    "zbuffer_tiles.cu": {
        "zbuffer_tiles": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                          _P],
    },
}

# elements of one (batch, tile, pixel, candidate) block the plain twins
# evaluate at once
_PLAIN_BLOCK = 1 << 24

# the bucket kernel's warp footprint in pixels (csrc/zbuffer_bucket.cu)
WARP_W, WARP_H = 8, 4
# slack of the warp cull (zbuffer_bucket.cu says why these suffice):
# 32 units of 2^-24 relative to an edge function's magnitude bound, a
# floor far above any subnormal rounding, and the magnitude above which a
# face is never culled
_CULL_REL, _CULL_ABS, _CULL_MAX = 2.0 ** -19, 2.0 ** -100, 2.0 ** 40


class _Library:
    """The compiled kernels, built and loaded on first use."""

    def __init__(self):
        self.lib = None
        self.build_log = ""

    def get(self) -> SimpleNamespace:
        if self.lib is None:
            self.lib, self.build_log = _build_and_load()
        return self.lib


_LIBRARY = _Library()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build impersonator_tpu_torch's kernels")
    return str(path)


def _build_and_load():
    """Compile every csrc/*.cu not yet built (one nvcc each, all started
    together), load each library and bind its symbols."""
    sources = sorted(CSRC.glob("*.cu"))
    unknown = [src.name for src in sources if src.name not in SYMBOLS]
    if unknown:
        raise RuntimeError(f"no symbol table for {unknown}")
    BUILD_DIR.mkdir(exist_ok=True)
    outs, running = {}, []
    for src in sources:
        tag = hashlib.sha256(src.read_bytes()
                             + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"{src.stem}_{tag}.so"
        outs[src.name] = out
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            log = tmp.with_suffix(".log")
            with open(log, "w") as fh:
                proc = subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    stdout=fh, stderr=subprocess.STDOUT)
            running.append((src, tmp, out, log, proc))
    logs, failed = [], []
    for src, tmp, out, log_path, proc in running:
        proc.wait()
        log = log_path.read_text()
        log_path.unlink()
        logs.append(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    lib = SimpleNamespace()
    for name, out in outs.items():
        so = ctypes.CDLL(str(out))
        for sym, argtypes in SYMBOLS[name].items():
            fn = getattr(so, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            setattr(lib, sym, fn)
    return lib, "".join(logs)


def build() -> str:
    """Compile (if needed) and load the kernels; returns nvcc's output of
    this process's builds ('' when every library was already built)."""
    _LIBRARY.get()
    return _LIBRARY.build_log


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check(verts, fid, starts, srcxy, s, tile):
    dev = verts.device
    b, nf = verts.shape[0], verts.shape[1]
    g = s // tile
    if s % tile or tile not in (8, 16):
        raise ValueError(f"tile {tile} must be 8 or 16 and divide s={s}")
    want = [(verts, (b, nf, 9), torch.float32),
            (fid, (b, nf), torch.int32),
            (starts, (b, g * g + 2), torch.int32)]
    if srcxy is not None:
        want.append((srcxy, (b, nf, 6), torch.float32))
    for t, shape, dtype in want:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"expected {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    return b, nf


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def zbuffer_bucket_rows(verts, fid, starts, s: int, tile: int, span: int,
                        near: float, far: float):
    """Bucket z-buffer -> (fim (B,S,S) int32, wim (B,S,S,3) float32)."""
    b, nf = _check(verts, fid, starts, None, s, tile)
    if verts.device.type == "cpu":
        return zbuffer_bucket_rows_plain(verts, fid, starts, s, tile, span,
                                         near, far)
    if verts.device.type != "cuda":
        raise ValueError(f"no kernel for device {verts.device}")
    lib = _LIBRARY.get()
    fim = torch.empty((b, s, s), dtype=torch.int32, device=verts.device)
    wim = torch.empty((b, s, s, 3), dtype=torch.float32, device=verts.device)
    with torch.cuda.device(verts.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.zbuffer_bucket_rows(
            _ptr(verts), _ptr(fid), _ptr(starts), _ptr(fim), _ptr(wim), b,
            nf, s, tile, span, near, far, ctypes.c_void_p(stream))
    _raise_on(err, "zbuffer_bucket_rows")
    zbuffer_bucket_rows.launches += 1
    return fim, wim


def zbuffer_bucket_flow(verts, fid, srcxy, starts, s: int, tile: int,
                        span: int, near: float, far: float):
    """Fused bucket z-buffer + correspondence flow -> (fim (B,S,S) int32,
    T (B,S,S,2) float32, -2 on background)."""
    b, nf = _check(verts, fid, starts, srcxy, s, tile)
    if verts.device.type == "cpu":
        return zbuffer_bucket_flow_plain(verts, fid, srcxy, starts, s, tile,
                                         span, near, far)
    if verts.device.type != "cuda":
        raise ValueError(f"no kernel for device {verts.device}")
    lib = _LIBRARY.get()
    fim = torch.empty((b, s, s), dtype=torch.int32, device=verts.device)
    flow = torch.empty((b, s, s, 2), dtype=torch.float32, device=verts.device)
    with torch.cuda.device(verts.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.zbuffer_bucket_flow(
            _ptr(verts), _ptr(fid), _ptr(srcxy), _ptr(starts), _ptr(fim),
            _ptr(flow), b, nf, s, tile, span, near, far,
            ctypes.c_void_p(stream))
    _raise_on(err, "zbuffer_bucket_flow")
    zbuffer_bucket_flow.launches += 1
    return fim, flow


def _check_tiles(packed, cand, valid, s, tile):
    dev = packed.device
    b, nf = packed.shape[0], packed.shape[1]
    if s % tile:
        raise ValueError(f"tile {tile} must divide s={s}")
    g = s // tile
    slots = cand.shape[-1]
    for t, shape, dtype in [(packed, (b, nf, 9), torch.float32),
                            (cand, (b, g * g, slots), torch.int32),
                            (valid, (b, g * g, slots), torch.int32)]:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"expected {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    return b, nf, slots


def zbuffer_tiles(packed, cand, valid, s: int, tile: int, near: float,
                  far: float):
    """Fixed-slot z-buffer -> (fim (B,S,S) int32, wim (B,S,S,3) float32).
    The winner is the lexicographic (z, slot) minimum over live slots."""
    b, nf, slots = _check_tiles(packed, cand, valid, s, tile)
    if packed.device.type == "cpu":
        return zbuffer_tiles_plain(packed, cand, valid, s, tile, near, far)
    if packed.device.type != "cuda":
        raise ValueError(f"no kernel for device {packed.device}")
    lib = _LIBRARY.get()
    fim = torch.empty((b, s, s), dtype=torch.int32, device=packed.device)
    wim = torch.empty((b, s, s, 3), dtype=torch.float32, device=packed.device)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.zbuffer_tiles(
            _ptr(packed), _ptr(cand), _ptr(valid), _ptr(fim), _ptr(wim), b,
            nf, s, tile, slots, near, far, ctypes.c_void_p(stream))
    _raise_on(err, "zbuffer_tiles")
    zbuffer_tiles.launches += 1
    return fim, wim


zbuffer_bucket_rows.launches = 0
zbuffer_bucket_flow.launches = 0
zbuffer_tiles.launches = 0
KERNELS = (zbuffer_bucket_rows, zbuffer_bucket_flow, zbuffer_tiles)


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------


def _tile_candidates(starts, g, span):
    """Sorted-table positions of every tile's candidates, padded.

    Returns pos (B, T, M) int64 (-1 = padding), M the largest candidate
    count of any tile: the span row ranges, then the oversized range."""
    b = starts.shape[0]
    dev = starts.device
    n_tiles = g * g
    t = torch.arange(n_tiles, device=dev)
    ty, tx = t // g, t % g
    r0s, r1s = [], []
    for dy in range(span):
        row = ty - dy
        lo = (row * g + (tx - (span - 1)).clamp(min=0)).clamp(min=0)
        hi = (row * g + tx).clamp(min=0)
        r0 = starts[:, lo]
        r1 = torch.where(row >= 0, starts[:, hi + 1], r0)
        r0s.append(r0)
        r1s.append(r1)
    r0s.append(starts[:, n_tiles:n_tiles + 1].expand(b, n_tiles))
    r1s.append(starts[:, n_tiles + 1:n_tiles + 2].expand(b, n_tiles))
    r0 = torch.stack(r0s, -1).long()                   # (B, T, K)
    cnt = (torch.stack(r1s, -1).long() - r0).clamp(min=0)
    end = torch.cumsum(cnt, -1)
    m = int(end[..., -1].max())
    j = torch.arange(m, device=dev)
    pos = torch.full((b, n_tiles, m), -1, dtype=torch.long, device=dev)
    for k in range(span + 1):
        beg = (end[..., k] - cnt[..., k])[..., None]
        inside = (j >= beg) & (j < end[..., k:k + 1])
        pos = torch.where(inside, r0[..., k:k + 1] + (j - beg), pos)
    return pos


def _tile_pixels(s, tile, dev):
    """Pixel coordinates of every tile, (1, T, P, 1) each, row-major
    inside a tile: integer xi, yi and the pixel centres xp, yp."""
    g = s // tile
    t = torch.arange(g * g, device=dev)
    p = torch.arange(tile * tile, device=dev)
    yi = ((t // g)[:, None] * tile + p // tile).float()[None, :, :, None]
    xi = ((t % g)[:, None] * tile + p % tile).float()[None, :, :, None]
    sf = float(s)
    xp = (2.0 * xi + 1.0 - sf) / sf
    yp = (2.0 * yi + 1.0 - sf) / sf
    return xi, yi, xp, yp


def warp_of_pixel(tile, dev=None):
    """The bucket kernel's warp of each pixel of a tile (row-major), as
    (tile*tile,) int64: warps of WARP_W x WARP_H pixels, row-major."""
    p = torch.arange(tile * tile, device=dev)
    return (p // tile // WARP_H) * (tile // WARP_W) + (p % tile) // WARP_W


def bucket_warp_masks_plain(verts, starts, s: int, tile: int, span: int):
    """The bucket kernel's warp cull, in its float32 operation order: for
    each candidate of each tile, the bitmask of the tile's warps that the
    face may touch (bit w set = warp w tests it pixel by pixel). A face
    that fails the same test on the whole tile has no bit set.

    Returns (masks (B, T, M) int32, 0 on padding; pos (B, T, M), the
    candidates' sorted-table positions as :func:`_tile_candidates` gives
    them). Used by the tests and the chip check, never by a wrapper."""
    g = s // tile
    dev = verts.device
    pos = _tile_candidates(starts, g, span)
    bidx = torch.arange(verts.shape[0], device=dev)[:, None, None]
    d = verts[bidx, pos.clamp(min=0)]                    # (B, T, M, 9)
    fx, fy = d[..., 0::3], d[..., 1::3]                  # vertex k = [..., k]
    ex = torch.roll(fx, -1, -1) - fx                     # edge k: k -> k+1
    ey = torch.roll(fy, -1, -1) - fy
    sf = float(s)
    t = torch.arange(g * g, device=dev)
    x0, y0 = (t % g) * tile, (t // g) * tile

    def centre(i):                        # pixel index (T,) -> (1, T, 1, 1)
        return ((2.0 * i.float() + 1.0 - sf) / sf)[None, :, None, None]

    ymax = torch.maximum((centre(y0) - fy).abs(),
                         (centre(y0 + tile - 1) - fy).abs())
    xmax = torch.maximum((centre(x0) - fx).abs(),
                         (centre(x0 + tile - 1) - fx).abs())
    mag = ymax * ex.abs() + xmax * ey.abs()
    err = mag * _CULL_REL + _CULL_ABS
    cullable = ((mag < _CULL_MAX) & (ex.abs() < _CULL_MAX)
                & (ey.abs() < _CULL_MAX)).all(-1)

    def same_sign(p):
        q = torch.roll(p, -1, -1)
        return ((p > 0) & (q > 0)) | ((p < 0) & (q < 0))

    def pair_keeps(lam, t_a, t_b):
        """The sum of edges k and k+1 weighted by lam: is its max over two
        corners not below its slack?"""
        lam_j = torch.roll(lam, 1, -1)
        bound = lam * err + lam_j * torch.roll(err, -1, -1) + _CULL_ABS
        v_a = lam * t_a + lam_j * torch.roll(t_a, -1, -1)
        v_b = lam * t_b + lam_j * torch.roll(t_b, -1, -1)
        return ~(torch.maximum(v_a, v_b) < -bound)

    def rect_keeps(xl, xh, yl, yh):
        """Can a pixel centre of the rectangle [xl, xh] x [yl, yh] pass?"""
        ay_l, ay_h = (yl - fy) * ex, (yh - fy) * ex
        bx_l, bx_h = (xl - fx) * ey, (xh - fx) * ey
        t_ll, t_hl = ay_l - bx_l, ay_l - bx_h
        t_lh, t_hh = ay_h - bx_l, ay_h - bx_h
        top = torch.maximum(torch.maximum(t_ll, t_hl),
                            torch.maximum(t_lh, t_hh))
        keep = ~(top < -err)
        keep &= same_sign(ex) | pair_keeps(torch.roll(ex, -1, -1).abs(),
                                           t_ll, t_hl)
        keep &= same_sign(ey) | pair_keeps(torch.roll(ey, -1, -1).abs(),
                                           t_ll, t_lh)
        return keep.all(-1)

    in_tile = rect_keeps(centre(x0), centre(x0 + tile - 1), centre(y0),
                         centre(y0 + tile - 1))
    cols = tile // WARP_W
    masks = torch.zeros(pos.shape, dtype=torch.int32, device=dev)
    for w in range(cols * tile // WARP_H):
        xw, yw = x0 + WARP_W * (w % cols), y0 + WARP_H * (w // cols)
        keep = rect_keeps(centre(xw), centre(xw + WARP_W - 1), centre(yw),
                          centre(yw + WARP_H - 1))
        masks |= (~cullable | (in_tile & keep)).int() << w
    return torch.where(pos >= 0, masks, 0), pos


def _pair_weights(d, xi, yi, xp, yp, sf):
    """The per-(pixel, candidate) arithmetic both Pallas bodies share, in
    their float order: d (B, T, C, 9) gathered face verts, pixel
    coordinates (1, T, P, 1) -> the inside test at the pixel centre, the
    three clipped barycentric weights at the integer pixel (B, T, P, C),
    and the vertex depths (B, T, 1, C)."""
    f = [d[..., k][:, :, None, :] for k in range(9)]
    fx0, fy0, fz0, fx1, fy1, fz1, fx2, fy2, fz2 = f

    p0x = 0.5 * (fx0 * sf + sf - 1.0)
    p0y = 0.5 * (fy0 * sf + sf - 1.0)
    p1x = 0.5 * (fx1 * sf + sf - 1.0)
    p1y = 0.5 * (fy1 * sf + sf - 1.0)
    p2x = 0.5 * (fx2 * sf + sf - 1.0)
    p2y = 0.5 * (fy2 * sf + sf - 1.0)
    denom = (p2x * (p0y - p1y) + p0x * (p1y - p2y)
             + p1x * (p2y - p0y))
    rden = 1.0 / torch.where(denom == 0.0, 1.0, denom)

    t0 = (yp - fy0) * (fx1 - fx0) - (xp - fx0) * (fy1 - fy0)
    t1 = (yp - fy1) * (fx2 - fx1) - (xp - fx1) * (fy2 - fy1)
    t2 = (yp - fy2) * (fx0 - fx2) - (xp - fx2) * (fy0 - fy2)
    inside = (t0 >= 0) & (t1 >= 0) & (t2 >= 0)

    w0 = torch.clamp(((p1y - p2y) * rden) * xi
                     + ((p2x - p1x) * rden) * yi
                     + (p1x * p2y - p2x * p1y) * rden, 0.0, 1.0)
    w1 = torch.clamp(((p2y - p0y) * rden) * xi
                     + ((p0x - p2x) * rden) * yi
                     + (p2x * p0y - p0x * p2y) * rden, 0.0, 1.0)
    w2 = torch.clamp(((p0y - p1y) * rden) * xi
                     + ((p1x - p0x) * rden) * yi
                     + (p0x * p1y - p1x * p0y) * rden, 0.0, 1.0)
    return inside, w0, w1, w2, (fz0, fz1, fz2)


def _untile(a, s, tile):
    """(B, T, P[, C]) per-tile maps -> (B, S, S[, C]) image layout with
    the raster's vertical flip."""
    b, g = a.shape[0], s // tile
    a = a.reshape((b, g, g, tile, tile) + a.shape[3:])
    a = a.transpose(2, 3).reshape((b, s, s) + a.shape[5:])
    return a.flip(1).contiguous()


def _zbuffer_plain(verts, fid, srcxy, starts, s, tile, span, near, far):
    """Shared body of the plain twins; emits (fim, (B,S,S,C)) with C=3
    weights (srcxy None) or C=2 flow."""
    flow = srcxy is not None
    b = verts.shape[0]
    dev = verts.device
    g = s // tile
    n_tiles, npx = g * g, tile * tile
    pos = _tile_candidates(starts, g, span)
    m = pos.shape[-1]

    xi, yi, xp, yp = _tile_pixels(s, tile, dev)
    sf = float(s)

    bg = -2.0 if flow else 0.0
    best_z = torch.full((b, n_tiles, npx), far, device=dev)
    best_i = torch.full((b, n_tiles, npx), -1, dtype=torch.int32, device=dev)
    best = [torch.full((b, n_tiles, npx), bg, device=dev) for _ in range(2)]
    best.append(torch.zeros((b, n_tiles, npx), device=dev))

    bidx = torch.arange(b, device=dev)[:, None, None]
    chunk = max(1, _PLAIN_BLOCK // max(1, b * n_tiles * npx))
    for c0 in range(0, m, chunk):
        slot = pos[..., c0:c0 + chunk]                   # (B, T, C)
        ok = (slot >= 0)[:, :, None, :]
        slot = slot.clamp(min=0)
        d = verts[bidx, slot]                            # (B, T, C, 9)
        ids = fid[bidx, slot][:, :, None, :]             # (B, T, 1, C)
        inside, w0, w1, w2, (fz0, fz1, fz2) = _pair_weights(
            d, xi, yi, xp, yp, sf)
        wsum = w0 + w1 + w2
        rws = 1.0 / torch.where(wsum == 0.0, 1.0, wsum)
        w0, w1, w2 = w0 * rws, w1 * rws, w2 * rws
        inv_z = w0 * (1.0 / fz0) + w1 * (1.0 / fz1) + w2 * (1.0 / fz2)
        zp = 1.0 / inv_z
        valid = inside & ok & (zp > near) & (zp < far)
        zp = torch.where(valid, zp, far)

        # chunk winner: min z, then the lowest face id among exact ties
        lz = zp.amin(-1)
        at_min = (zp == lz[..., None]) & valid
        li_id = torch.where(at_min, ids, torch.iinfo(torch.int32).max
                            ).amin(-1)
        sel = at_min & (ids == li_id[..., None])

        def pick(v):
            return torch.where(sel, v, 0.0).sum(-1)

        better = (lz < far) & ((lz < best_z) | ((lz == best_z)
                                               & (best_i >= 0)
                                               & (li_id < best_i)))
        if flow:
            e = srcxy[bidx, slot]                        # (B, T, C, 6)
            sx = [e[..., k][:, :, None, :] for k in range(6)]
            vals = (w0 * sx[0] + w1 * sx[2] + w2 * sx[4],
                    w0 * sx[1] + w1 * sx[3] + w2 * sx[5])
        else:
            vals = (w0, w1, w2)
        for k, v in enumerate(vals):
            best[k] = torch.where(better, pick(v), best[k])
        best_i = torch.where(better, li_id, best_i)
        best_z = torch.where(better, lz, best_z)

    out = torch.stack(best[:2] if flow else best, -1)
    return _untile(best_i, s, tile), _untile(out, s, tile)


def zbuffer_bucket_rows_plain(verts, fid, starts, s: int, tile: int,
                              span: int, near: float, far: float):
    """Plain PyTorch twin of :func:`zbuffer_bucket_rows`."""
    return _zbuffer_plain(verts, fid, None, starts, s, tile, span, near, far)


def zbuffer_bucket_flow_plain(verts, fid, srcxy, starts, s: int, tile: int,
                              span: int, near: float, far: float):
    """Plain PyTorch twin of :func:`zbuffer_bucket_flow`."""
    return _zbuffer_plain(verts, fid, srcxy, starts, s, tile, span, near, far)


def _live_slots(packed, cand, valid):
    nf = packed.shape[1]
    return (valid != 0) & (cand >= 0) & (cand < nf)


def zbuffer_tiles_plain(packed, cand, valid, s: int, tile: int, near: float,
                        far: float):
    """Plain PyTorch twin of :func:`zbuffer_tiles`: the Pallas body's
    arithmetic (divisions by wsum and by each vertex depth) over every
    slot up to the last live one, chunk by chunk, lowest slot on ties."""
    _, _, best_i, best_w = _tiles_minima(packed, cand,
                                         _live_slots(packed, cand, valid), s,
                                         tile, near, far)
    return _untile(best_i, s, tile), _untile(best_w, s, tile)


def zbuffer_tiles_split_plain(packed, cand, valid, s: int, tile: int,
                              near: float, far: float, parts: int = 4):
    """The split of :func:`zbuffer_tiles`' kernel in plain PyTorch, for the
    tests: each tile's live slots, listed in slot order, are walked in
    ``parts`` contiguous shares (share p from position p·n//parts of the
    tile's n, as the kernel cuts a dense tile's list among its teams),
    and the shares' minima are merged by (z, slot). Returns the serial
    twin's bits."""
    live = _live_slots(packed, cand, valid)
    pos = torch.cumsum(live.int(), -1) - 1          # place in the list
    n = live.sum(-1, keepdim=True)
    share = torch.zeros_like(pos)
    for p in range(1, parts):
        share += (pos >= torch.div(p * n, parts, rounding_mode="floor")).int()
    best = None
    for p in range(parts):
        got = _tiles_minima(packed, cand, live & (share == p), s, tile, near,
                            far)
        if best is None:
            best = got
            continue
        z, sl, i, w = got
        bz, bs, bi, bw = best
        better = (z < bz) | ((z == bz) & (sl < bs))
        best = (torch.where(better, z, bz), torch.where(better, sl, bs),
                torch.where(better, i, bi),
                torch.where(better[..., None], w, bw))
    return _untile(best[2], s, tile), _untile(best[3], s, tile)


def _tiles_minima(packed, cand, live, s, tile, near, far):
    """Each pixel's (z, slot) minimum over the slots ``live`` marks, in
    tile layout: (z (B, T, P) with far where none hits, slot (B, T, P)
    with int32 max where none hits, face id (B, T, P) int32 (-1), weights
    (B, T, P, 3)). Slots are walked in order, chunk by chunk, the lowest
    slot keeping equal z."""
    b, nf = packed.shape[0], packed.shape[1]
    dev = packed.device
    g = s // tile
    n_tiles, npx = g * g, tile * tile
    used = torch.nonzero(live.reshape(-1, live.shape[-1]).any(0))
    m = int(used.max()) + 1 if used.numel() else 0
    xi, yi, xp, yp = _tile_pixels(s, tile, dev)
    sf = float(s)

    big = torch.iinfo(torch.int32).max
    best_z = torch.full((b, n_tiles, npx), far, device=dev)
    best_s = torch.full((b, n_tiles, npx), big, dtype=torch.int32, device=dev)
    best_i = torch.full((b, n_tiles, npx), -1, dtype=torch.int32, device=dev)
    best_w = torch.zeros((b, n_tiles, npx, 3), device=dev)
    bidx = torch.arange(b, device=dev)[:, None, None]
    chunk = max(1, _PLAIN_BLOCK // max(1, b * n_tiles * npx))
    for c0 in range(0, m, chunk):
        ids = cand[..., c0:c0 + chunk]                  # (B, T, C)
        ok = live[..., c0:c0 + chunk][:, :, None, :]
        d = packed[bidx, ids.clamp(0, nf - 1).long()]   # (B, T, C, 9)
        inside, w0, w1, w2, (fz0, fz1, fz2) = _pair_weights(
            d, xi, yi, xp, yp, sf)
        wsum = w0 + w1 + w2
        wsum = torch.where(wsum == 0.0, 1.0, wsum)
        w0, w1, w2 = w0 / wsum, w1 / wsum, w2 / wsum
        inv_z = w0 / fz0 + w1 / fz1 + w2 / fz2
        zp = 1.0 / inv_z
        valid_px = inside & ok & (zp > near) & (zp < far)
        zp = torch.where(valid_px, zp, far)

        # chunk winner: min z, then the lowest slot
        lz = zp.amin(-1)
        lane = torch.arange(zp.shape[-1], device=dev)
        li = torch.where(zp == lz[..., None], lane, big).amin(-1)
        sel = lane == li[..., None]

        def pick(v):
            return torch.where(sel, v, 0.0).sum(-1)

        lid = torch.where(sel, ids[:, :, None, :], 0).sum(-1).int()
        better = lz < best_z
        best_w = torch.where(better[..., None],
                             torch.stack([pick(w0), pick(w1), pick(w2)], -1),
                             best_w)
        best_i = torch.where(better, lid, best_i)
        best_s = torch.where(better, (li + c0).int(), best_s)
        best_z = torch.where(better, lz, best_z)
    return best_z, best_s, best_i, best_w
