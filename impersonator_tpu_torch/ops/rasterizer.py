"""SMPL mesh rasterizer: face-index map (fim) + barycentric weights (wim)
or the fused correspondence flow. Torch port of
``impersonator_tpu/ops/rasterizer.py``.

* :func:`project_to_raster_space` (:47) — projection + face gather;
* :func:`rasterize_fim_wim` (:99) — brute z-buffer over every
  (pixel, face) pair, kept as the oracle and for images that do not tile;
* :func:`_bucket_sort` (:384) — cull, bucket by top-left tile, one fused
  ``(key << shift) | fid`` int32 sort, bucket starts;
* :func:`rasterize_fim_wim_bucket` (:329) and
  :func:`rasterize_flow_bucket` (:470) — the work-efficient path over the
  sorted table, through the kernels of :mod:`.cuda_raster`;
* :func:`rasterize_fim_wim_tiled` (:544) — the fixed-slot path: up to
  ``cap`` candidates per tile from one ``(tile·nf + fid)`` pair sort,
  plus 16 oversized-face slots, through ``cuda_raster.zbuffer_tiles``;
  :func:`raster_tile_stats` (:251) counts what its cap drops;
* :func:`render_silhouette` and :func:`depth_from_fim_wim` (:220-248) —
  the coverage mask and the perspective depth of given raster products.

The rasterizer is non-differentiable; callers run it under no_grad.
Semantics (cull test, pixel-centre inside test, clipped renormalised
barycentrics, perspective z, lowest face id on ties, vertical flip) are
those of the JAX package, which mirrors the reference CUDA kernel.
"""

from __future__ import annotations

import torch

from impersonator_tpu_torch.ops import cuda_raster
from impersonator_tpu_torch.ops.projection import (
    DEFAULT_EYE_Z, look_at_on_axis, orthographic_proj_withz_idrot)

DEFAULT_NEAR = 0.1
DEFAULT_FAR = 25.0
_BRUTE_CHUNK = 256  # faces per step of the brute z-buffer


def project_to_raster_space(verts, cam, faces,
                            eye_z_value: float = DEFAULT_EYE_Z):
    """verts (B, nv, 3), cam (B, 3), faces (nf, 3) -> face_verts
    (B, nf, 3, 3): weak-perspective projection, y flipped into image
    coordinates, the on-axis look_at shift, then the per-face gather."""
    proj = orthographic_proj_withz_idrot(verts, cam)
    flip = torch.tensor([1.0, -1.0, 1.0], dtype=proj.dtype,
                        device=proj.device)
    proj = look_at_on_axis(proj * flip, eye_z_value)
    return proj[:, faces]


def _face_front(xv, yv):
    """Front-facing test on (..., 3) vertex coordinates (backface cull)."""
    return ((yv[..., 2] - yv[..., 0]) * (xv[..., 1] - xv[..., 0])
            >= (yv[..., 1] - yv[..., 0]) * (xv[..., 2] - xv[..., 0]))


@torch.no_grad()
def rasterize_fim_wim(face_verts, image_size: int = 256,
                      near: float = DEFAULT_NEAR, far: float = DEFAULT_FAR):
    """Brute z-buffer: every pixel against every face, in face chunks.

    face_verts (B, nf, 3, 3) -> fim (B, S, S) int32 (-1 background),
    wim (B, S, S, 3) float32 (0 background)."""
    fv = face_verts.float()
    b, nf = fv.shape[0], fv.shape[1]
    dev = fv.device
    s = image_size
    sf = float(s)
    xv, yv, zv = fv[..., 0], fv[..., 1], fv[..., 2]      # (B, nf, 3)
    front = _face_front(xv, yv)
    px = 0.5 * (xv * sf + sf - 1.0)
    py = 0.5 * (yv * sf + sf - 1.0)
    p0x, p1x, p2x = px.unbind(-1)
    p0y, p1y, p2y = py.unbind(-1)
    denom = p2x * (p0y - p1y) + p0x * (p1y - p2y) + p1x * (p2y - p0y)
    denom = torch.where(denom == 0.0, 1.0, denom)
    inv = torch.stack([
        torch.stack([p1y - p2y, p2x - p1x, p1x * p2y - p2x * p1y], -1),
        torch.stack([p2y - p0y, p0x - p2x, p2x * p0y - p0x * p2y], -1),
        torch.stack([p0y - p1y, p1x - p0x, p0x * p1y - p1x * p0y], -1),
    ], -2) / denom[..., None, None]                      # (B, nf, 3, 3)

    ar = torch.arange(s, dtype=torch.float32, device=dev)
    yif, xif = torch.meshgrid(ar, ar, indexing="ij")
    xif = xif.reshape(1, -1, 1)                          # (1, P, 1)
    yif = yif.reshape(1, -1, 1)
    xp = (2.0 * xif + 1.0 - sf) / sf
    yp = (2.0 * yif + 1.0 - sf) / sf

    best_z = torch.full((b, s * s), far, device=dev)
    best_i = torch.full((b, s * s), -1, dtype=torch.int32, device=dev)
    best_w = torch.zeros((b, s * s, 3), device=dev)
    for c0 in range(0, nf, _BRUTE_CHUNK):
        sl = slice(c0, min(c0 + _BRUTE_CHUNK, nf))

        def row(a):
            return a[:, None, sl]                        # (B, 1, C)

        fx0, fx1, fx2 = (row(xv[..., k]) for k in range(3))
        fy0, fy1, fy2 = (row(yv[..., k]) for k in range(3))
        t0 = (yp - fy0) * (fx1 - fx0) - (xp - fx0) * (fy1 - fy0)
        t1 = (yp - fy1) * (fx2 - fx1) - (xp - fx1) * (fy2 - fy1)
        t2 = (yp - fy2) * (fx0 - fx2) - (xp - fx2) * (fy0 - fy2)
        inside = (t0 >= 0) & (t1 >= 0) & (t2 >= 0)
        ws = [(row(inv[..., k, 0]) * xif + row(inv[..., k, 1]) * yif
               + row(inv[..., k, 2])).clamp(0.0, 1.0) for k in range(3)]
        wsum = ws[0] + ws[1] + ws[2]
        wsum = torch.where(wsum == 0.0, 1.0, wsum)
        w0, w1, w2 = ws[0] / wsum, ws[1] / wsum, ws[2] / wsum
        inv_z = (w0 / row(zv[..., 0]) + w1 / row(zv[..., 1])
                 + w2 / row(zv[..., 2]))
        zp = 1.0 / inv_z
        valid = inside & row(front) & (zp > near) & (zp < far)
        zp = torch.where(valid, zp, far)
        # argmin takes the first (lowest face id) of equal minima
        local_i = zp.argmin(-1)                          # (B, P)
        local_z = zp.gather(-1, local_i[..., None])[..., 0]
        lw = torch.stack([w0, w1, w2], -1)               # (B, P, C, 3)
        local_w = lw.gather(2, local_i[..., None, None].expand(
            b, s * s, 1, 3))[:, :, 0]
        better = local_z < best_z
        best_w = torch.where(better[..., None], local_w, best_w)
        best_i = torch.where(better, (local_i + c0).int(), best_i)
        best_z = torch.where(better, local_z, best_z)
    fim = best_i.reshape(b, s, s).flip(1)
    wim = best_w.reshape(b, s, s, 3).flip(1)
    return fim, wim


def _pixel_bbox(xv, yv, s: int):
    """Faces' integer pixel bbox from their (..., 3) vertex x and y: the
    first and last pixel index whose centre lies within the vertices'
    extent, (xi0, xi1, yi0, yi1) as floats."""
    def to_pix(v):
        return (v * s + s - 1.0) * 0.5

    return (torch.ceil(to_pix(xv.amin(-1))), torch.floor(to_pix(xv.amax(-1))),
            torch.ceil(to_pix(yv.amin(-1))), torch.floor(to_pix(yv.amax(-1))))


def _cull_and_tiles(face_verts, s: int, tile: int, far: float):
    """Per face (B, nf): whether it can cover a pixel (front-facing, in
    front of far, its pixel-centre bbox on screen), and the tile range
    of that bbox, clamped to the grid: (base, tx0, tx1, ty0, ty1)."""
    g = s // tile
    xv, yv, zv = face_verts[..., 0], face_verts[..., 1], face_verts[..., 2]
    front = _face_front(xv, yv)
    xi0, xi1, yi0, yi1 = (v.int() for v in _pixel_bbox(xv, yv, s))
    on_screen = ((xi0 <= xi1) & (yi0 <= yi1) & (xi1 >= 0) & (xi0 < s)
                 & (yi1 >= 0) & (yi0 < s))
    base = front & (zv.amin(2) < far) & on_screen

    def to_tile(v):
        return torch.div(v, tile, rounding_mode="floor").clamp(0, g - 1)

    return base, to_tile(xi0), to_tile(xi1), to_tile(yi0), to_tile(yi1)


def _bucket_sort(face_verts, s: int, tile: int, span: int, far: float):
    """Shared sort prefix of the bucket rasterizers.

    Returns (verts (B, nf, 9) float32 sorted by bucket key, fid (B, nf)
    int32 original face ids in that order, starts (B, T+2) int32 bucket
    starts: entry T = oversized bucket, entry T+1 = start of the culled
    faces, order (B, nf) int64 = fid)."""
    b, nf = face_verts.shape[0], face_verts.shape[1]
    dev = face_verts.device
    g = s // tile
    n_tiles = g * g
    base, txa, txe, tya, tye = _cull_and_tiles(face_verts, s, tile, far)
    oversized = ((txe - txa) >= span) | ((tye - tya) >= span)
    # top-left covered tile; oversized -> bucket T, culled -> T+1
    key = torch.where(base & ~oversized, tya * g + txa,
                      torch.where(base & oversized, n_tiles, n_tiles + 1))
    shift = 1
    while (1 << shift) < nf:
        shift += 1
    if (n_tiles + 1) >= (1 << (31 - shift)):
        raise ValueError(f"fused sort key overflows int32: {n_tiles} tiles, "
                         f"{nf} faces")
    fid = torch.arange(nf, dtype=torch.int32, device=dev)
    fused = (key.int() << shift) | fid
    fused_sorted = torch.sort(fused, dim=1).values
    fid_sorted = fused_sorted & ((1 << shift) - 1)
    order = fid_sorted.long()
    verts = torch.gather(face_verts.reshape(b, nf, 9), 1,
                         order[..., None].expand(b, nf, 9))
    # first fused entry >= (t << shift) == first face of bucket t
    tids = (torch.arange(n_tiles + 2, dtype=torch.int32, device=dev)
            << shift).expand(b, n_tiles + 2).contiguous()
    starts = torch.searchsorted(fused_sorted, tids, out_int32=True)
    return verts.contiguous(), fid_sorted.contiguous(), starts, order


@torch.no_grad()
def rasterize_fim_wim_bucket(face_verts, image_size: int = 256,
                             near: float = DEFAULT_NEAR,
                             far: float = DEFAULT_FAR, tile: int = 16,
                             span: int = 2):
    """Work-efficient rasterizer, same contract as
    :func:`rasterize_fim_wim` (bit-exact fim on body meshes). ``span``
    bounds the tile span of non-oversized faces; wider faces go to the
    shared oversized range.

    One accepted divergence, as in the JAX package: a face whose three
    projected vertices are identical passes the inside test everywhere,
    so the brute path lets it contend for every pixel while bucketing
    confines it to its one-pixel bbox. No projected mesh produces one."""
    fv = face_verts.float()
    s = image_size
    verts, fid, starts, _ = _bucket_sort(fv, s, tile, span, far)
    return cuda_raster.zbuffer_bucket_rows(verts, fid, starts, s, tile,
                                           span, near, far)


@torch.no_grad()
def rasterize_flow_bucket(face_verts, src_f2pts, image_size: int = 256,
                          near: float = DEFAULT_NEAR,
                          far: float = DEFAULT_FAR, tile: int = 16,
                          span: int = 2):
    """Fused rasterize + correspondence flow: fim (B, S, S) int32 and
    T (B, S, S, 2), the z-buffer winner's barycentric blend of its
    source-image vertex xy (-2 on background).

    src_f2pts (Bs, nf, 3, 2) with Bs in {1, B}: a batch-1 source
    broadcasts through the per-batch order gather without a copy."""
    fv = face_verts.float()
    b, nf = fv.shape[0], fv.shape[1]
    s = image_size
    verts, fid, starts, order = _bucket_sort(fv, s, tile, span, far)
    src = src_f2pts.float().reshape(src_f2pts.shape[0], nf, 6)
    srcxy = torch.gather(src.expand(b, nf, 6), 1,
                         order[..., None].expand(b, nf, 6))
    return cuda_raster.zbuffer_bucket_flow(verts, fid, srcxy, starts, s,
                                           tile, span, near, far)


EX_SLOTS = 16  # oversized-face slots at the front of every tile


def _tile_pairs(face_verts, s: int, tile: int, span: int, far: float):
    """The (face, tile) pairs of the fixed-slot path.

    A face that spans fewer than ``span`` tiles on both axes enumerates
    the tiles of its bbox in a span×span window from its top-left tile;
    wider faces are oversized. Returns (tid (B, nf, span, span) int32,
    pair_valid (B, nf, span, span) bool, oversized faces (B, nf) bool)."""
    g = s // tile
    dev = face_verts.device
    base, txa, txe, tya, tye = _cull_and_tiles(face_verts, s, tile, far)
    oversized = ((txe - txa) >= span) | ((tye - tya) >= span)
    d = torch.arange(span, dtype=torch.int32, device=dev)
    ty = tya[..., None, None] + d[:, None]              # (B, nf, span, 1)
    tx = txa[..., None, None] + d[None, :]              # (B, nf, 1, span)
    tye, txe = tye[..., None, None], txe[..., None, None]
    tid = torch.minimum(ty, tye) * g + torch.minimum(tx, txe)
    pair_valid = (base & ~oversized)[..., None, None] & (ty <= tye) \
        & (tx <= txe)
    return tid, pair_valid, base & oversized


def _tiled_candidates(face_verts, s: int, tile: int, cap: int, span: int,
                      far: float):
    """Candidate slots of the fixed-slot z-buffer (rasterizer.py:609-686).

    Every (face, tile) pair gets the int32 key ``tile·nf + fid``; one sort
    bins the faces into their tiles by ascending id, ``searchsorted``
    finds each tile's run, and a tile keeps the first ``cap`` entries.
    The 16 oversized faces of lowest id (``top_k`` of ``nf - fid``) sit
    in front of every tile's slots. Returns (packed (B, nf, 9) float32,
    cand (B, T, 16 + cap) int32 face ids, valid (B, T, 16 + cap) int32);
    pairs beyond a tile's cap are dropped (:func:`raster_tile_stats`
    counts them)."""
    b, nf = face_verts.shape[0], face_verts.shape[1]
    dev = face_verts.device
    g = s // tile
    n_tiles = g * g
    if n_tiles * nf >= 2 ** 31:
        raise ValueError(f"pair key overflows int32: {n_tiles} tiles, "
                         f"{nf} faces")
    cap = min(cap, nf)
    tid, pair_valid, over = _tile_pairs(face_verts, s, tile, span, far)
    fid = torch.arange(nf, dtype=torch.int32, device=dev)[:, None, None]
    keys = torch.where(pair_valid, tid * nf + fid, n_tiles * nf)
    sorted_keys = torch.sort(keys.reshape(b, -1), dim=1).values
    tile_of = (sorted_keys // nf).contiguous()
    fid_of = sorted_keys % nf
    tids = torch.arange(n_tiles, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(tile_of, tids.expand(b, n_tiles).contiguous())
    idx = (starts[..., None] + torch.arange(cap, device=dev)).reshape(b, -1)
    idx = idx.clamp(0, tile_of.shape[1] - 1)
    cand = torch.gather(fid_of, 1, idx).reshape(b, n_tiles, cap)
    valid = torch.gather(tile_of, 1, idx).reshape(b, n_tiles, cap) \
        == tids[:, None]

    score = torch.where(over, nf - fid[:, 0, 0], -1)
    if nf < EX_SLOTS:
        score = torch.cat([score, score.new_full((b, EX_SLOTS - nf), -1)], 1)
    ex = torch.topk(score, EX_SLOTS, dim=1).values          # (B, EX)
    ex_ids = torch.where(ex > 0, nf - ex, 0)[:, None, :]
    ex_valid = (ex > 0)[:, None, :]
    cand = torch.cat([ex_ids.expand(b, n_tiles, EX_SLOTS), cand], 2)
    valid = torch.cat([ex_valid.expand(b, n_tiles, EX_SLOTS), valid], 2)
    packed = face_verts.reshape(b, nf, 9).contiguous()
    return packed, cand.int().contiguous(), valid.int().contiguous()


@torch.no_grad()
def rasterize_fim_wim_tiled(face_verts, image_size: int = 256,
                            near: float = DEFAULT_NEAR,
                            far: float = DEFAULT_FAR, tile: int = 16,
                            cap: int = 512, span: int = 2):
    """Fixed-slot tiled rasterizer, same contract as
    :func:`rasterize_fim_wim` while no tile holds more than ``cap``
    candidates: beyond that its faces of highest id are dropped, and
    oversized faces beyond 16 too (:func:`raster_tile_stats` reports
    both). Exact z ties go to the lower slot: an oversized face before
    the tile's own faces, else the lower face id.

    The kernel reads each slot's vertices from the (B, nf, 9) face
    table; no (B, T, slots, 9) candidate array is built."""
    s = image_size
    packed, cand, valid = _tiled_candidates(face_verts.float(), s, tile, cap,
                                            span, far)
    return cuda_raster.zbuffer_tiles(packed, cand, valid, s, tile, near, far)


def render_silhouette(fim):
    """Binary silhouette of a face-index map, (B, S, S) float32."""
    return (fim >= 0).float()


def depth_from_fim_wim(face_verts, fim, wim, far: float = DEFAULT_FAR):
    """Perspective-correct depth (B, S, S) float32 from the z-buffer's
    winners, ``far`` on background: one gather of the winning face's
    vertex z, then 1 / Σ w_k / z_k, the kernel's depth. A pixel whose
    Σ w / z is 0 divides by 1 instead.

    face_verts (B, nf, 3, 3); fim (B, S, S); wim (B, S, S, 3)."""
    zv = face_verts[..., 2]                                   # (B, nf, 3)
    rows = torch.arange(zv.shape[0], device=zv.device)[:, None, None]
    z_face = zv[rows, fim.clamp(min=0).long()]                # (B, S, S, 3)
    inv_z = (wim / z_face).sum(-1)
    inv_z = torch.where(inv_z == 0.0, torch.ones_like(inv_z), inv_z)
    return torch.where(fim >= 0, 1.0 / inv_z,
                       torch.full_like(inv_z, far)).float()


@torch.no_grad()
def raster_tile_stats(face_verts, image_size: int = 256,
                      far: float = DEFAULT_FAR, tile: int = 16,
                      cap: int = 512, span: int = 2,
                      ex: int = EX_SLOTS) -> dict:
    """Occupancy and overflow of :func:`rasterize_fim_wim_tiled`'s
    (tile, cap, span) point, per batch item ((B,) int64 tensors):
    ``max_tile_occupancy`` (the fullest tile's candidate count),
    ``dropped_pairs`` (Σ max(count - cap, 0)), ``oversized_faces`` and
    ``oversized_dropped`` (those beyond the ``ex`` slots)."""
    fv = face_verts.float()
    b = fv.shape[0]
    g = image_size // tile
    tid, pair_valid, over = _tile_pairs(fv, image_size, tile, span, far)
    counts = torch.zeros((b, g * g), dtype=torch.int64, device=fv.device)
    counts.scatter_add_(1, tid.reshape(b, -1).long(),
                        pair_valid.reshape(b, -1).long())
    n_over = over.sum(1)
    return {
        "max_tile_occupancy": counts.amax(1),
        "dropped_pairs": (counts - cap).clamp(min=0).sum(1),
        "oversized_faces": n_over,
        "oversized_dropped": (n_over - ex).clamp(min=0),
    }
