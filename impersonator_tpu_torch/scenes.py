"""Synthetic scenes for the tests and ``chip_smoke.py``: mesh faces for
checking the raster kernels against their plain twins, and a drawn
human face that the released MTCNN weights detect."""

from __future__ import annotations

import numpy as np


def degenerate_scene(s, seed=3):
    """(2, nf, 3, 3) faces that the float inside test passes where a bbox
    does not bound them, over a random scatter: three equal vertices on a
    pixel centre, collinear faces along pixel rows, columns and diagonals
    through pixel centres, and slivers 1e-5 to 1e-3 px wide (some with
    their long edge through pixel centres), each in both vertex orders.
    Vertex coordinates are exact pixel centres of an s-px image where the
    scene says so (s a power of two)."""
    rng = np.random.default_rng(seed)
    px = 2.0 / s                                  # one pixel in NDC

    def centre(i):
        return (2.0 * i + 1.0 - s) / s

    def ij(n, lo=2, hi=None):
        return rng.integers(lo, (hi or s) - 2, (n, 2))

    faces = []
    for i, j in ij(12):                           # three equal vertices
        faces.append([[centre(i), centre(j)]] * 3)
    for i, j in ij(12, hi=s - 24):                # along rows / columns
        k = rng.integers(1, 8, 2)
        xs = [centre(i), centre(i + k[0]), centre(i + k[0] + k[1])]
        faces.append([[x, centre(j)] for x in xs])
        faces.append([[centre(j), x] for x in xs])
        faces.append([[x, x - centre(i) + centre(j)] for x in xs])
    for _ in range(24):                           # slivers
        a = rng.uniform(-0.8, 0.8, 2)
        if rng.random() < 0.5:
            a = centre(np.round((a * s + s - 1) / 2))
        d = rng.uniform(5, 40) * px * rng.choice([-1.0, 1.0], 2)
        if rng.random() < 0.5:
            d[rng.integers(2)] = 0.0              # axis-aligned long edge
        n = np.array([-d[1], d[0]]) / np.hypot(*d)
        w = 10.0 ** rng.uniform(-5, -3) * px
        faces.append([a, a + d, a + 0.5 * d + w * n])
    faces = np.asarray(faces)
    faces = np.concatenate([faces, faces[:, ::-1]])
    z = rng.uniform(1.5, 3.0, faces.shape[:2] + (1,))
    deg = np.concatenate([faces, z], -1)
    xy = rng.uniform(-0.9, 0.9, (200, 1, 2)) + rng.uniform(-0.1, 0.1,
                                                          (200, 3, 2))
    rand = np.concatenate([xy, rng.uniform(1.5, 3.0, (200, 3, 1))], -1)
    fv = np.concatenate([deg, rand])
    return np.stack([fv, fv[rng.permutation(len(fv))]]).astype(np.float32)


def tie_scene(s, tile, slots=304, live=0.7, batch=2, seed=5,
              stray_ids=True, shapes=6):
    """Fixed-slot inputs (packed (B, nf, 9) float32, cand and valid
    (B, (s/tile)², slots) int32, numpy) whose winners are decided by exact
    depth ties: ``shapes`` coplanar triangles at z = 2, each repeated
    under 40 face ids, listed in every tile's slots in random order with a share
    ``live`` of the slots live, so that faces of equal depth sit on both
    sides of every share boundary of the kernel's split. With
    ``stray_ids`` some live slots name no face (-1 or past the table)."""
    rng = np.random.default_rng(seed)
    n_base, copies = shapes, 40
    tri = rng.uniform(-0.3, 0.3, (n_base, 1, 2)) \
        + rng.uniform(-1.0, 1.0, (n_base, 3, 2))
    # the vertex order the inside test passes: edge 0's function >= 0 at
    # the centroid
    c = tri.mean(1)
    t0 = ((c[:, 1] - tri[:, 0, 1]) * (tri[:, 1, 0] - tri[:, 0, 0])
          - (c[:, 0] - tri[:, 0, 0]) * (tri[:, 1, 1] - tri[:, 0, 1]))
    tri[t0 < 0] = tri[t0 < 0][:, ::-1]
    faces = np.repeat(tri, copies, 0)[rng.permutation(n_base * copies)]
    fv = np.concatenate([faces, np.full(faces.shape[:2] + (1,), 2.0)], -1)
    nf = fv.shape[0]
    packed = np.broadcast_to(fv.reshape(1, nf, 9), (batch, nf, 9))
    n_tiles = (s // tile) ** 2
    cand = rng.integers(0, nf, (batch, n_tiles, slots))
    valid = rng.random((batch, n_tiles, slots)) < live
    if stray_ids:
        stray = rng.random(cand.shape) < 0.02
        cand = np.where(stray, rng.choice([-1, nf, nf + 7], cand.shape),
                        cand)
    return (np.ascontiguousarray(packed, np.float32), cand.astype(np.int32),
            valid.astype(np.int32))


def face_image(h: int, w: int, cx: float, cy: float, r: float,
               seed: int = 0) -> np.ndarray:
    """(h, w, 3) uint8 RGB: a drawn face of height 2r centred at (cx, cy)
    (skin ellipse, eyes with pupils, brows, nose, mouth, hair) on a noisy
    grey-blue background, blurred once with a 5-tap binomial. The
    released MTCNN weights find it at scores above 0.99 for r from 24 to
    55 px."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32) + np.float32([90, 110, 130])
    img += rng.normal(0, 4, (h, w, 3))

    def ellipse(x, y, rx, ry):
        return ((xx - x) / rx) ** 2 + ((yy - y) / ry) ** 2 <= 1

    face = ellipse(cx, cy, 0.78 * r, r)
    img[ellipse(cx, cy - 0.25 * r, 0.85 * r, 0.95 * r) & ~face
        & (yy < cy)] = [50, 35, 25]
    img[face] = [224, 172, 140]
    for side in (-1, 1):
        ex = cx + side * 0.33 * r
        img[ellipse(ex, cy - 0.12 * r, 0.13 * r, 0.07 * r)] = [245, 245, 245]
        img[ellipse(ex, cy - 0.12 * r, 0.06 * r, 0.06 * r)] = [40, 30, 25]
        img[ellipse(ex, cy - 0.33 * r, 0.17 * r, 0.035 * r)] = [70, 50, 40]
    img[ellipse(cx, cy + 0.12 * r, 0.07 * r, 0.15 * r)] = [200, 140, 115]
    img[ellipse(cx, cy + 0.45 * r, 0.25 * r, 0.06 * r)] = [150, 60, 60]
    k = np.float32([1, 4, 6, 4, 1]) / 16
    for axis in (0, 1):
        img = sum(np.roll(img, i - 2, axis=axis) * k[i] for i in range(5))
    return img.clip(0, 255).astype(np.uint8)
