"""Textured-mesh export: a per-face texture atlas and an OBJ / MTL
writer (torch port of ``impersonator_tpu/utils/mesh_io.py``, numpy
only): each face's barycentric T×T texture patch is painted into one
``ts``×``ts`` tile of a square atlas, the face's UV triangle spanning the
tile's lower-left half, and the OBJ references those UVs through an MTL.
The atlas is written as a PNG with zlib (``utils.visualizer.write_png``).
"""

from __future__ import annotations

import os

import numpy as np

from impersonator_tpu_torch.utils.visualizer import write_png


def create_texture_atlas(tex: np.ndarray, texture_size_out: int = 16):
    """(nf, T*T, 3) barycentric face textures -> (atlas (H, W, 3),
    uv (nf, 3, 2) in [0, 1]).

    The per-face grid is laid out a-major over (a, b) with the sample at
    a·v0 + b·v1 + (1-a-b)·v2 (renderer.dynamic_sampler_grid); each atlas
    tile triangle is (0,0), (0,h), (w,h) in tile-local (x, y), matching
    save_obj.py:18-26.
    """
    tex = np.asarray(tex, np.float32)
    nf, tt, c = tex.shape
    t_in = int(round(np.sqrt(tt)))
    assert t_in * t_in == tt, "texture must be a square barycentric grid"
    ts = texture_size_out
    tile_w = int((nf - 1.0) ** 0.5) + 1
    tile_h = (nf - 1) // tile_w + 1

    # barycentric coords of every tile-local pixel wrt the tile triangle
    h = w = float(ts - 1)
    yy, xx = np.mgrid[0:ts, 0:ts].astype(np.float32)
    cc = xx / w
    bb = yy / h - cc
    aa = 1.0 - bb - cc
    # clamp outside-triangle pixels onto the simplex (CUDA kernel's eps
    # clamp, create_texture_image_cuda)
    aa = np.clip(aa, 0.0, 1.0)
    bb = np.clip(bb, 0.0, 1.0)
    ssum = np.maximum(aa + bb + np.clip(1.0 - aa - bb, 0.0, 1.0), 1e-5)
    aa, bb = aa / ssum, bb / ssum

    # bilinear sample each face's (a, b) grid at (aa, bb)
    fa = np.clip(aa, 0, 1) * (t_in - 1)
    fb = np.clip(bb, 0, 1) * (t_in - 1)
    ia = np.clip(np.floor(fa).astype(np.int64), 0, max(t_in - 2, 0))
    ib = np.clip(np.floor(fb).astype(np.int64), 0, max(t_in - 2, 0))
    da = (fa - ia)[None, :, :, None]
    db = (fb - ib)[None, :, :, None]
    grid = tex.reshape(nf, t_in, t_in, c)
    if t_in == 1:
        tiles = np.broadcast_to(grid[:, 0, 0][:, None, None, :],
                                (nf, ts, ts, c)).copy()
    else:
        ia1 = np.minimum(ia + 1, t_in - 1)
        ib1 = np.minimum(ib + 1, t_in - 1)
        tiles = ((1 - da) * (1 - db) * grid[:, ia, ib]
                 + (1 - da) * db * grid[:, ia, ib1]
                 + da * (1 - db) * grid[:, ia1, ib]
                 + da * db * grid[:, ia1, ib1])

    atlas = np.zeros((tile_h * ts, tile_w * ts, c), np.float32)
    rows = np.arange(nf) // tile_w
    cols = np.arange(nf) % tile_w
    for f in range(nf):
        r0, c0 = rows[f] * ts, cols[f] * ts
        atlas[r0:r0 + ts, c0:c0 + ts] = tiles[f]

    uv = np.zeros((nf, 3, 2), np.float32)
    uv[:, 0] = np.stack([cols * ts, rows * ts], axis=1)
    uv[:, 1] = np.stack([cols * ts, (rows + 1) * ts - 1], axis=1)
    uv[:, 2] = np.stack([(cols + 1) * ts - 1, (rows + 1) * ts - 1], axis=1)
    uv[..., 0] /= atlas.shape[1] - 1
    uv[..., 1] /= atlas.shape[0] - 1
    # OBJ vt convention: origin bottom-left; the atlas image is written
    # top-down, so flip v (save_obj.py:40 flips the image instead)
    atlas = atlas[::-1]
    return atlas, uv


def save_obj(filename: str, vertices, faces, textures=None,
             texture_size_out: int = 16):
    """Write an OBJ (+ MTL + PNG atlas when ``textures`` given).

    vertices (nv, 3), faces (nf, 3) int, textures (nf, T*T, 3) in
    [-1, 1]. Mirrors save_obj.py:45-107's file layout.
    """
    vertices = np.asarray(vertices)
    faces = np.asarray(faces)
    lines = [f"# {os.path.basename(filename)}", "#", "g"]

    mtl_path = tex_path = None
    if textures is not None:
        mtl_path = filename[:-4] + ".mtl"
        tex_path = filename[:-4] + ".png"
        atlas, uv = create_texture_atlas(textures, texture_size_out)
        img = ((atlas + 1.0) * 0.5 * 255.0).clip(0, 255).astype(np.uint8)
        write_png(tex_path, img)
        with open(mtl_path, "w") as f:
            f.write("newmtl material_1\n"
                    f"map_Kd {os.path.basename(tex_path)}\n")
        lines.append(f"mtllib {os.path.basename(mtl_path)}")

    for v in vertices:
        lines.append("v %.8f %.8f %.8f" % (v[0], v[1], v[2]))
    if textures is not None:
        for tri in uv:
            for p in tri:
                lines.append("vt %.8f %.8f" % (p[0], 1.0 - p[1]))
        lines.append("usemtl material_1")
        for i, face in enumerate(faces):
            lines.append("f %d/%d %d/%d %d/%d" % (
                face[0] + 1, 3 * i + 1, face[1] + 1, 3 * i + 2,
                face[2] + 1, 3 * i + 3))
    else:
        for face in faces:
            lines.append("f %d %d %d" % (face[0] + 1, face[1] + 1,
                                         face[2] + 1))
    with open(filename, "w") as f:
        f.write("\n".join(lines) + "\n")
    return filename
