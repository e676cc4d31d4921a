"""Renderer facade: constant tables + the raster / flow / encoding calls
every task shares (torch port of
``impersonator_tpu/tasks/renderer.py:42-341``), with the JAX package's
three-way z-buffer gate: bucket kernels, the fixed-slot tiled kernel for
meshes over 60,000 faces, or the brute z-buffer. The texture half
(:meth:`SMPLRenderer.extract_texture`, :meth:`~SMPLRenderer.render_textured`,
:meth:`~SMPLRenderer.render_depth`, :meth:`~SMPLRenderer.render_rgb` and
:func:`lighting`) is gathers and elementwise work on the z-buffer's
products; it feeds the texture-warping baseline."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from impersonator_tpu_torch.assets import SMPLAssets
from impersonator_tpu_torch.ops import flow as flow_ops
from impersonator_tpu_torch.ops import rasterizer as rast
from impersonator_tpu_torch.ops.projection import DEFAULT_EYE_Z, eye_z
from impersonator_tpu_torch.ops.sampler import grid_sample
from impersonator_tpu_torch.ops.smpl import batch_orth_proj_idrot


@dataclasses.dataclass(frozen=True)
class SMPLRenderer:
    """Constant renderer state on one device. Build with :meth:`create`."""

    faces: torch.Tensor       # (nf, 3) int64
    map_fn: torch.Tensor      # (nf+1, C) conditioning encoding
    back_map_fn: torch.Tensor  # (nf+1, 1) head minus face
    front_map_fn: torch.Tensor | None  # (nf+1, 1) face, if has_front
    image_size: int = 256
    tex_size: int = 3         # T: each face's texture is T×T texels
    near: float = rast.DEFAULT_NEAR
    far: float = rast.DEFAULT_FAR
    eye_z_value: float = DEFAULT_EYE_Z

    @classmethod
    def create(cls, assets: SMPLAssets, device, image_size: int = 256,
               map_name: str = "uv_seg", tex_size: int = 3,
               has_front: bool = False, viewing_angle: float = 30.0):
        """``map_name`` picks the conditioning encoding; the front (face)
        table is built only with ``has_front``; the eye sits at
        1/tan(viewing_angle) + 1."""
        def table(name):
            return torch.as_tensor(assets.map_fn(name), device=device)

        return cls(
            faces=torch.as_tensor(np.asarray(assets.faces, np.int64),
                                  device=device),
            map_fn=table(map_name),
            back_map_fn=table("back"),
            front_map_fn=table("front") if has_front else None,
            image_size=image_size,
            tex_size=tex_size,
            eye_z_value=eye_z(viewing_angle),
        )

    def tile_params(self):
        """(tile, cap, span) of the fixed-slot tiled path; tile 0 means
        the image does not tile evenly (renderer.py:96-114). The tile is
        8 px per 256 px of image, so that a tile's candidate count does
        not depend on the resolution; span widens with mesh coarseness,
        2·sqrt(13776/nf). raster_tile_stats shows whether the cap holds."""
        s = self.image_size
        tile = 8 * max(1, s // 256)
        if s % tile:
            tile = 8
        if s % tile:
            return 0, 0, 0
        nf = self.faces.shape[0]
        span = max(2, int(np.ceil(2.0 * np.sqrt(13776.0 / max(nf, 1)))))
        return tile, 288, span

    def _bucket_config(self):
        """(tile, span) of the bucket path, or None — the one gate
        render_fim_wim and render_flow share. The bucket path needs an
        image that tiles evenly and a mesh big enough to amortise the sort
        (nf > 256) yet within the range the JAX package keeps its sorted
        table for (nf <= 60000). Tiles are 16 px where the image divides
        by 16, else 8 px (the JAX gate's rarer 24/40-px tiles would not
        fit one CTA). Span is the face size in tiles,
        sqrt(13776/nf) · (s/256) · (8/tile), doubled, as in the JAX
        package's gate."""
        s = self.image_size
        nf = self.faces.shape[0]
        if not (self.tile_params()[0] and 256 < nf <= 60000):
            return None
        tile = 16 if s % 16 == 0 else 8
        span = max(2, int(np.ceil(2.0 * np.sqrt(13776.0 / nf)
                                  * (s / 256.0) * (8.0 / tile))))
        return tile, span

    def raster_route(self) -> str:
        """Which z-buffer render_fim_wim runs: 'bucket', 'tiled' (meshes
        over 60,000 faces) or 'brute' (tiny meshes, images that do not
        tile) — the JAX gate (renderer.py:73-93) with the port's kernels
        standing where it has the TPU's."""
        if self._bucket_config() is not None:
            return "bucket"
        if self.tile_params()[0] and self.faces.shape[0] > 256:
            return "tiled"
        return "brute"

    def render_fim_wim(self, cam, verts):
        """(cam (B,3), verts (B,nv,3)) -> (f2verts (B,nf,3,3) in raster
        space, fim (B,S,S) int32, wim (B,S,S,3))."""
        f2verts = rast.project_to_raster_space(verts, cam, self.faces,
                                               self.eye_z_value)
        s = self.image_size
        route = self.raster_route()
        if route == "bucket":
            tile, span = self._bucket_config()
            fim, wim = rast.rasterize_fim_wim_bucket(
                f2verts, s, self.near, self.far, tile=tile, span=span)
        elif route == "tiled":
            tile, cap, span = self.tile_params()
            fim, wim = rast.rasterize_fim_wim_tiled(
                f2verts, s, self.near, self.far, tile=tile, cap=cap,
                span=span)
        else:
            fim, wim = rast.rasterize_fim_wim(f2verts, s, self.near,
                                              self.far)
        return f2verts, fim, wim

    def tile_stats(self, f2verts):
        """Occupancy and overflow of the tiled path's (tile, cap, span)
        point on these faces (ops.rasterizer.raster_tile_stats), or None
        where the image does not tile."""
        tile, cap, span = self.tile_params()
        if not tile:
            return None
        return rast.raster_tile_stats(f2verts, self.image_size, self.far,
                                      tile=tile, cap=cap, span=span)

    def render_flow(self, cam, verts, src_f2pts):
        """(cam (B,3), verts (B,nv,3), src_f2pts (Bs,nf,3,2)) -> (fim, T):
        the target face-index map and the liquid-warping flow in one
        raster pass (the fused kernel), or raster + correspondence_flow
        on the brute path."""
        bucket = self._bucket_config()
        if bucket is None:
            _, fim, wim = self.render_fim_wim(cam, verts)
            return fim, self.cal_bc_transform(src_f2pts, fim, wim)
        tile, span = bucket
        f2verts = rast.project_to_raster_space(verts, cam, self.faces,
                                               self.eye_z_value)
        return rast.rasterize_flow_bucket(f2verts, src_f2pts,
                                          self.image_size, self.near,
                                          self.far, tile=tile, span=span)

    @staticmethod
    def f2pts_from_f2verts(f2verts):
        """xy of projected face vertices with y back in image-up
        convention."""
        flip = torch.tensor([1.0, -1.0], dtype=f2verts.dtype,
                            device=f2verts.device)
        return f2verts[..., 0:2] * flip

    def encode_fim(self, fim, map_fn=None):
        """fim -> (B, S, S, C) by ``map_fn``, the conditioning table by
        default."""
        return flow_ops.encode_fim(fim, self.map_fn if map_fn is None
                                   else map_fn)

    def encode_front_fim(self, fim, front_fn: bool = True):
        """fim -> (B, S, S, 1) mask of the face (``front_fn``) or of the
        back of the head."""
        table = self.front_map_fn if front_fn else self.back_map_fn
        if table is None:
            raise ValueError("renderer built without the front table "
                             "(has_front=False)")
        return flow_ops.encode_fim(fim, table)

    def cal_bc_transform(self, src_f2pts, dst_fim, dst_wim):
        """The flow T from given raster products (correspondence_flow)."""
        return flow_ops.correspondence_flow(src_f2pts, dst_fim, dst_wim)

    def get_vis_f2pts(self, f2pts, fim):
        return flow_ops.visible_f2pts(f2pts, fim)

    def set_null_f2pts(self, f2pts, fim):
        return flow_ops.null_visible_f2pts(f2pts, fim)

    # -- texture (the texture-warping baseline, debug renders) ---------------

    def dynamic_sampler_grid(self, cam, verts):
        """Each face's T×T barycentric sample points on the source image,
        (B, nf, T*T, 2) in [-1, 1], a-major over (a, b): the point
        a·v0 + b·v1 + (1 - a - b)·v2 for a, b on the T-step grid of
        [0, 1]."""
        fpts = batch_orth_proj_idrot(verts, cam)[:, self.faces]  # (B,nf,3,2)
        t = self.tex_size
        step = 1.0 if t == 1 else 1.0 / (t - 1)
        # numpy's float32 arange, the JAX package's grid values exactly
        ab = torch.from_numpy(np.arange(0.0, 1.0 + step, step,
                                        dtype=np.float32)[:t]).to(verts)
        av, bv = torch.meshgrid(ab, ab, indexing="ij")
        coords = torch.stack([av.reshape(-1), bv.reshape(-1)], 0)  # (2, T*T)
        v2 = fpts[:, :, 2]
        edges = torch.stack([fpts[:, :, 0] - v2, fpts[:, :, 1] - v2], -1)
        samples = torch.einsum("bfce,et->bfct", edges, coords) + v2[..., None]
        return samples.transpose(2, 3).clamp(-1.0, 1.0)

    def extract_texture(self, images, cam, verts):
        """Per-face texels sampled bilinearly from ``images`` (B, S, S, C)
        NHWC at :meth:`dynamic_sampler_grid`'s points -> (B, nf, T*T, C)."""
        grid = self.dynamic_sampler_grid(cam, verts)
        b, nf, tt, _ = grid.shape
        out = grid_sample(images, grid.reshape(b, nf * tt, 1, 2))
        return out.reshape(b, nf, tt, images.shape[-1])

    def render_textured(self, fim, wim, tex):
        """Paint each covered pixel from its face's T×T texture patch,
        sampled bilinearly at the pixel's barycentrics (w0, w1) -> (B, S,
        S, C) NHWC, 0 on background: four gathers, one per corner.

        fim (B, S, S) int face ids (-1 background); wim (B, S, S, 3);
        tex (B, nf, T*T, C) from :meth:`extract_texture`."""
        b, s = fim.shape[0], fim.shape[1]
        c = tex.shape[-1]
        t = self.tex_size
        f = fim.clamp(min=0).long()
        flat = tex.reshape(b, -1, c)

        def gather(ia, ib):
            idx = (f * (t * t) + ia * t + ib).reshape(b, -1, 1)
            return torch.take_along_dim(flat, idx, 1).reshape(b, s, s, c)

        if t == 1:
            img = gather(torch.zeros_like(f), torch.zeros_like(f))
        else:
            fa = wim[..., 0].clamp(0.0, 1.0) * (t - 1)
            fb = wim[..., 1].clamp(0.0, 1.0) * (t - 1)
            ia = fa.floor().long().clamp(0, t - 2)
            ib = fb.floor().long().clamp(0, t - 2)
            da = (fa - ia)[..., None]
            db = (fb - ib)[..., None]
            img = ((1 - da) * (1 - db) * gather(ia, ib)
                   + (1 - da) * db * gather(ia, ib + 1)
                   + da * (1 - db) * gather(ia + 1, ib)
                   + da * db * gather(ia + 1, ib + 1))
        return img * (fim >= 0).to(img.dtype)[..., None]

    def render_depth(self, cam, verts):
        """Perspective-correct depth (B, S, S), ``far`` on background,
        from the z-buffer's winners (rasterizer.depth_from_fim_wim)."""
        f2verts, fim, wim = self.render_fim_wim(cam, verts)
        return rast.depth_from_fim_wim(f2verts, fim, wim, self.far)

    def render_rgb(self, cam, verts, images, intensity_ambient: float = 1.0,
                   intensity_directional: float = 0.0):
        """The textured debug render: texels of ``images`` (B, S, S, C)
        on the posed mesh, lit by :func:`lighting` unless the light is the
        default unlit ambient 1 -> (rgb (B, S, S, C), silhouette (B, S,
        S)). Normals are taken in raster space."""
        f2verts, fim, wim = self.render_fim_wim(cam, verts)
        tex = self.extract_texture(images, cam, verts)
        if intensity_ambient != 1.0 or intensity_directional != 0.0:
            tex = lighting(f2verts, tex,
                           intensity_ambient=intensity_ambient,
                           intensity_directional=intensity_directional)
        return (self.render_textured(fim, wim, tex),
                rast.render_silhouette(fim))


def lighting(face_verts, tex, intensity_ambient: float = 0.5,
             intensity_directional: float = 0.5,
             color_ambient=(1.0, 1.0, 1.0),
             color_directional=(1.0, 1.0, 1.0),
             direction=(0.0, 1.0, 1.0)):
    """Ambient + directional flat shading of per-face texels: one Lambert
    term per face from its geometric normal scales all its texels.

    face_verts (B, nf, 3, 3) xyz; tex (B, nf, T*T, C). A 3-channel
    texture is lit per channel, any other by the light's mean."""
    def vec(v):
        return torch.tensor(v, dtype=tex.dtype, device=tex.device)

    light = (vec(color_ambient) * intensity_ambient).expand(
        *face_verts.shape[:2], 3)
    if intensity_directional != 0.0:
        v10 = face_verts[:, :, 1] - face_verts[:, :, 0]
        v21 = face_verts[:, :, 2] - face_verts[:, :, 1]
        n = torch.linalg.cross(v10, v21)
        n = n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-10)
        d = vec(direction)
        d = d / (torch.linalg.norm(d) + 1e-10)
        cos = torch.relu(torch.einsum("bfc,c->bf", n, d))
        light = light + (intensity_directional * vec(color_directional)
                         * cos[..., None])
    if tex.shape[-1] == 3:
        return tex * light[:, :, None, :]
    return tex * light.mean(-1)[:, :, None, None]
