"""Renderer facade: constant tables + the raster / flow / encoding calls
every task shares (torch port of
``impersonator_tpu/tasks/renderer.py:42-211``), with the JAX package's
three-way z-buffer gate: bucket kernels, the fixed-slot tiled kernel for
meshes over 60,000 faces, or the brute z-buffer."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from impersonator_tpu_torch.assets import SMPLAssets
from impersonator_tpu_torch.ops import flow as flow_ops
from impersonator_tpu_torch.ops import rasterizer as rast
from impersonator_tpu_torch.ops.projection import DEFAULT_EYE_Z, eye_z


@dataclasses.dataclass(frozen=True)
class SMPLRenderer:
    """Constant renderer state on one device. Build with :meth:`create`."""

    faces: torch.Tensor       # (nf, 3) int64
    map_fn: torch.Tensor      # (nf+1, C) conditioning encoding
    back_map_fn: torch.Tensor  # (nf+1, 1) head minus face
    front_map_fn: torch.Tensor | None  # (nf+1, 1) face, if has_front
    image_size: int = 256
    near: float = rast.DEFAULT_NEAR
    far: float = rast.DEFAULT_FAR
    eye_z_value: float = DEFAULT_EYE_Z

    @classmethod
    def create(cls, assets: SMPLAssets, device, image_size: int = 256,
               map_name: str = "uv_seg", has_front: bool = False,
               viewing_angle: float = 30.0):
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
