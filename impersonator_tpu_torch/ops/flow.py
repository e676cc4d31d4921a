"""Correspondence flow T and fim encodings (torch port of
``impersonator_tpu/ops/flow.py:14-88``)."""

from __future__ import annotations

import torch

from impersonator_tpu_torch.utils.precision import full_fp32

BG_FLOW = -2.0  # background flow: outside [-1, 1], so grid_sample reads 0


def correspondence_flow(src_f2pts, dst_fim, dst_wim):
    """T (B, H, W, 2): per target pixel covered by face f, the barycentric
    blend of f's source-image vertex xy; BG_FLOW on background.

    src_f2pts (Bs, nf, 3, 2), Bs in {1, B}; dst_fim (B, H, W) int;
    dst_wim (B, H, W, 3)."""
    b, h, w = dst_fim.shape
    covered = dst_fim >= 0
    idx = torch.where(covered, dst_fim, 0).long().reshape(b, -1)
    src = src_f2pts.expand(b, *src_f2pts.shape[1:])
    gathered = src[torch.arange(b, device=idx.device)[:, None], idx]
    gathered = gathered.reshape(b, h, w, 3, 2)              # (B, H, W, 3, 2)
    with full_fp32():
        t = torch.einsum("bhwk,bhwkc->bhwc", dst_wim, gathered)
    return torch.where(covered[..., None], t, BG_FLOW)


def identity_flow(batch: int, image_size: int, device=None,
                  dtype=torch.float32):
    """Identity sampling grid (B, S, S, 2) in [-1, 1], (x, y) order, on
    the reference's ``i / (S - 1)`` grid (create_meshgrid)."""
    f = (torch.arange(image_size, dtype=dtype, device=device)
         / (image_size - 1) - 0.5) * 2.0
    yv, xv = torch.meshgrid(f, f, indexing="ij")
    grid = torch.stack([xv, yv], dim=-1)
    return grid.expand(batch, image_size, image_size, 2)


def face_visibility(fim, nf: int):
    """(B, H, W) fim -> (B, nf) bool: the face appears in the map."""
    b = fim.shape[0]
    flat = fim.reshape(b, -1).long()
    safe = torch.where(flat >= 0, flat, nf)
    vis = torch.zeros((b, nf + 1), dtype=torch.int32, device=fim.device)
    vis.scatter_add_(1, safe, torch.ones_like(safe, dtype=torch.int32))
    return vis[:, :nf] > 0


def visible_f2pts(f2pts, fim):
    """Keep only faces visible in fim; the others get BG_FLOW."""
    vis = face_visibility(fim, f2pts.shape[1])
    return torch.where(vis[:, :, None, None], f2pts, BG_FLOW)


def null_visible_f2pts(f2pts, fim):
    """Null the faces visible in fim (BG_FLOW); keep the others."""
    vis = face_visibility(fim, f2pts.shape[1])
    return torch.where(vis[:, :, None, None], BG_FLOW, f2pts)


def encode_fim(fim, map_fn):
    """fim (B, H, W) with -1 background, map_fn (nf+1, C) whose last row
    is the background code -> (B, H, W, C)."""
    nf = map_fn.shape[0] - 1
    return map_fn[torch.where(fim < 0, nf, fim).long()]
