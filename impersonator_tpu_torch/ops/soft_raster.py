"""Differentiable soft silhouette (torch port of
``impersonator_tpu/ops/soft_raster.py:30-142``).

The hard z-buffer has no gradient. This relaxation gives each pixel a
coverage probability per face from its squared distance to the face's
boundary, the SoftRas form (Liu et al., ICCV 2019):

    p_f(x) = sigmoid(sign(x in f) · d²(x, ∂f) / σ)
    sil(x) = 1 − Π_f (1 − p_f(x)),

and autograd differentiates it. The product runs over chunks of 256
faces as a running Σ log(1 − p), as in the JAX package. With gradients
on, each chunk is recomputed in the backward pass
(``torch.utils.checkpoint``), so only the (B, S²) running sum is held per
chunk, not the (B, S², 256) terms.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def _point_segment_dist2(px, py, ax, ay, bx, by):
    """Squared distance from (px, py) to the segment a-b, broadcast over
    (B, P, C); the projection clamped to the segment."""
    abx, aby = bx - ax, by - ay
    apx, apy = px - ax, py - ay
    denom = abx * abx + aby * aby
    t = ((apx * abx + apy * aby) / denom.clamp(min=1e-12)).clamp(0.0, 1.0)
    dx = apx - t * abx
    dy = apy - t * aby
    return dx * dx + dy * dy


def _chunk_log_keep(xv, yv, xp, yp, sigma: float, cull_backfaces: bool):
    """Σ over one chunk's faces of log(1 − p_f): xv, yv (B, C, 3) vertex
    coordinates, xp, yp (P,) pixel centres -> (B, P)."""
    fx = [xv[..., k][:, None, :] for k in range(3)]          # (B, 1, C)
    fy = [yv[..., k][:, None, :] for k in range(3)]
    px, py = xp[None, :, None], yp[None, :, None]            # (1, P, 1)
    # the hard rasterizer's three edge functions
    t0 = (py - fy[0]) * (fx[1] - fx[0]) - (px - fx[0]) * (fy[1] - fy[0])
    t1 = (py - fy[1]) * (fx[2] - fx[1]) - (px - fx[1]) * (fy[2] - fy[1])
    t2 = (py - fy[2]) * (fx[0] - fx[2]) - (px - fx[2]) * (fy[0] - fy[2])
    inside = (t0 >= 0) & (t1 >= 0) & (t2 >= 0)
    # a face of zero signed area passes all three tests everywhere: it
    # never contributes
    area = ((fy[2] - fy[0]) * (fx[1] - fx[0])
            - (fy[1] - fy[0]) * (fx[2] - fx[0]))
    if cull_backfaces:
        keep = area > 0
    else:
        keep = area != 0
        inside = inside & (area > 0)
    d2 = torch.minimum(
        _point_segment_dist2(px, py, fx[0], fy[0], fx[1], fy[1]),
        torch.minimum(
            _point_segment_dist2(px, py, fx[1], fy[1], fx[2], fy[2]),
            _point_segment_dist2(px, py, fx[2], fy[2], fx[0], fy[0])))
    sign = torch.where(inside, 1.0, -1.0)
    prob = torch.sigmoid(sign * d2 / sigma)
    prob = torch.where(keep, prob, torch.zeros_like(prob))
    prob = prob.clamp(0.0, 1.0 - 1e-7)
    return torch.log1p(-prob).sum(-1)


def soft_silhouette(face_verts, image_size: int = 64, sigma: float = 3e-4,
                    chunk: int = 256, cull_backfaces: bool = True):
    """Differentiable coverage map (B, S, S) float32 in [0, 1), flipped
    vertically as the hard rasterizer's maps are.

    face_verts (B, nf, 3, 3) in raster space (ops.rasterizer.
    project_to_raster_space); only x and y take part. σ sets the edge
    softness in squared normalised coordinates. ``cull_backfaces`` leaves
    faces of negative signed area out; without it they contribute their
    edge falloff but are never inside."""
    face_verts = face_verts.float()
    b = face_verts.shape[0]
    s = image_size
    xi = torch.arange(s, dtype=torch.float32, device=face_verts.device)
    xp = ((2.0 * xi + 1.0 - s) / s).repeat(s)              # x fastest
    yp = ((2.0 * xi + 1.0 - s) / s).repeat_interleave(s)
    xv, yv = face_verts[..., 0], face_verts[..., 1]
    grad = torch.is_grad_enabled() and face_verts.requires_grad
    log_keep = torch.zeros(b, s * s, dtype=torch.float32,
                           device=face_verts.device)
    for lo in range(0, face_verts.shape[1], chunk):
        args = (xv[:, lo:lo + chunk], yv[:, lo:lo + chunk], xp, yp, sigma,
                cull_backfaces)
        if grad:
            log_keep = log_keep + checkpoint(_chunk_log_keep, *args,
                                             use_reentrant=False)
        else:
            log_keep = log_keep + _chunk_log_keep(*args)
    sil = 1.0 - torch.exp(log_keep)
    return sil.reshape(b, s, s).flip(1)
