"""Camera / projection helpers for the renderer (torch port of
``impersonator_tpu/ops/projection.py:17-60, 117-133``)."""

from __future__ import annotations

import math

import torch

from impersonator_tpu_torch.utils.precision import full_fp32


def eye_z(viewing_angle_deg: float = 30.0) -> float:
    """Renderer eye distance: 1/tan(view_angle) + 1."""
    return 1.0 / math.tan(math.radians(viewing_angle_deg)) + 1.0


DEFAULT_EYE_Z = eye_z()


def orthographic_proj_withz_idrot(x: torch.Tensor, cam: torch.Tensor,
                                  offset_z: float = 0.0) -> torch.Tensor:
    """x (B, N, 3), cam (B, 3 = [s, tx, ty]) -> (B, N, 3):
    xy := s * (xy + t); z preserved (+offset)."""
    scale = cam[:, 0][:, None, None]
    trans = cam[:, None, 1:3]
    xy = scale * (x[..., :2] + trans)
    z = x[..., 2:3] + offset_z
    return torch.cat([xy, z], dim=-1)


def look_at_on_axis(vertices: torch.Tensor,
                    eye_z_value: float = DEFAULT_EYE_Z) -> torch.Tensor:
    """The renderer's look_at for its fixed eye on -z: a z-translation."""
    shift = torch.tensor([0.0, 0.0, eye_z_value], dtype=vertices.dtype,
                         device=vertices.device)
    return vertices + shift


def euler_to_matrix(rt, deg: bool = True,
                    device=None) -> torch.Tensor:
    """Euler angles (3,) -> rotation matrix (3, 3) float32,
    R = Rz @ Ry @ Rx (the reference's euler2matrix); degrees unless
    ``deg`` is false."""
    rt = torch.as_tensor(rt, dtype=torch.float32, device=device)
    if deg:
        rt = rt * (math.pi / 180.0)
    cx, cy, cz = torch.cos(rt)
    sx, sy, sz = torch.sin(rt)
    one, zero = torch.ones_like(cx), torch.zeros_like(cx)
    rx = torch.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx])
    ry = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy])
    rz = torch.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one])
    with full_fp32():
        return rz.reshape(3, 3) @ ry.reshape(3, 3) @ rx.reshape(3, 3)
