"""Camera / projection helpers for the renderer (torch port of
``impersonator_tpu/ops/projection.py``): the weak-perspective projection,
the renderer's on-axis ``look_at``, the neural renderer's general
``look_at`` / ``look`` / ``perspective`` / ``get_points_from_angles``, and
the novel-view Euler rotation."""

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


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v), min=1e-5)


def _camera_transform(vertices, eye, z_axis, up):
    """(vertices - eye) in the camera frame whose z axis is ``z_axis``."""
    x_axis = _unit(torch.linalg.cross(up, z_axis))
    y_axis = _unit(torch.linalg.cross(z_axis, x_axis))
    r = torch.stack([x_axis, y_axis, z_axis], dim=0)   # rows are the axes
    with full_fp32():
        return (vertices - eye) @ r.T


def _vec(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def look_at(vertices: torch.Tensor, eye, at=(0.0, 0.0, 0.0),
            up=(0.0, 1.0, 0.0)) -> torch.Tensor:
    """The neural renderer's "look at" camera transform: vertices
    (B, N, 3) in the frame of a camera at ``eye`` looking at ``at``."""
    eye, at, up = (_vec(v, vertices) for v in (eye, at, up))
    return _camera_transform(vertices, eye, _unit(at - eye), up)


def look(vertices: torch.Tensor, eye, direction=(0.0, 1.0, 0.0),
         up=(0.0, 1.0, 0.0)) -> torch.Tensor:
    """:func:`look_at` with the camera's z axis given as a direction
    rather than a target point."""
    eye, direction, up = (_vec(v, vertices) for v in (eye, direction, up))
    return _camera_transform(vertices, eye, _unit(direction), up)


def perspective(vertices: torch.Tensor, angle: float = 30.0) -> torch.Tensor:
    """Perspective divide for a half viewing angle (degrees): x, y :=
    x, y / (z tan(angle)); z kept. vertices (B, N, 3)."""
    width = math.tan(math.radians(angle))
    z = vertices[..., 2]
    x = vertices[..., 0] / z / width
    y = vertices[..., 1] / z / width
    return torch.stack([x, y, z], dim=-1)


def get_points_from_angles(distance, elevation, azimuth,
                           degrees: bool = True, device=None):
    """A spherical camera position -> its eye xyz, float32: (3,) from
    scalars, (N, 3) from arrays (broadcast)."""
    distance, elevation, azimuth = (
        torch.as_tensor(v, dtype=torch.float32, device=device)
        for v in (distance, elevation, azimuth))
    if degrees:
        elevation = elevation * (math.pi / 180.0)
        azimuth = azimuth * (math.pi / 180.0)
    return torch.stack([
        distance * torch.cos(elevation) * torch.sin(azimuth),
        distance * torch.sin(elevation),
        -distance * torch.cos(elevation) * torch.cos(azimuth),
    ], dim=-1)


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
