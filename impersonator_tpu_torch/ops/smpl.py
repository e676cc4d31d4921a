"""Batched SMPL linear-blend skinning (torch port of
``impersonator_tpu/ops/smpl.py:32-198``).

Geometry stays float32. On CUDA the matmuls must run in full fp32, as the
JAX package runs them at HIGHEST precision: :func:`smpl_forward` runs
under ``utils.precision.full_fp32``, whatever the process's TF32 flags.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from impersonator_tpu_torch.assets import NUM_JOINTS, SMPLAssets
from impersonator_tpu_torch.utils.precision import full_fp32


@dataclasses.dataclass(frozen=True)
class SMPLParams:
    """Device-resident SMPL constants."""

    v_template: torch.Tensor      # (nv, 3)
    shapedirs: torch.Tensor       # (10, nv*3)
    posedirs: torch.Tensor        # (207, nv*3)
    j_regressor: torch.Tensor     # (nv, 24)
    lbs_weights: torch.Tensor     # (nv, 24)
    joint_regressor: torch.Tensor  # (nv, 19)
    faces: torch.Tensor           # (nf, 3) int64

    @classmethod
    def from_assets(cls, assets: SMPLAssets, device) -> "SMPLParams":
        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return cls(
            v_template=f32(assets.v_template),
            shapedirs=f32(assets.shapedirs),
            posedirs=f32(assets.posedirs),
            j_regressor=f32(assets.j_regressor),
            lbs_weights=f32(assets.lbs_weights),
            joint_regressor=f32(assets.joint_regressor),
            faces=torch.as_tensor(np.asarray(assets.faces, np.int64),
                                  device=device),
        )


def batch_rodrigues(theta: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3), with the
    reference's elementwise +1e-8 before the norm."""
    shifted = theta + 1e-8
    angle = torch.linalg.norm(shifted, dim=-1, keepdim=True)
    r = shifted / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    outer = r[..., :, None] * r[..., None, :]
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    rx, ry, rz = r[..., 0], r[..., 1], r[..., 2]
    zeros = torch.zeros_like(rx)
    skew = torch.stack([
        torch.stack([zeros, -rz, ry], dim=-1),
        torch.stack([rz, zeros, -rx], dim=-1),
        torch.stack([-ry, rx, zeros], dim=-1),
    ], dim=-2)
    return cos * eye + (1.0 - cos) * outer + sin * skew


def _rigid_chain(rots: torch.Tensor, joints: torch.Tensor,
                 parents: np.ndarray):
    """Forward kinematics: rots (N,24,3,3), joints (N,24,3) -> posed
    joints (N,24,3) and relative LBS transforms (N,24,4,4)."""
    n = rots.shape[0]
    parents = np.asarray(parents)
    bones = joints - joints[:, torch.as_tensor(parents, device=joints.device)]
    bones[:, 0] = joints[:, 0]
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rots.dtype,
                          device=rots.device).expand(n, NUM_JOINTS, 1, 4)
    local = torch.cat([torch.cat([rots, bones[..., None]], dim=-1), bottom],
                      dim=-2)                                # (N, 24, 4, 4)
    results = [local[:, 0]]
    for i in range(1, NUM_JOINTS):
        results.append(torch.matmul(results[int(parents[i])], local[:, i]))
    stacked = torch.stack(results, dim=1)                    # (N, 24, 4, 4)
    posed_joints = stacked[:, :, :3, 3]
    # subtract the transform of the rest joint, so skinning moves vertices
    # by the bone motion only
    init_bone = torch.einsum("njab,njb->nja", stacked[..., :3],
                             joints)                          # (N, 24, 4)
    rel = stacked.clone()
    rel[..., 3] = stacked[..., 3] - init_bone
    return posed_joints, rel


def smpl_forward(params: SMPLParams, beta: torch.Tensor, theta: torch.Tensor,
                 parents: np.ndarray):
    """(beta (N,10), theta (N,72)) -> verts (N,nv,3), cocoplus joints
    (N,19,3), rotations (N,24,3,3)."""
    n = beta.shape[0]
    nv = params.v_template.shape[0]
    with full_fp32():
        v_shaped = ((beta @ params.shapedirs).reshape(n, nv, 3)
                    + params.v_template)
        j = torch.einsum("nvc,vj->njc", v_shaped, params.j_regressor)
        rots = batch_rodrigues(theta.reshape(n, NUM_JOINTS, 3))
        eye = torch.eye(3, dtype=rots.dtype, device=rots.device)
        pose_feature = (rots[:, 1:] - eye).reshape(n, -1)
        v_posed = ((pose_feature @ params.posedirs).reshape(n, nv, 3)
                   + v_shaped)
        _, rel = _rigid_chain(rots, j, parents)
        t_mats = torch.einsum("vj,njab->nvab", params.lbs_weights, rel)
        v_homo = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])],
                           dim=-1)
        verts = torch.einsum("nvab,nvb->nva", t_mats, v_homo)[..., :3]
        joints = torch.einsum("nvc,vk->nkc", verts, params.joint_regressor)
    return verts, joints, rots


def batch_orth_proj_idrot(x: torch.Tensor, camera: torch.Tensor):
    """Weak-perspective projection (N, P, 3), cam (N, 3) -> (N, P, 2)."""
    return camera[:, None, 0:1] * (x[..., :2] + camera[:, None, 1:])


def get_details(params: SMPLParams, theta85: torch.Tensor,
                parents: np.ndarray) -> dict:
    """Split an 85-dim theta into cam/pose/shape and run SMPL."""
    cam = theta85[:, 0:3]
    pose = theta85[:, 3:75]
    shape = theta85[:, 75:]
    verts, j3d, _ = smpl_forward(params, shape, pose, parents)
    return {
        "theta": theta85, "cam": cam, "pose": pose, "shape": shape,
        "verts": verts, "j2d": batch_orth_proj_idrot(j3d, cam), "j3d": j3d,
    }
