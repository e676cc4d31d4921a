"""Novel view synthesis (torch port of
``impersonator_tpu/tasks/viewer.py:28-192``).

Personalise a source image, then for each view (R, t) move the source's
SMPL vertices by ``verts @ R + t`` (the reference's row-vector
convention), rasterise them under the SOURCE camera with the fused
raster + flow kernel, and decode against the cached source features. A
batch of views is one kernel launch; the source side stays batch 1.
"""

from __future__ import annotations

import torch

from impersonator_tpu_torch.ops import smpl as smpl_ops
from impersonator_tpu_torch.ops.projection import euler_to_matrix
from impersonator_tpu_torch.tasks.imitator import Imitator, imitate_from_flow
from impersonator_tpu_torch.tasks.post_tune import adaptive_personalize
from impersonator_tpu_torch.tasks.renderer import SMPLRenderer
from impersonator_tpu_torch.utils.precision import full_fp32


def rotate_verts(verts, rot_mats, trans):
    """verts (1, nv, 3), rot_mats (N, 3, 3), trans (N, 3) ->
    verts @ R + t, (N, nv, 3)."""
    n = rot_mats.shape[0]
    with full_fp32():
        return (torch.einsum("nvc,ncd->nvd",
                             verts.expand(n, *verts.shape[1:]), rot_mats)
                + trans[:, None, :])


@torch.no_grad()
def view_core(nets, renderer: SMPLRenderer, src_state, rot_mats, trans,
              bg_replace: bool = False, front_warp: bool = False,
              compute_dtype=torch.float32):
    """rot_mats (N, 3, 3), trans (N, 3) -> preds (N, S, S, 3): the views
    composited over the source's background (``bg_replace``) or over
    zeros."""
    mesh = rotate_verts(src_state["verts"], rot_mats, trans)
    cam = src_state["cam"].expand(rot_mats.shape[0], 3)
    fim, t = renderer.render_flow(cam, mesh, src_state["p2verts"])
    return view_from_flow(nets, renderer, src_state, fim, t, bg_replace,
                          front_warp, compute_dtype)


def view_from_flow(nets, renderer, src_state, fim, t, bg_replace=False,
                   front_warp=False, compute_dtype=torch.float32):
    """Everything of :func:`view_core` after the raster: the imitation
    tail over the chosen background."""
    if not bg_replace:
        src_state = {**src_state, "bg": torch.zeros_like(src_state["bg"])}
    return imitate_from_flow(nets, renderer, src_state, fim, t,
                             renderer.encode_fim(fim), front_warp,
                             compute_dtype)


class Viewer(Imitator):
    """``personalize`` once (it keeps the source's vertices), then
    ``view``, ``view_sweep`` or ``view_by_smpls``. On one device
    (``device``, default CUDA; no CPU fallback). Personalises in float32
    with the master."""

    source_in_compute_dtype = False

    def personalize(self, img, smpl=None):
        """img (S, S, 3) in [-1, 1]; smpl (85,) θ, or None for HMR's."""
        state = self._source_state(img, smpl)
        state["verts"] = smpl_ops.get_details(
            self.smpl_params, state["theta"], self.parents)["verts"]
        self.src_info = state
        return state

    def _view(self, rot_mats, trans):
        self._require_source()
        return view_core(self.compute_nets, self.renderer, self.src_info,
                         rot_mats, trans, self.cfg.bg_replace,
                         self.cfg.front_warp, self.compute_dtype)

    def view(self, rt, t):
        """One view: Euler angles rt (degrees) and translation t, as the
        reference's --view_params -> (1, S, S, 3)."""
        r = euler_to_matrix(rt, device=self.device)[None]
        tr = torch.as_tensor(t, dtype=torch.float32, device=self.device)
        return self._view(r, tr[None])

    def view_sweep(self, yaws, t=(0.0, 0.0, 0.0)):
        """Yaws (degrees) -> (len(yaws), S, S, 3), all in one batch."""
        rots = torch.stack([euler_to_matrix([0.0, y, 0.0],
                                            device=self.device)
                            for y in yaws])
        trans = torch.as_tensor(t, dtype=torch.float32,
                                device=self.device).expand(len(yaws), 3)
        return self._view(rots, trans)

    def view_by_smpls(self, tgt_smpls, batch: int = 8):
        """Views given by θs (N, 85) that share the source's body and
        differ in global orientation: the source's vertices turned about
        the shaped root joint j0, v' = M (v - j0) + j0 with
        M = R_tgt R_srcᵀ, so R = Mᵀ and t = j0 - j0 R in the row
        convention; the SOURCE camera for every view. In fixed-size
        batches (the last one padded) -> (N, S, S, 3)."""
        self._require_source()
        smpls = torch.as_tensor(tgt_smpls, dtype=torch.float32,
                                device=self.device)
        n = smpls.shape[0]
        p = self.smpl_params
        with full_fp32():
            r_src = smpl_ops.batch_rodrigues(self.src_info["theta"][0, 3:6])
            r_tgt = smpl_ops.batch_rodrigues(smpls[:, 3:6])
            rots = torch.einsum("nab,cb->nac", r_tgt, r_src).transpose(1, 2)
            v_shaped = ((self.src_info["shape"] @ p.shapedirs)
                        .reshape(1, -1, 3) + p.v_template)
            j0 = torch.einsum("nvc,v->nc", v_shaped, p.j_regressor[:, 0])[0]
            trans = j0 - torch.einsum("c,ncd->nd", j0, rots)
        pad = (-n) % batch
        if pad:
            rots = torch.cat([rots, rots[-1:].expand(pad, 3, 3)])
            trans = torch.cat([trans, trans[-1:].expand(pad, 3)])
        outs = [self._view(rots[i:i + batch], trans[i:i + batch])
                for i in range(0, n + pad, batch)]
        return torch.cat(outs)[:n]

    def post_personalize(self, prior_smpls=None, epochs: int = 5,
                         lr: float = 2e-4):
        """Post-tune with the Imitator's recipe
        (:func:`..post_tune.adaptive_personalize`, no face loss), then the
        source's vertices again, which the refresh does not keep."""
        metrics = adaptive_personalize(self, prior_smpls, epochs=epochs,
                                       lr=lr)
        self.src_info["verts"] = smpl_ops.get_details(
            self.smpl_params, self.src_info["theta"], self.parents)["verts"]
        return metrics
