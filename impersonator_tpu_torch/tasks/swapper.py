"""Appearance transfer (torch port of
``impersonator_tpu/tasks/swapper.py:29-218``).

Personalise the source and the target, then build two flows on the
source's raster: T11, the identity grid on the source parts that are
kept, and T21, the target's image positions on the source pixels of the
swapped parts (the target's kept-part faces nulled, then mapped through
the source's fim and wim). The generator's dual-source ``swap`` decodes
against both feature caches. Parts come from the 11-channel ``par``
face encoding (10 parts in sorted order, then background).
"""

from __future__ import annotations

import numpy as np
import torch

from impersonator_tpu_torch.config import TestConfig
from impersonator_tpu_torch.ops import flow as flow_ops
from impersonator_tpu_torch.ops.sampler import grid_sample_nchw
from impersonator_tpu_torch.tasks.imitator import (Imitator, _from_net,
                                                   _to_net, cast_feats,
                                                   paste_front)
from impersonator_tpu_torch.tasks.renderer import SMPLRenderer

# part channels of the sorted 'par' encoding that each swap takes from
# the target; the others (part 0, the head, for "body") stay the source's
PART_IDS = {
    "body": [1, 2, 3, 4, 5, 6, 7, 8, 9],
    "all": [0, 1, 2, 3, 4, 5, 6, 7, 8, 9],
}


def swap_smpl_preserve_scale(src_cam, src_shape, tgt_smpl):
    """The target's pose with the source's scale and shape; the target's
    translation rescaled by the scale ratio, plus the source's."""
    tgt_cam = tgt_smpl[:, 0:3]
    pose = tgt_smpl[:, 3:75]
    scale = src_cam[:, 0:1]
    trans = (src_cam[:, 0:1] / tgt_cam[:, 0:1]) * tgt_cam[:, 1:] \
        + src_cam[:, 1:]
    return torch.cat([scale, trans, pose, src_shape], dim=1)


@torch.no_grad()
def swap_core(nets, renderer: SMPLRenderer, src_state, tgt_state,
              left_faces: torch.Tensor, selected_ids, left_ids,
              front_warp: bool = False, compute_dtype=torch.float32):
    """Both personalised states (each with its ``part`` encoding) ->
    preds (1, S, S, 3): the selected parts from the target, the left
    parts from the source. left_faces: the face ids of the left parts."""
    part_src = src_state["part"]                              # (1, S, S, 11)
    src_part_mask = part_src[..., list(selected_ids)].sum(-1) != 0
    src_left_mask = (part_src[..., list(left_ids)].sum(-1) != 0 if left_ids
                     else torch.zeros_like(src_part_mask))

    grid = flow_ops.identity_flow(1, renderer.image_size,
                                  device=part_src.device)
    t11 = torch.where(src_left_mask[..., None], grid, flow_ops.BG_FLOW)
    tsf_f2p = tgt_state["p2verts"]
    if left_faces.numel():
        tsf_f2p = tsf_f2p.clone()
        tsf_f2p[:, left_faces] = flow_ops.BG_FLOW
    t21 = renderer.cal_bc_transform(tsf_f2p, src_state["fim"],
                                    src_state["wim"]).clamp(-2.0, 2.0)

    # both warps in the compute dtype, as the imitation warp
    tsf21 = grid_sample_nchw(_to_net(tgt_state["img"], compute_dtype), t21)
    tsf11 = grid_sample_nchw(_to_net(src_state["img"], compute_dtype), t11)
    tsf_img = (tsf21 * src_part_mask[:, None].to(tsf21.dtype)
               + tsf11 * src_left_mask[:, None].to(tsf11.dtype))
    tsf_inputs = torch.cat([tsf_img, _to_net(src_state["cond"],
                                             compute_dtype)], dim=1)
    enc21, res21 = cast_feats(tgt_state["feats"], compute_dtype)
    enc11, res11 = cast_feats(src_state["feats"], compute_dtype)
    color, mask = nets.generator.swap(tsf_inputs, enc21, enc11, res21, res11,
                                      t21, t11)
    color, mask = _from_net(color), _from_net(mask)
    preds = mask * src_state["bg"] + (1.0 - mask) * color
    if front_warp:
        preds = paste_front(renderer, preds, src_state["fim"],
                            src_state["img"], mask)
    return preds


class Swapper(Imitator):
    """``swap_setup(src, tgt)`` personalises both images, ``swap(part)``
    transfers the target's appearance onto the source, and
    ``imitate_by_smpls`` drives a personalised state (such as the
    swapped image's) through a motion. On one device (``device``, default
    CUDA; no CPU fallback). Personalises in float32 with the master."""

    source_in_compute_dtype = False

    def __init__(self, cfg: TestConfig, assets=None, nets=None,
                 device="cuda"):
        super().__init__(cfg, assets, nets, device)
        self.part_fn = torch.as_tensor(self.assets.map_fn("par"),
                                       device=self.device)
        part_faces = self.assets.part_face_ids("par")
        self.part_faces = [part_faces[k] for k in sorted(part_faces)]
        self._left_faces = {}
        self.tsf_info = None

    def personalize(self, img, smpl=None):
        """img (S, S, 3) in [-1, 1]; smpl (85,) θ, or None for HMR's ->
        the personalised state with its ``par`` encoding (kept by
        :meth:`swap_setup`, not here). With a detector, its body mask
        takes the place of the eroded silhouette for the background."""
        state = self._source_state(img, smpl, self._detect(img))
        state["part"] = self.renderer.encode_fim(state["fim"], self.part_fn)
        return state

    def swap_setup(self, src_img, tgt_img, src_smpl=None, tgt_smpl=None):
        self.src_info = self.personalize(src_img, src_smpl)
        self.tsf_info = self.personalize(tgt_img, tgt_smpl)

    def left_faces(self, target_part: str) -> torch.Tensor:
        """The face ids of the parts a swap of target_part leaves to the
        source, on the device (cached per part)."""
        if target_part not in self._left_faces:
            left = [i for i in PART_IDS["all"]
                    if i not in PART_IDS[target_part]]
            ids = (np.unique(np.concatenate([self.part_faces[i]
                                             for i in left]))
                   if left else np.zeros((0,), np.int64))
            self._left_faces[target_part] = torch.as_tensor(
                ids.astype(np.int64), device=self.device)
        return self._left_faces[target_part]

    def swap(self, src_info=None, tgt_info=None, target_part: str = "body"):
        """-> preds (1, S, S, 3): target_part ("body" or "all") from the
        target, on the source's pose and background."""
        if target_part not in PART_IDS:
            raise ValueError(f"target_part must be one of {list(PART_IDS)}")
        src_info = src_info if src_info is not None else self.src_info
        tgt_info = tgt_info if tgt_info is not None else self.tsf_info
        if src_info is None or tgt_info is None:
            raise RuntimeError("call swap_setup() first")
        selected = PART_IDS[target_part]
        left = [i for i in PART_IDS["all"] if i not in selected]
        return swap_core(self.compute_nets, self.renderer, src_info,
                         tgt_info, self.left_faces(target_part), selected,
                         left, self.cfg.front_warp, self.compute_dtype)

    def imitate_by_smpls(self, src_state, tgt_smpls,
                         cam_strategy: str = "copy", batch: int = 8):
        """Drive src_state (for example :meth:`personalize` of a swapped
        image) through tgt_smpls (N, 85) -> preds (N, S, S, 3)."""
        return self._imitate_by_smpls(src_state, tgt_smpls, cam_strategy,
                                      batch)
