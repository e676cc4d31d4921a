"""Sequence animator (torch port of
``impersonator_tpu/tasks/animator.py:21-50``): a θ sequence through the
imitation core in fixed-size batches, with chosen body parts held at
the source's pose."""

from __future__ import annotations

import numpy as np
import torch

from impersonator_tpu_torch.tasks.imitator import Imitator


class Animator(Imitator):
    """Imitator for long sequences."""

    def animate(self, smpl_sequence, cam_strategy: str = "smooth",
                batch: int = 16, freeze_parts=()):
        """smpl_sequence (T, 85) -> preds (T, S, S, 3); the axis-angles of
        each part in freeze_parts stay the source's across the sequence
        (needs :meth:`personalize` first)."""
        seq = np.array(torch.as_tensor(smpl_sequence,
                                       dtype=torch.float32).cpu(), copy=True)
        if freeze_parts and self.src_info is not None:
            src_pose = self.src_info["pose"][0].cpu().numpy()
            for part in freeze_parts:
                for j in _PART_JOINTS.get(part, ()):
                    seq[:, 3 + 3 * j: 6 + 3 * j] = src_pose[3 * j: 3 * j + 3]
        return self.inference_by_smpls(seq, cam_strategy=cam_strategy,
                                       batch=batch)


# part name -> SMPL joint ids whose axis-angle is frozen
_PART_JOINTS = {
    "01_head": (12, 15),
    "02_torso": (0, 3, 6, 9, 13, 14),
    "03_left_upper_arm": (16, 18),
    "04_left_lower_arm": (20, 22),
    "05_right_upper_arm": (17, 19),
    "06_right_lower_arm": (21, 23),
    "07_left_upper_leg": (1, 4),
    "08_left_lower_leg": (7, 10),
    "09_right_upper_leg": (2, 5),
    "10_right_lower_leg": (8, 11),
}
