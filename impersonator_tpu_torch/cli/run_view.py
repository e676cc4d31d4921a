"""Novel-view CLI (torch port of ``impersonator_tpu/cli/run_view.py``):
a yaw sweep, or one (R, t) from ``--view_params``.

    python -m impersonator_tpu_torch.cli.run_view --src_path src.jpg \\
        [--T_pose] [--device cpu]

Writes ``view_###.png`` (and ``views.mp4`` when the host has ffmpeg).
``--device`` defaults to cuda, with no fallback when there is no card.
"""

from __future__ import annotations

import os

import numpy as np

from impersonator_tpu_torch.cli.run_swap import device_of
from impersonator_tpu_torch.config import TestConfig, from_args
from impersonator_tpu_torch.tasks.viewer import Viewer
from impersonator_tpu_torch.utils import cv_utils
from impersonator_tpu_torch.utils.video import frames_to_mp4


def main(argv=None, sweep: bool = True, n_views: int = 16):
    cfg = from_args(TestConfig, argv)
    device = device_of(argv)
    cfg.save("test")
    viewer = Viewer(cfg, device=device)

    src = cv_utils.resize_img_hwc(cv_utils.read_img(cfg.src_path, device),
                                  cfg.image_size)
    viewer.personalize(src)

    if cfg.T_pose:
        # personalise again in the canonical T-pose: articulation zeroed,
        # the source's camera and shape kept
        theta = viewer.src_info["theta"].clone()
        theta[:, 3:75] = 0.0
        viewer.personalize(src, smpl=theta[0])

    if sweep:
        yaws = np.linspace(0, 360, n_views, endpoint=False)
        preds = viewer.view_sweep(list(yaws))
    else:
        vp = cfg.parse_view_params()
        preds = viewer.view(vp["R"], vp["t"])
    preds = preds.cpu().numpy()

    if cfg.save_res and cfg.output_dir:
        os.makedirs(cfg.output_dir, exist_ok=True)
        for i, p in enumerate(preds):
            cv_utils.save_img(p, os.path.join(cfg.output_dir,
                                              f"view_{i:03d}.png"),
                              device=device)
        if len(preds) > 1:
            try:
                frames_to_mp4(preds, os.path.join(cfg.output_dir, "views.mp4"))
            except RuntimeError as e:
                print(f"skipping video encode: {e}")
    print(f"rendered {len(preds)} views -> {cfg.output_dir}")
    return preds


if __name__ == "__main__":
    main()
