"""Build a prior-pose bank pickle from a directory of images (the port's
counterpart of ``tools/make_prior_poses.py``).

The reference's adaptive personalisation renders poses recovered from
``assets/samples/A_priors`` images. This tool runs HMR over them once
(``models.hmr``, in full float32: ``utils.precision.full_fp32``) and
saves the θs as the ``{cams, pose, shape}`` pickle both packages'
``tasks.post_tune.load_prior_poses`` read, so ``run_imitator --post_tune
--prior_poses priors.pkl`` follows the reference recipe:

    python -m impersonator_tpu_torch.tools.make_prior_poses \\
        --img_dir A_priors/ --out priors.pkl [--hmr_ckpt hmr_tf2pt.pth] \\
        [--itv 40] [--batch 16] [--device cpu]

``--hmr_ckpt`` takes the released ``.pth`` or the JAX package's HMR
msgpack; without it HMR has seeded random weights (a smoke run). Every
``itv``-th image is taken; the last batch is padded to ``--batch`` with
its last image, as the JAX tool pads it (HMR is in eval mode, so the
padding changes no θ).
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle

import numpy as np
import torch

from impersonator_tpu_torch.tools import (add_device_arg, net_state_dict,
                                          resolve_device)


def load_hmr(path: str, device):
    """HumanModelRecovery from ``path`` (``.pth`` or msgpack), or seeded
    random weights (the JAX init's distributions, mean θ 0) without
    one; eval mode on ``device``."""
    from impersonator_tpu_torch.models.hmr import HumanModelRecovery, init_hmr
    hmr = HumanModelRecovery()
    if path:
        hmr.load_state_dict(net_state_dict("hmr", path), strict=True)
    else:
        init_hmr(hmr, torch.Generator().manual_seed(0), np.zeros(85),
                 fc3_scale=1.0)
    return hmr.to(device).eval().requires_grad_(False)


@torch.no_grad()
def regress(hmr, imgs224: np.ndarray, device) -> np.ndarray:
    """(B, 224, 224, 3) images -> (B, 85) float32 θs on the host."""
    return hmr(torch.from_numpy(np.ascontiguousarray(imgs224)).to(device)) \
        .float().cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--img_dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--hmr_ckpt", default="",
                    help="released HMR .pth or JAX msgpack; random weights "
                         "if absent (smoke only)")
    ap.add_argument("--itv", type=int, default=40,
                    help="take every itv-th frame (scan_tgt_paths itv=40)")
    ap.add_argument("--batch", type=int, default=16)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from impersonator_tpu_torch.utils import cv_utils

    paths = sorted(glob.glob(os.path.join(args.img_dir, "*")))[::args.itv]
    if not paths:
        raise SystemExit(f"no images under {args.img_dir}")
    if not args.hmr_ckpt:
        print("make_prior_poses: no --hmr_ckpt, using random HMR weights")
    hmr = load_hmr(args.hmr_ckpt, device)

    thetas = []
    for i in range(0, len(paths), args.batch):
        chunk = paths[i:i + args.batch]
        imgs = np.stack([
            cv_utils.resize_img_hwc(cv_utils.read_img(p, device), 224)
            for p in chunk])
        pad = args.batch - len(chunk)
        if pad:
            imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, 0)])
        thetas.append(regress(hmr, imgs, device)[:len(chunk)])
    arr = np.concatenate(thetas).astype(np.float32)

    with open(args.out, "wb") as f:
        pickle.dump({"cams": arr[:, :3], "pose": arr[:, 3:75],
                     "shape": arr[:, 75:]}, f)
    print(f"wrote {arr.shape[0]} prior poses -> {args.out}")
    return arr


if __name__ == "__main__":
    main()
