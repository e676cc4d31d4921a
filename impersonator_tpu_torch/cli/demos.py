"""Demo entry points (torch port of ``impersonator_tpu/cli/demos.py``):
imitation, appearance transfer and novel view on canned or synthetic
sources, written as PNG strips (and mp4s when the host has ffmpeg).

    python -m impersonator_tpu_torch.cli.demos imitator [--src_dir ...]
    python -m impersonator_tpu_torch.cli.demos swap --device cpu
    python -m impersonator_tpu_torch.cli.demos view

With no ``--src_dir`` the sources are deterministic synthetic images.
``--device`` defaults to cuda, with no fallback when there is no card.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

from impersonator_tpu_torch.config import TestConfig, from_args
from impersonator_tpu_torch.utils import cv_utils


def _synthetic_image(seed: int, size: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
    # blocky "person": head + torso so the HMR/renderer have structure
    c = size // 2
    img[size // 6: size // 3, c - size // 10: c + size // 10] = [0.8, 0.6, 0.5]
    img[size // 3: int(size * 0.8), c - size // 7: c + size // 7] = [0.3, 0.3, 0.7]
    return img * 2 - 1


def _sources(args, cfg, n=2):
    if args.src_dir and os.path.isdir(args.src_dir):
        paths = sorted(glob.glob(os.path.join(args.src_dir, "*")))[:n]
        return [cv_utils.resize_img_hwc(cv_utils.read_img(p, args.device),
                                        cfg.image_size) for p in paths]
    return [_synthetic_image(i, cfg.image_size) for i in range(n)]


def _theta() -> np.ndarray:
    theta = np.zeros(85, np.float32)
    theta[0] = 0.9
    return theta


def demo_imitator(args, cfg):
    from impersonator_tpu_torch.tasks.imitator import Imitator
    imit = Imitator(cfg, device=args.device)
    src = _sources(args, cfg, 1)[0]
    theta = _theta()
    imit.personalize(src, src_smpl=theta)
    rng = np.random.default_rng(0)
    seq = np.tile(theta, (args.frames, 1))
    seq[:, 3:75] += np.cumsum(
        rng.normal(0, 0.02, (args.frames, 72)), axis=0).astype(np.float32)
    preds = imit.inference_by_smpls(seq, batch=8).cpu().numpy()
    _save_all(preds, cfg.output_dir, "imitator", args.device, src_img=src)


def demo_swap(args, cfg):
    from impersonator_tpu_torch.tasks.swapper import Swapper
    swapper = Swapper(cfg, device=args.device)
    src, tgt = _sources(args, cfg, 2)
    swapper.swap_setup(src, tgt, src_smpl=_theta(), tgt_smpl=_theta())
    preds = swapper.swap(target_part=cfg.swap_part).cpu().numpy()
    _save_all(preds, cfg.output_dir, "swap", args.device)


def demo_view(args, cfg):
    from impersonator_tpu_torch.tasks.viewer import Viewer
    viewer = Viewer(cfg, device=args.device)
    src = _sources(args, cfg, 1)[0]
    viewer.personalize(src, smpl=_theta())
    yaws = np.linspace(0, 360, args.frames, endpoint=False)
    preds = viewer.view_sweep(list(yaws)).cpu().numpy()
    _save_all(preds, cfg.output_dir, "view", args.device)


def _save_all(preds, out_dir, name, device, src_img=None):
    os.makedirs(out_dir, exist_ok=True)
    for i, p in enumerate(preds):
        cv_utils.save_img(p, os.path.join(out_dir, f"{name}_{i:04d}.png"),
                          device=device)
    try:
        from impersonator_tpu_torch.utils.video import (
            frames_to_mp4, fuse_source_reference_output)
        frames_to_mp4(preds, os.path.join(out_dir, f"{name}.mp4"))
        if src_img is not None and len(preds) > 1:
            fuse_source_reference_output(
                src_img, None, preds,
                os.path.join(out_dir, f"{name}_montage.mp4"))
    except RuntimeError:
        pass
    print(f"{name}: wrote {len(preds)} frames -> {out_dir}")


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    which = argv[0] if argv and not argv[0].startswith("-") else "imitator"
    rest = argv[1:] if argv and not argv[0].startswith("-") else argv

    ap = argparse.ArgumentParser(allow_abbrev=False)
    ap.add_argument("--src_dir", default="")
    ap.add_argument("--ref_dir", default="")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    extra, passthrough = ap.parse_known_args(rest)
    cfg = from_args(TestConfig, passthrough)

    {"imitator": demo_imitator, "swap": demo_swap,
     "view": demo_view}[which](extra, cfg)


if __name__ == "__main__":
    main()
