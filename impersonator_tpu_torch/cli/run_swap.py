"""Appearance-transfer CLI (torch port of
``impersonator_tpu/cli/run_swap.py``).

    python -m impersonator_tpu_torch.cli.run_swap \\
        --src_path src.jpg --tgt_path tgt.jpg --swap_part body [--device cpu]

Writes ``swap_result.png`` into ``--output_dir``. ``--device`` defaults
to cuda, with no fallback when there is no card.
"""

from __future__ import annotations

import argparse
import os

import torch

from impersonator_tpu_torch.config import TestConfig, from_args
from impersonator_tpu_torch.tasks.swapper import Swapper
from impersonator_tpu_torch.utils import cv_utils


def device_of(argv) -> torch.device:
    """``--device`` of argv (default cuda)."""
    parser = argparse.ArgumentParser(allow_abbrev=False)
    parser.add_argument("--device", default="cuda")
    return torch.device(parser.parse_known_args(argv)[0].device)


def main(argv=None):
    cfg = from_args(TestConfig, argv)
    device = device_of(argv)
    cfg.save("test")
    swapper = Swapper(cfg, device=device)

    src = cv_utils.resize_img_hwc(cv_utils.read_img(cfg.src_path, device),
                                  cfg.image_size)
    tgt = cv_utils.resize_img_hwc(cv_utils.read_img(cfg.tgt_path, device),
                                  cfg.image_size)
    swapper.swap_setup(src, tgt)

    if cfg.post_tune:
        from impersonator_tpu_torch.tasks.post_tune import post_tune_swapper
        post_tune_swapper(swapper)

    preds = swapper.swap(target_part=cfg.swap_part)[0].cpu().numpy()
    if cfg.save_res and cfg.output_dir:
        out = os.path.join(cfg.output_dir, "swap_result.png")
        cv_utils.save_img(preds, out, device=device)
        print("saved", out)
    return preds


if __name__ == "__main__":
    main()
