"""Motion imitation CLI (torch port of
``impersonator_tpu/cli/run_imitator.py``).

    python -m impersonator_tpu_torch.cli.run_imitator \\
        --src_path path/to/src.jpg --tgt_path path/to/frames_dir \\
        --output_dir ./outputs/results [--post_tune] [--i420] \\
        [--device cpu]

Frames stream from disk through the codec's prefetch ring and come back
packed on the device (uint8 RGB, or I420 with ``--i420``); each is
written as ``pred_<name>``, then ``pred.mp4`` and ``montage.mp4`` when
the host has ffmpeg. Besides every TestConfig flag: ``--prior_poses``,
``--face_path`` (a Sphere20a msgpack of the JAX package, for post-tune's
face loss), ``--batch`` (32), ``--i420``, ``--data_parallel`` and
``--device`` (default cuda; no fallback when there is no card).
"""

from __future__ import annotations

import argparse
import glob
import os

import torch

from impersonator_tpu_torch.config import TestConfig, from_args
from impersonator_tpu_torch.ops.colorspace import i420_to_rgb
from impersonator_tpu_torch.tasks.imitator import Imitator
from impersonator_tpu_torch.utils import cv_utils
from impersonator_tpu_torch.utils import video

MULTI_CARD_ITEM = "ROADMAP Queue 1 item 10b-iii"


def collect_frames(tgt_path: str):
    if os.path.isdir(tgt_path):
        return sorted(
            p for p in glob.glob(os.path.join(tgt_path, "*"))
            if p.lower().endswith((".jpg", ".jpeg", ".png")))
    return [tgt_path]


def check_data_parallel(device) -> None:
    """``--data_parallel``: a no-op on one device, as the JAX CLI's on one
    chip; sharding frames over several cards is not ported yet."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            f"--data_parallel over {torch.cuda.device_count()} cards is not "
            f"ported yet ({MULTI_CARD_ITEM})")


def load_face_net(path: str, device):
    """The Sphere20a of a JAX ``{'params'}`` msgpack, on ``device``."""
    from impersonator_tpu_torch.models.facenet import Sphere20a
    from impersonator_tpu_torch.utils.checkpoint import read_flax_msgpack
    from impersonator_tpu_torch.utils.convert import (
        sphere20a_state_dict_from_jax)
    face = Sphere20a()
    face.load_state_dict(sphere20a_state_dict_from_jax(
        read_flax_msgpack(path)))
    return face.to(device).eval().requires_grad_(False)


def parse_extra(argv):
    parser = argparse.ArgumentParser(allow_abbrev=False)
    parser.add_argument("--prior_poses", default=None,
                        help="pickle of prior pose thetas for post_tune")
    parser.add_argument("--face_path", default=None,
                        help="Sphere20a msgpack: adds post-tune's face loss")
    parser.add_argument("--data_parallel", action="store_true",
                        help="shard the frames over the visible cards "
                             "(one card: no-op)")
    parser.add_argument("--batch", type=int, default=32,
                        help="frames per device step")
    parser.add_argument("--i420", action="store_true",
                        help="read predictions back as device-packed I420 "
                             "(1.5 bytes a pixel); the mp4 encoder takes "
                             "them as they are")
    parser.add_argument("--device", default="cuda")
    extra, _ = parser.parse_known_args(argv)
    return extra


def main(argv=None):
    cfg = from_args(TestConfig, argv)
    extra = parse_extra(argv)
    device = torch.device(extra.device)
    if extra.data_parallel:
        check_data_parallel(device)
    cfg.save("test")
    imitator = Imitator(cfg, device=device)

    src_img = cv_utils.resize_img_hwc(
        cv_utils.read_img(cfg.src_path, device), cfg.image_size)
    imitator.personalize(src_img)

    if cfg.post_tune:
        from impersonator_tpu_torch.tasks.post_tune import (
            adaptive_personalize)
        face = None
        if extra.face_path and os.path.exists(extra.face_path):
            face = load_face_net(extra.face_path, device)
        adaptive_personalize(imitator, prior_poses_path=extra.prior_poses,
                             face=face)

    frames = collect_frames(cfg.tgt_path)
    packed = None
    if extra.i420:
        packed = imitator.inference_from_paths(
            frames, cam_strategy=cfg.cam_strategy, batch=extra.batch,
            as_i420=True)
        preds = i420_to_rgb(packed)
    else:
        preds = imitator.inference_from_paths(
            frames, cam_strategy=cfg.cam_strategy, batch=extra.batch,
            as_uint8=True)

    if cfg.save_res and cfg.output_dir:
        os.makedirs(cfg.output_dir, exist_ok=True)
        for p, pred in zip(frames, preds):
            name = os.path.split(p)[-1]
            cv_utils.save_img(pred, os.path.join(cfg.output_dir,
                                                 "pred_" + name),
                              normalize=False, device=device)
        if len(preds) > 1:
            try:
                if packed is not None:
                    video.i420_to_mp4(packed, os.path.join(cfg.output_dir,
                                                           "pred.mp4"))
                else:
                    video.frames_to_mp4(preds, os.path.join(cfg.output_dir,
                                                            "pred.mp4"))
                refs = cv_utils.load_image_batch(frames, cfg.image_size,
                                                 device)
                video.fuse_source_reference_output(
                    src_img, refs, preds,
                    os.path.join(cfg.output_dir, "montage.mp4"))
            except RuntimeError as e:
                print(f"skipping video encode: {e}")
    print(f"imitated {len(preds)} frames -> {cfg.output_dir}")
    return preds


if __name__ == "__main__":
    main()
