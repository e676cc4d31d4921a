"""Output parity against the PyTorch reference's saved frames (the
port's counterpart of ``tools/parity_harness.py``).

BASELINE.md's quality procedure: run the reference recipe on the iPER
demo assets, then score this port's frames one for one against it. This
harness personalises an ``Imitator`` on ``--src_path`` (one
``zbuffer_bucket_rows`` launch on the card), imitates every frame of
``--tgt_path`` through HMR (``Imitator.inference``: one
``zbuffer_bucket_flow`` launch a batch) and scores each prediction
against ``--ref_dir``'s ``pred_<frame name>`` (the reference's
``run_imitator.py`` outputs) by SSIM, PSNR and, with ``--lpips_ckpt``,
the perceptual distance. It prints the JAX tool's JSON
(``{"aggregate": ..., "per_frame": [...]}``):

    python -m impersonator_tpu_torch.tools.parity_harness \\
        --src_path 009_5_1_000.jpg --tgt_path frames_dir \\
        --ref_dir torch_outputs/ --gen_ckpt net_epoch_30_id_G.pth \\
        --hmr_ckpt hmr_tf2pt.pth --lpips_ckpt lpips_v01_alex_lin.msgpack \\
        --smpl_model smpl_model.pkl --uv_mapping mapper.txt

Each ``*_ckpt`` takes a released ``.pth`` or the JAX package's msgpack.
The generator decodes in ``--compute_dtype`` (the task's bfloat16 by
default, float32 as ``cli.evaluate`` offers); everything else, the
metrics included, runs in full float32 (TF32 off, as the JAX tool asks
for the highest precision).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from impersonator_tpu_torch.tools import (add_device_arg, image_paths,
                                          load_reference, net_state_dict,
                                          resolve_device)


def load_lpips(path: str, device):
    """``metrics.zoo.LPIPS`` from a JAX LPIPS msgpack (``cli.evaluate``'s
    loader: a seeded backbone for lin heads alone) or from a released
    lin-head ``.pth``, on ``device``."""
    from impersonator_tpu_torch.cli import evaluate as ev
    if path.endswith(".msgpack"):
        return ev.load_lpips(path, device)
    from impersonator_tpu_torch.metrics.zoo import LPIPS
    from impersonator_tpu_torch.utils import convert
    model = LPIPS("alex")
    sd = convert.lpips_from_reference(load_reference(path))
    sd.update({f"net.{k}": v for k, v in
               ev.seeded_backbone(model.net).state_dict().items()})
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval().requires_grad_(False)


def build_imitator(args, device):
    """The Imitator of the flags, its generator and HMR loaded from the
    checkpoints given."""
    from impersonator_tpu_torch.config import TestConfig
    from impersonator_tpu_torch.tasks.imitator import Imitator
    cfg = TestConfig(image_size=args.image_size, smpl_model=args.smpl_model,
                     uv_mapping=args.uv_mapping,
                     compute_dtype=args.compute_dtype)
    imitator = Imitator(cfg, device=device)
    for path, net, kind in ((args.gen_ckpt, imitator.nets.generator, "gen"),
                            (args.hmr_ckpt, imitator.nets.hmr, "hmr")):
        if path:
            net.load_state_dict(net_state_dict(kind, path), strict=True)
    imitator.refresh_compute_nets()
    return imitator


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src_path", required=True)
    ap.add_argument("--tgt_path", required=True)
    ap.add_argument("--ref_dir", required=True,
                    help="directory of the torch reference's pred_*.jpg")
    ap.add_argument("--gen_ckpt", default="")
    ap.add_argument("--hmr_ckpt", default="")
    ap.add_argument("--smpl_model", default="")
    ap.add_argument("--uv_mapping", default="")
    ap.add_argument("--lpips_ckpt", default="",
                    help="LPIPS lin heads (.pth or msgpack): adds the "
                         "BASELINE.md 'lps' column")
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--compute_dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    add_device_arg(ap)
    return ap.parse_args(argv)


def harness(args) -> dict:
    """The JAX tool's JSON as a dict for the parsed flags."""
    device = resolve_device(args.device)

    from impersonator_tpu_torch.cli.evaluate import lpips_apply_fn
    from impersonator_tpu_torch.metrics import psnr, ssim
    from impersonator_tpu_torch.utils import cv_utils
    from impersonator_tpu_torch.utils.precision import full_fp32

    with full_fp32():
        imitator = build_imitator(args, device)
        lpips_fn = (lpips_apply_fn(load_lpips(args.lpips_ckpt, device))
                    if args.lpips_ckpt else None)
        src = cv_utils.resize_img_hwc(
            cv_utils.read_img(args.src_path, device), args.image_size)
        imitator.personalize(src)
        frames = image_paths(args.tgt_path)
        tgt224 = np.stack([cv_utils.resize_img_hwc(
            cv_utils.read_img(p, device), 224) for p in frames])
        preds = imitator.inference(tgt224)

        per_frame = []
        for p, pred in zip(frames, preds):
            name = "pred_" + os.path.split(p)[-1]
            ref_path = os.path.join(args.ref_dir, name)
            if not os.path.exists(ref_path):
                continue
            ref = cv_utils.resize_img_hwc(cv_utils.read_img(ref_path, device),
                                          args.image_size)
            a = pred[None].float()
            b = torch.from_numpy(ref)[None].to(device)
            row = {"frame": name, "ssim": float(ssim(a, b)),
                   "psnr": float(psnr(a, b))}
            if lpips_fn is not None:
                row["lps"] = float(lpips_fn(a, b)[0])
            per_frame.append(row)

    if not per_frame:
        return {"error": "no matching reference frames"}
    agg = {"frames": len(per_frame),
           "ssim_mean": float(np.mean([f["ssim"] for f in per_frame])),
           "psnr_mean": float(np.mean([f["psnr"] for f in per_frame]))}
    if lpips_fn is not None:
        agg["lps_mean"] = float(np.mean([f["lps"] for f in per_frame]))
    return {"aggregate": agg, "per_frame": per_frame}


def main(argv=None):
    out = harness(parse_args(argv))
    print(json.dumps(out, indent=None if "error" in out else 1))
    return out


if __name__ == "__main__":
    main()
