"""iPER dataset QA renders: the debug-textured SMPL over extracted frames
(the port's counterpart of ``tools/visual_iper.py``, after the
reference's ``tools/visual_iPER.py``).

For each batch of frames it poses SMPL from the video's θs (or from HMR
when no ``--smpl_pkl`` is given), rasterises it with
``SMPLRenderer.render_fim_wim`` (one ``zbuffer_bucket_rows`` launch a
batch on the card), paints the all-ones debug texture with
``render_textured`` and takes the silhouette, then writes one PNG
triptych a frame (frame | debug render | silhouette-masked frame) to
``--out_dir``:

    python -m impersonator_tpu_torch.tools.visual_iper \\
        --frames_dir data/001/1/1 \\
        --smpl_pkl data/smpls/001/1/1/pose_shape.pkl --out_dir /tmp/qa

The last batch is padded to ``--batch`` with its last frame, as the JAX
tool pads it. ``--hmr_ckpt`` takes the released ``.pth`` or a JAX
msgpack; without it HMR has seeded random weights (a smoke run).
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch

from impersonator_tpu_torch.tools import (add_device_arg, image_paths,
                                          resolve_device)


def load_thetas(pkl_path: str) -> np.ndarray:
    """pose_shape.pkl {cams, pose, shape} -> (N, 85) θs (the layout
    ``metrics.protocols.IPERProtocol`` reads)."""
    with open(pkl_path, "rb") as f:
        d = pickle.load(f)
    return np.concatenate(
        [d["cams"], d["pose"], d["shape"]], axis=1).astype(np.float32)


@torch.no_grad()
def render_batch(renderer, smpl_params, parents, theta85):
    """(B, 85) θs on the renderer's device -> (fim (B, S, S) int, debug
    render (B, S, S, 3) in [0, 1] with 0 on background, silhouette (B,
    S, S) float32)."""
    from impersonator_tpu_torch.ops import rasterizer as rast
    from impersonator_tpu_torch.ops import smpl as smpl_ops
    from impersonator_tpu_torch.utils.precision import full_fp32
    with full_fp32():
        info = smpl_ops.get_details(smpl_params, theta85, parents)
        f2verts, fim, wim = renderer.render_fim_wim(info["cam"],
                                                    info["verts"])
        # the reference's debug_textures: all ones (nmr.py:661-662)
        tex = torch.ones((theta85.shape[0], f2verts.shape[1],
                          renderer.tex_size ** 2, 3),
                         dtype=torch.float32, device=theta85.device)
        rgb = renderer.render_textured(fim, wim, tex)
    return fim, rgb, rast.render_silhouette(fim)


def triptych(frame: np.ndarray, rgb: np.ndarray, sil: np.ndarray):
    """frame (S, S, 3) in [-1, 1], rgb in [0, 1], sil (S, S) -> (S, 3S, 3)
    in [-1, 1]: the frame, the render, the frame inside the body (black
    outside)."""
    sil = sil[..., None]
    body = rgb * 2.0 - 1.0
    masked = frame * sil - (1.0 - sil)
    return np.concatenate([frame, body, masked], axis=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames_dir", required=True,
                    help="folder of extracted frames (prepare_iper)")
    ap.add_argument("--smpl_pkl", default="",
                    help="pose_shape.pkl for the video; HMR recovers "
                         "thetas from the frames when absent")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--itv", type=int, default=1,
                    help="take every itv-th frame")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--smpl_model", default="",
                    help="real SMPL pkl for assets; synthetic when absent")
    ap.add_argument("--uv_mapping", default="")
    ap.add_argument("--hmr_ckpt", default="")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from impersonator_tpu_torch import assets as A
    from impersonator_tpu_torch.ops import smpl as smpl_ops
    from impersonator_tpu_torch.tasks.renderer import SMPLRenderer
    from impersonator_tpu_torch.utils import cv_utils

    paths = image_paths(args.frames_dir)[::args.itv]
    if not paths:
        raise SystemExit(f"no frames under {args.frames_dir}")
    if args.smpl_model:
        assets = A.load_smpl_assets(args.smpl_model, args.uv_mapping)
    else:
        print("visual_iper: no --smpl_model, using synthetic assets")
        assets = A.synthetic_assets()
    renderer = SMPLRenderer.create(assets, device,
                                   image_size=args.image_size)
    smpl_params = smpl_ops.SMPLParams.from_assets(assets, device)

    hmr = thetas = None
    if args.smpl_pkl:
        thetas = load_thetas(args.smpl_pkl)[::args.itv]
        if len(thetas) < len(paths):
            print(f"visual_iper: {len(paths)} frames but {len(thetas)} "
                  "thetas; truncating to the shorter")
            paths = paths[:len(thetas)]
        thetas = thetas[:len(paths)]
    else:
        from impersonator_tpu_torch.tools.make_prior_poses import (load_hmr,
                                                                   regress)
        if not args.hmr_ckpt:
            print("visual_iper: no --hmr_ckpt, random HMR weights "
                  "(smoke only)")
        hmr = load_hmr(args.hmr_ckpt, device)

    os.makedirs(args.out_dir, exist_ok=True)
    n = len(paths)
    for i in range(0, n, args.batch):
        chunk = paths[i:i + args.batch]
        imgs = cv_utils.load_image_batch(chunk, args.image_size, device)
        pad = args.batch - len(chunk)
        if pad:
            imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, 0)])
        if thetas is not None:
            th = thetas[i:i + args.batch]
            if pad:
                th = np.concatenate([th, np.repeat(th[-1:], pad, 0)])
        else:
            th = regress(hmr, np.stack([cv_utils.resize_img_hwc(im, 224)
                                        for im in imgs]), device)
        _, rgb, sil = render_batch(renderer, smpl_params, assets.parents,
                                   torch.from_numpy(th).to(device))
        rgb, sil = rgb.cpu().numpy(), sil.cpu().numpy()
        for j, p in enumerate(chunk):
            stem = os.path.splitext(os.path.basename(p))[0]
            cv_utils.save_img(triptych(imgs[j], rgb[j], sil[j]),
                              os.path.join(args.out_dir, f"qa_{stem}.png"),
                              device=device)
    print(f"visual_iper: wrote {n} triptychs -> {args.out_dir}")


if __name__ == "__main__":
    main()
