"""Evaluation CLI: the iPER protocol runner (torch port of
``impersonator_tpu/cli/evaluate.py``).

Per protocol video it personalises on the source frame, then runs

* **self-imitation**: the video's own frame range with
  ``cam_strategy='copy'``, scored against the ground-truth frames with the
  paired suite (ssim / psnr / lps, face-CS, OS-CS-reid, SSPE);
* **cross-imitation**: another subject's clip with ``'smooth'``, scored
  against the source subject's real ``flag`` frames with the unpaired
  suite (is / fid, OS / PCB re-id, face-CS / face-FD).

``--task swap`` scores appearance transfer over the AT protocol's
vid_name_pairs and ``--task view`` novel views over an orbit range, both
paired. Frames decode through the port's codec (``data.native``); clips
without θs stream through ``Imitator.inference_from_paths``. Predictions
go to ``{output_dir}/{self,cross}_imitation/pred_%08d.jpg`` and results to
``results.txt`` (the reference's format) and ``results.json``.

    python -m impersonator_tpu_torch.cli.evaluate --data_dir /data/iPER \\
        --protocol_file iPER_protocol.json [--device cpu]

Besides every TestConfig flag it takes the JAX CLI's flags and
``--device`` (default cuda; no fallback when there is no card). Weight
files are the JAX package's msgpacks, read without flax.
``--max_frames`` defaults to 0 (everything); a capped range says how many
frames it dropped.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from impersonator_tpu_torch.config import TestConfig, from_args
from impersonator_tpu_torch.metrics import (PairedMetricRunner,
                                            UnpairedMetricRunner)
from impersonator_tpu_torch.metrics.metrics import (
    TYPES_QUALITIES as _BASE_QUALITIES)
from impersonator_tpu_torch.metrics.protocols import build_protocol
from impersonator_tpu_torch.tasks.imitator import Imitator
from impersonator_tpu_torch.utils import cv_utils
from impersonator_tpu_torch.utils.checkpoint import read_flax_msgpack
from impersonator_tpu_torch.utils.precision import full_fp32

# extends the package's polarity table, so a change there reaches the
# results.txt labels here
TYPES_QUALITIES = {
    **_BASE_QUALITIES,
    "is": "higher", "fid": "lower", "OS-CS-reid": "higher",
    "OS-freid": "lower", "PCB-CS-reid": "higher", "PCB-freid": "lower",
    "face-CS": "higher", "face-FD": "lower", "SSPE": "lower",
    "fd": "lower", "cs": "higher",
}

_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "impersonator_tpu", "weights")
# the reference's released LPIPS v0.1 alex lin heads, converted in the repo
REAL_LPIPS_LIN = os.path.join(_WEIGHTS, "lpips_v01_alex_lin.msgpack")
# the reference's released MTCNN P / R / O-net weights (face crops stay
# SMPL head geometry unless --mtcnn_path asks for the detector)
REAL_MTCNN = os.path.join(_WEIGHTS, "mtcnn_pro.msgpack")


def _loaded(module, state_dict, device):
    module.load_state_dict(state_dict, strict=True)
    return module.to(device).eval().requires_grad_(False)


@torch.no_grad()
def seeded_backbone(net, seed: int = 0):
    """A fixed-seed LPIPS backbone for lin-heads-only weights: conv
    weights N(0, 1/fan_in), biases 0 (flax's default init), drawn on the
    CPU so every device gets the same net."""
    g = torch.Generator().manual_seed(seed)
    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                           * float(np.sqrt(1.0 / m.weight[0].numel())))
            m.bias.zero_()
    return net


def lpips_apply_fn(model):
    """(a, b) NHWC in [-1, 1] -> (B,) LPIPS distances, float32 without
    TF32."""

    def fn(a, b):
        a = torch.as_tensor(a, dtype=torch.float32)
        b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
        with torch.no_grad(), full_fp32():
            return model(a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2))

    return fn


def load_lpips(path: str, device, net: str = "alex"):
    """An LPIPS msgpack of the JAX package -> ``metrics.zoo.LPIPS`` on
    ``device``; a lin-heads-only file gets :func:`seeded_backbone`."""
    from impersonator_tpu_torch.metrics.zoo import LPIPS
    from impersonator_tpu_torch.utils.convert import lpips_state_dict_from_jax
    tree = read_flax_msgpack(path)
    sd = lpips_state_dict_from_jax(tree, net)
    model = LPIPS(net)
    if net not in tree["params"]:
        print("evaluate: LPIPS tree has real lin heads but no alex "
              "backbone; using a fixed-seed random backbone "
              "(relative metric only — supply a full tree for "
              "reference-absolute lps)")
        sd.update({f"net.{k}": v for k, v in
                   seeded_backbone(model.net).state_dict().items()})
    return _loaded(model, sd, device)


def build_extractors(lpips_path=None, inception_path=None, sphere_path=None,
                     senet_path=None, osnet_path=None, pcb_path=None,
                     facenet_path=None, device="cuda"):
    """Metric extractors from the JAX package's weight files, their nets on
    ``device``; an absent file skips its metrics (logged). Face embedding
    priority: InceptionResnetV1 (the reference's face-CS / FD net) >
    SENet50 > Sphere20a."""
    from impersonator_tpu_torch.metrics import unpaired as U
    from impersonator_tpu_torch.utils import convert as C
    lpips_apply = inception_fn = face_fn = reid_fn = pcb_fn = None
    if facenet_path and os.path.exists(facenet_path):
        from impersonator_tpu_torch.metrics.zoo import InceptionResnetV1
        face_fn = U.facenet_ir_embed_fn(_loaded(
            InceptionResnetV1(),
            C.facenet_ir_state_dict_from_jax(read_flax_msgpack(facenet_path)),
            device))
    elif facenet_path:
        print(f"evaluate: facenet weights not found at {facenet_path}; "
              "falling back to senet50/sphereface")
    if lpips_path is None and os.path.exists(REAL_LPIPS_LIN):
        lpips_path = REAL_LPIPS_LIN
    if lpips_path and os.path.exists(lpips_path):
        lpips_apply = lpips_apply_fn(load_lpips(lpips_path, device))
    elif lpips_path:
        print(f"evaluate: lpips weights not found at {lpips_path}; "
              "'lps' will be skipped")
    if inception_path and os.path.exists(inception_path):
        from impersonator_tpu_torch.metrics.zoo import InceptionV3
        inception_fn = U.inception_embed_fn(_loaded(
            InceptionV3(),
            C.inception_state_dict_from_jax(read_flax_msgpack(inception_path)),
            device))
    elif inception_path:
        print(f"evaluate: inception weights not found at {inception_path}; "
              "is/fid will be skipped")
    if face_fn is None and senet_path and os.path.exists(senet_path):
        from impersonator_tpu_torch.models.facenet import SENet50
        face_fn = U.senet_face_embed_fn(_loaded(
            SENet50(),
            C.senet50_state_dict_from_jax(read_flax_msgpack(senet_path)),
            device))
    elif senet_path and not os.path.exists(senet_path):
        print(f"evaluate: senet50 weights not found at {senet_path}; "
              "falling back to sphereface for face-CS/face-FD")
    if face_fn is None and sphere_path and os.path.exists(sphere_path):
        from impersonator_tpu_torch.models.facenet import Sphere20a
        face_fn = U.sphere_face_embed_fn(_loaded(
            Sphere20a(),
            C.sphere20a_state_dict_from_jax(read_flax_msgpack(sphere_path)),
            device))
    elif sphere_path and not os.path.exists(sphere_path):
        print(f"evaluate: sphereface weights not found at {sphere_path}; "
              "face-CS/face-FD may be skipped")
    if osnet_path and os.path.exists(osnet_path):
        from impersonator_tpu_torch.metrics.reid import (OSNet,
                                                         osnet_reid_embed_fn)
        reid_fn = osnet_reid_embed_fn(_loaded(
            OSNet(),
            C.osnet_state_dict_from_jax(read_flax_msgpack(osnet_path)),
            device))
    elif osnet_path:
        print(f"evaluate: osnet weights not found at {osnet_path}; "
              "OS-CS-reid/OS-freid will be skipped")
    if pcb_path and os.path.exists(pcb_path):
        from impersonator_tpu_torch.metrics.reid import (PCBReid,
                                                         pcb_reid_embed_fn)
        pcb_fn = pcb_reid_embed_fn(_loaded(
            PCBReid(), C.pcb_state_dict_from_jax(read_flax_msgpack(pcb_path)),
            device))
    elif pcb_path:
        print(f"evaluate: pcb weights not found at {pcb_path}; "
              "PCB-CS-reid/PCB-freid will be skipped")
    return lpips_apply, inception_fn, face_fn, reid_fn, pcb_fn


def _head_bboxes(task, thetas) -> np.ndarray:
    """(N, 85) θs -> (N, 4) fractional head boxes from SMPL's j2d: the
    SMPL-derived stand-in for the reference's MTCNN face detector."""
    from impersonator_tpu_torch.models.losses import head_bbox_from_kps
    from impersonator_tpu_torch.ops import smpl as smpl_ops
    thetas = torch.as_tensor(thetas, dtype=torch.float32, device=task.device)
    with torch.no_grad(), full_fp32():
        info = smpl_ops.get_details(task.smpl_params, thetas, task.parents)
        return head_bbox_from_kps(info["j2d"]).cpu().numpy()


def _mtcnn_boxes(det, imgs) -> np.ndarray:
    """[-1, 1] frames -> fractional head boxes from the real-weight MTCNN
    cascade (the reference evaluator's face localiser; ``--mtcnn_path``)."""
    imgs = torch.as_tensor(imgs, dtype=torch.float32)
    u8 = ((imgs + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)
    return det.head_bboxes(u8.cpu().numpy())


def _hmr_fn(task):
    """imgs (B, S, S, 3) in [-1, 1] -> (B, 85) θs for SSPE (the reference
    resizes to 224² with align_corners=False)."""
    from impersonator_tpu_torch.ops.sampler import resize_bilinear_torch

    def fn(imgs):
        x = resize_bilinear_torch(torch.as_tensor(
            imgs, dtype=torch.float32, device=task.device), 224, 224)
        return task.regress_smpl(x)

    return fn


def _cap(paths, max_frames, what, vid):
    if max_frames and len(paths) > max_frames:
        print(f"evaluate: {vid} {what}: capping {len(paths)} -> "
              f"{max_frames} frames ({len(paths) - max_frames} dropped)")
        return paths[:max_frames]
    return paths


def _save_preds(preds, out_dir, count: int, device) -> None:
    """preds (N, S, S, 3) in [-1, 1] -> ``out_dir/pred_%08d.jpg`` from
    ``count`` on, encoded by the codec of ``device``'s type."""
    os.makedirs(out_dir, exist_ok=True)
    for i, p in enumerate(torch.as_tensor(preds).cpu().numpy()):
        cv_utils.save_img(
            p, os.path.join(out_dir, f"pred_{count + i:08d}.jpg"),
            device=device)


def _imitate_clip(imitator, paths, smpls, cam_strategy, out_dir, count):
    """One clip -> preds (N, S, S, 3) on the device, written as files when
    ``out_dir`` is given. Without θs the frames stream from disk through
    HMR."""
    if smpls is not None:
        preds = imitator.inference_by_smpls(smpls, cam_strategy=cam_strategy)
    else:
        preds = imitator.inference_from_paths(paths,
                                              cam_strategy=cam_strategy)
    if out_dir:
        _save_preds(preds, out_dir, count, imitator.device)
    return preds


def _src_frame(cfg, task, unit_paths, unit_smpls):
    """Source frame 0 (resized to cfg.image_size, [-1, 1]) and its θ."""
    img = cv_utils.resize_img_hwc(
        cv_utils.read_img(unit_paths[0], task.device), cfg.image_size)
    smpl = unit_smpls[0] if unit_smpls is not None else None
    return img, smpl


def _pair_types(lpips_apply, face_fn, reid_fn, hmr_fn=None):
    """The reference's pair_types: ssim / psnr, lps, face-CS, OS-CS-reid,
    SSPE, each where its extractor is there."""
    return (["ssim", "psnr"] + (["lps"] if lpips_apply else [])
            + (["face-CS"] if face_fn else [])
            + (["OS-CS-reid"] if reid_fn else [])
            + (["SSPE"] if hmr_fn else []))


def evaluate_protocol(cfg: TestConfig, protocol_file: str,
                      max_videos: int | None = None,
                      max_frames: int = 0,
                      num_sources: int = 1,
                      cross_imitation: bool = True,
                      lpips_apply=None, inception_fn=None, face_fn=None,
                      reid_fn=None, pcb_fn=None,
                      save_preds: bool = False,
                      prior_poses_path: str | None = None,
                      sspe: bool = False,
                      protocol_name: str = "iPER",
                      mtcnn=None, yolo=None, device="cuda") -> dict:
    """Motion-imitation evaluation (``--task imitate``): self-imitation
    (paired) and cross-imitation (unpaired) per protocol video."""
    protocol = build_protocol(protocol_name, cfg.data_dir, protocol_file,
                              images_folder=cfg.images_folder,
                              smpls_folder=cfg.smpls_folder)
    protocol.setup(num_sources=num_sources, load_smpls=True)
    imitator = Imitator(cfg, device=device)

    hmr_fn = _hmr_fn(imitator) if sspe else None
    pair_types = _pair_types(lpips_apply, face_fn, reid_fn, hmr_fn)

    def make_paired():
        return PairedMetricRunner(metric_types=pair_types,
                                  lpips_apply=lpips_apply, hmr_fn=hmr_fn,
                                  face_fn=face_fn, reid_fn=reid_fn)

    paired = make_paired()
    unpaired = UnpairedMetricRunner(inception_fn=inception_fn,
                                    face_fn=face_fn, reid_fn=reid_fn,
                                    pcb_fn=pcb_fn)
    per_video = {}
    si_count = ci_count = 0
    si_dir = (os.path.join(cfg.output_dir, "self_imitation")
              if save_preds else None)
    ci_dir = (os.path.join(cfg.output_dir, "cross_imitation")
              if save_preds else None)

    n = len(protocol) if max_videos is None else min(max_videos, len(protocol))
    for idx in range(n):
        unit = protocol[idx]
        if not unit.src_paths or not unit.si_paths:
            print(f"evaluate: {unit.video_id}: missing frames, skipped")
            continue

        # personalisation on source frame 0
        if len(unit.src_paths) > 1:
            print(f"evaluate: {unit.video_id}: protocol offers "
                  f"{len(unit.src_paths)} source views but the imitator "
                  "personalizes on ONE image; using src frame 0 "
                  "(multi-source personalization is a model capability "
                  "this generator family does not have — same as the "
                  "reference's imitator)")
        src_img, src_smpl = _src_frame(cfg, imitator, unit.src_paths,
                                       unit.src_smpls)
        imitator.personalize(src_img, src_smpl=src_smpl)
        if cfg.post_tune:
            from impersonator_tpu_torch.tasks.post_tune import (
                adaptive_personalize)
            adaptive_personalize(imitator, prior_poses_path=prior_poses_path)

        # self-imitation: cam 'copy', paired metrics
        si_paths = _cap(unit.si_paths, max_frames, "self-imitation",
                        unit.video_id)
        si_smpls = (unit.si_smpls[:len(si_paths)]
                    if unit.si_smpls is not None else None)
        preds = _imitate_clip(imitator, si_paths, si_smpls, "copy", si_dir,
                              si_count)
        si_count += len(preds)
        refs = cv_utils.load_image_batch(si_paths, cfg.image_size,
                                         imitator.device)
        # head boxes for the crop-based face-CS: cam 'copy' takes the ref
        # cam and pose, so the ref frame's head box holds for the pred too
        si_boxes = None
        if face_fn:
            if mtcnn is not None:
                si_boxes = _mtcnn_boxes(mtcnn, refs)
            elif si_smpls is not None:
                si_boxes = _head_bboxes(imitator, si_smpls)
        # person crops for the re-id metrics (the reference's YOLOv3
        # convention), detected per clip
        si_pred_body = yolo.body_bboxes(preds) if yolo else None
        si_ref_body = yolo.body_bboxes(refs) if yolo else None
        vid_runner = make_paired()
        vid_runner.update(preds, refs, pred_bboxes=si_boxes,
                          ref_bboxes=si_boxes,
                          pred_body_bboxes=si_pred_body,
                          ref_body_bboxes=si_ref_body)
        paired.merge(vid_runner)
        per_video[unit.video_id] = vid_runner.evaluate()

        # cross-imitation: cam 'smooth', unpaired metrics
        if cross_imitation and unit.ci_paths:
            ci_paths = _cap(unit.ci_paths, max_frames, "cross-imitation",
                            unit.video_id)
            ci_smpls = (unit.ci_smpls[:len(ci_paths)]
                        if unit.ci_smpls is not None else None)
            ci_preds = _imitate_clip(imitator, ci_paths, ci_smpls, "smooth",
                                     ci_dir, ci_count)
            ci_count += len(ci_preds)
            flag_paths = _cap(unit.flag_paths or unit.si_paths, max_frames,
                              "flag refs", unit.video_id)
            flags = cv_utils.load_image_batch(flag_paths, cfg.image_size,
                                              imitator.device)
            m = min(len(ci_preds), len(flags))
            # head crops for face-CS / face-FD: preds follow the
            # transferred θ (source cam and shape, driving pose, cam
            # 'smooth'), flags their own video's θs
            pred_boxes = ref_boxes = None
            if face_fn and mtcnn is not None:
                pred_boxes = _mtcnn_boxes(mtcnn, ci_preds[:m])
                ref_boxes = _mtcnn_boxes(mtcnn, flags[:m])
            elif face_fn and ci_smpls is not None:
                from impersonator_tpu_torch.tasks.imitator import swap_smpl
                tgt = torch.as_tensor(ci_smpls[:m], dtype=torch.float32,
                                      device=imitator.device)
                tsf = swap_smpl(imitator.src_info["cam"],
                                imitator.src_info["shape"], tgt,
                                tgt[0:1, 0:3], "smooth")
                pred_boxes = _head_bboxes(imitator, tsf)
            flag_smpls = (unit.flag_smpls if unit.flag_smpls is not None
                          else unit.si_smpls)
            if (face_fn and mtcnn is None and flag_smpls is not None
                    and len(flag_smpls) >= m):
                ref_boxes = _head_bboxes(imitator, flag_smpls[:m])
            unpaired.update(
                ci_preds[:m], flags[:m],
                pred_bboxes=pred_boxes, ref_bboxes=ref_boxes,
                pred_body_bboxes=(yolo.body_bboxes(ci_preds[:m])
                                  if yolo else None),
                ref_body_bboxes=(yolo.body_bboxes(flags[:m])
                                 if yolo else None))

    return {"self_imitation": paired.evaluate(),
            "cross_imitation": unpaired.evaluate(),
            "per_video": per_video,
            "num_si_frames": si_count, "num_ci_frames": ci_count}


def _hmr_thetas(task, paths, batch: int = 8) -> np.ndarray:
    """HMR-regressed (N, 85) θs of the frames at ``paths``, for a protocol
    video without a pose_shape.pkl: fixed-size chunks, the last padded."""
    t224 = cv_utils.load_image_batch(paths, 224, task.device)
    n = t224.shape[0]
    pad = (-n) % batch
    if pad:
        t224 = np.concatenate([t224, np.repeat(t224[-1:], pad, 0)])
    outs = [task.regress_smpl(t224[i:i + batch]).cpu().numpy()
            for i in range(0, n + pad, batch)]
    return np.concatenate(outs, 0)[:n]


def evaluate_at_protocol(cfg: TestConfig, protocol_file: str,
                         max_pairs: int | None = None,
                         max_frames: int = 0,
                         num_sources: int = 1,
                         lpips_apply=None, face_fn=None, reid_fn=None,
                         save_preds: bool = False,
                         protocol_name: str = "iPER_Appearance_Transfer",
                         target_part: str = "body",
                         save_video: bool = False, device="cuda") -> dict:
    """Appearance-transfer evaluation (``--task swap``): per vid_name_pair,
    swap the appearance video's clothes onto the source identity, drive
    the composite with the appearance video's own motion, and score the
    predictions paired against that video's real frames (one actor in
    both outfits, so the composite is reconstructable). Preds go to
    ``{output_dir}/self_imitation/pred_%08d.jpg``."""
    from impersonator_tpu_torch.tasks.swapper import Swapper

    protocol = build_protocol(protocol_name, cfg.data_dir, protocol_file,
                              images_folder=cfg.images_folder,
                              smpls_folder=cfg.smpls_folder)
    protocol.setup(num_sources=num_sources, load_smpls=True)
    swapper = Swapper(cfg, device=device)

    pair_types = _pair_types(lpips_apply, face_fn, reid_fn)

    def make_paired():
        return PairedMetricRunner(metric_types=pair_types,
                                  lpips_apply=lpips_apply,
                                  face_fn=face_fn, reid_fn=reid_fn)

    paired = make_paired()
    per_pair = {}
    si_dir = (os.path.join(cfg.output_dir, "self_imitation")
              if save_preds else None)
    count = 0

    n = len(protocol) if max_pairs is None else min(max_pairs, len(protocol))
    for idx in range(n):
        unit = protocol[idx]
        tag = f"{unit.src_vid}->{unit.app_vid}"
        if not unit.src_paths or not unit.app_paths or not unit.motion_paths:
            print(f"evaluate: {tag}: missing frames, skipped")
            continue

        # personalise both sides on their first source view
        src_img, src_smpl = _src_frame(cfg, swapper, unit.src_paths,
                                       unit.src_smpls)
        app_img, app_smpl = _src_frame(cfg, swapper, unit.app_paths,
                                       unit.app_smpls)
        swapper.swap_setup(src_img, app_img, src_smpl, app_smpl)
        if cfg.post_tune:
            from impersonator_tpu_torch.tasks.post_tune import (
                post_tune_swapper)
            post_tune_swapper(swapper)
        swapped = swapper.swap(target_part=target_part)[0]

        # re-personalise on the composite (still at the source pose),
        # then drive the appearance video's motion; cam 'copy' takes the
        # driving cams so the framing matches the gt frames
        theta = (src_smpl if src_smpl is not None
                 else swapper.src_info["theta"][0])
        state = swapper.personalize(swapped, smpl=theta)

        motion_paths = _cap(unit.motion_paths, max_frames,
                            "appearance-transfer", tag)
        if unit.motion_smpls is not None:
            motion_smpls = unit.motion_smpls[:len(motion_paths)]
        else:
            motion_smpls = _hmr_thetas(swapper, motion_paths)
        preds = swapper.imitate_by_smpls(state, motion_smpls,
                                         cam_strategy="copy")
        if si_dir:
            _save_preds(preds, si_dir, count, swapper.device)
        count += len(preds)

        refs = cv_utils.load_image_batch(motion_paths, cfg.image_size,
                                         swapper.device)
        pair_runner = make_paired()
        pair_runner.update(preds, refs)
        paired.merge(pair_runner)
        per_pair[tag] = pair_runner.evaluate()

        if save_video:
            # the AT evaluator's {src}-to-{app}.mp4 montage under
            # visual/self_imitation
            from impersonator_tpu_torch.utils.video import (
                fuse_source_reference_output, have_ffmpeg)
            vis_dir = os.path.join(cfg.output_dir, "visual",
                                   "self_imitation")
            if have_ffmpeg():
                os.makedirs(vis_dir, exist_ok=True)
                name = "{}-to-{}.mp4".format(
                    unit.src_vid.replace("/", "_"),
                    unit.app_vid.replace("/", "_"))
                fuse_source_reference_output(
                    src_img, refs, preds.cpu().numpy(),
                    os.path.join(vis_dir, name))
            else:
                print("evaluate: ffmpeg unavailable; montage mp4 "
                      "skipped")

    return {"self_imitation": paired.evaluate(), "per_video": per_pair,
            "num_si_frames": count}


def evaluate_view_protocol(cfg: TestConfig, protocol_file: str,
                           max_videos: int | None = None,
                           max_frames: int = 0,
                           num_sources: int = 1,
                           lpips_apply=None, face_fn=None, reid_fn=None,
                           save_preds: bool = False,
                           protocol_name: str = "MotionSynthetic_Novel_View",
                           prior_poses_path: str | None = None,
                           device="cuda") -> dict:
    """Novel-view evaluation (``--task view``): per protocol video,
    personalise on the source frame and synthesise the self-imitation
    range (a camera orbit) with ``Viewer.view_by_smpls``, scored paired
    against the real frames. Preds go straight under ``output_dir``."""
    from impersonator_tpu_torch.tasks.viewer import Viewer

    protocol = build_protocol(protocol_name, cfg.data_dir, protocol_file,
                              images_folder=cfg.images_folder,
                              smpls_folder=cfg.smpls_folder)
    protocol.setup(num_sources=num_sources, load_smpls=True)
    # the gt frames keep their background, so the viewer composites onto
    # the inpainted source background
    viewer = Viewer(dataclasses.replace(cfg, bg_replace=True), device=device)

    pair_types = _pair_types(lpips_apply, face_fn, reid_fn)

    def make_paired():
        return PairedMetricRunner(metric_types=pair_types,
                                  lpips_apply=lpips_apply,
                                  face_fn=face_fn, reid_fn=reid_fn)

    paired = make_paired()
    per_video = {}
    count = 0

    n = len(protocol) if max_videos is None else min(max_videos, len(protocol))
    for idx in range(n):
        unit = protocol[idx]
        if not unit.src_paths or not unit.si_paths:
            print(f"evaluate: {unit.video_id}: missing frames, skipped")
            continue

        src_img, src_smpl = _src_frame(cfg, viewer, unit.src_paths,
                                       unit.src_smpls)
        viewer.personalize(src_img, smpl=src_smpl)
        if cfg.post_tune:
            viewer.post_personalize(load_prior_poses_arg(prior_poses_path))

        si_paths = _cap(unit.si_paths, max_frames, "novel-view",
                        unit.video_id)
        if unit.si_smpls is not None:
            si_smpls = unit.si_smpls[:len(si_paths)]
        else:
            si_smpls = _hmr_thetas(viewer, si_paths)
        preds = viewer.view_by_smpls(si_smpls)
        if save_preds:
            _save_preds(preds, cfg.output_dir, count, viewer.device)
        count += len(preds)

        refs = cv_utils.load_image_batch(si_paths, cfg.image_size,
                                         viewer.device)
        vid_runner = make_paired()
        vid_runner.update(preds, refs)
        paired.merge(vid_runner)
        per_video[unit.video_id] = vid_runner.evaluate()

    return {"self_imitation": paired.evaluate(), "per_video": per_video,
            "num_si_frames": count}


def load_prior_poses_arg(path):
    if not path:
        return None
    from impersonator_tpu_torch.tasks.post_tune import load_prior_poses
    return load_prior_poses(path)


def _write_section(w, title: str, results: dict) -> None:
    w.write("#" * 24 + title + "#" * 24 + "\n")
    for key, val in results.items():
        w.write(f"{key} = {val}, quality = "
                f"{TYPES_QUALITIES.get(key, '?')}\n")


def _write_per_video(w, per_video: dict) -> None:
    w.write("#" * 24 + "Per-video (self-imitation)" + "#" * 24 + "\n")
    for vid, res in per_video.items():
        w.write(f"{vid}: " + ", ".join(
            f"{k}={v:.4f}" for k, v in res.items()) + "\n")


def save_si_results(out_path: str, results: dict) -> None:
    """Single-section results.txt: the AT / NV evaluators write only the
    self-imitation block."""
    with open(out_path, "w") as w:
        _write_section(w, "Self-imitation Results", results["self_imitation"])
        _write_per_video(w, results["per_video"])


def save_results(out_path: str, results: dict) -> None:
    """The reference's save_results format."""
    with open(out_path, "w") as w:
        _write_section(w, "Self-imitation Results", results["self_imitation"])
        _write_section(w, "Cross-imitation Results",
                       results["cross_imitation"])
        _write_per_video(w, results["per_video"])


def parse_extra(argv):
    parser = argparse.ArgumentParser(allow_abbrev=False)
    parser.add_argument("--protocol_file", default="iPER_protocol.json")
    parser.add_argument("--max_videos", type=int, default=None)
    parser.add_argument("--max_frames", type=int, default=0,
                        help="0 = no cap; otherwise capped WITH a log line")
    parser.add_argument("--num_sources", type=int, default=1)
    parser.add_argument("--no-cross_imitation", dest="cross_imitation",
                        action="store_false")
    parser.add_argument("--save_preds", action="store_true")
    parser.add_argument("--save_video", action="store_true",
                        help="--task swap only: write the AT evaluator's "
                             "{src}-to-{app}.mp4 montage under "
                             "visual/self_imitation; needs ffmpeg")
    parser.add_argument("--lpips_path", default=None)
    parser.add_argument("--inception_path", default=None)
    parser.add_argument("--sphere_path", default=None)
    parser.add_argument("--senet_path", default=None)
    parser.add_argument("--osnet_path", default=None)
    parser.add_argument("--pcb_path", default=None)
    parser.add_argument("--facenet_path", default=None,
                        help="InceptionResnetV1 (vggface2) msgpack, the "
                             "reference's face-CS/FD net")
    parser.add_argument("--mtcnn_path", default=None,
                        help="MTCNN msgpack; when set, face-CS/FD crops "
                             "come from the reference's face detector "
                             "instead of SMPL head geometry (the released "
                             f"weights are at {REAL_MTCNN})")
    parser.add_argument("--yolo_cfg", default=None,
                        help="darknet cfg (yolov3-spp.cfg); with "
                             "--yolo_weights, re-id metrics embed "
                             "YOLO-detected person crops")
    parser.add_argument("--yolo_weights", default=None,
                        help="darknet .weights binary, read directly")
    parser.add_argument("--prior_poses", default=None)
    parser.add_argument("--sspe", action="store_true",
                        help="add the SSPE paired metric (HMR on preds vs "
                             "refs)")
    parser.add_argument("--protocol", default=None,
                        help="protocol registry name: iPER | fashionvideo"
                             " | MotionSynthetic | YoutubeDancer18 | "
                             "iPER_Appearance_Transfer | "
                             "MotionSynthetic_Novel_View | iPER_Novel_View"
                             " (default: the task's protocol)")
    parser.add_argument("--task", default="imitate",
                        choices=("imitate", "swap", "view"),
                        help="imitate (motion imitation, paired + "
                             "unpaired), swap (appearance transfer over "
                             "vid_name_pairs, paired), view (novel views "
                             "over the orbit range, paired)")
    parser.add_argument("--swap_part", default="body",
                        help="part group swapped in --task swap "
                             "(body | all)")
    parser.add_argument("--device", default="cuda")
    extra, _ = parser.parse_known_args(argv)
    if extra.protocol is None:
        extra.protocol = {"imitate": "iPER",
                          "swap": "iPER_Appearance_Transfer",
                          "view": "MotionSynthetic_Novel_View"}[extra.task]
    return extra


def main(argv=None):
    cfg = from_args(TestConfig, argv)
    extra = parse_extra(argv)
    device = torch.device(extra.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("evaluate runs on CUDA unless --device cpu is "
                           "given, and no card is visible")

    lpips_apply, inception_fn, face_fn, reid_fn, pcb_fn = build_extractors(
        extra.lpips_path, extra.inception_path, extra.sphere_path,
        extra.senet_path, extra.osnet_path, extra.pcb_path,
        extra.facenet_path, device=device)
    mtcnn = None
    if extra.mtcnn_path and os.path.exists(extra.mtcnn_path):
        from impersonator_tpu_torch.metrics.mtcnn import load_mtcnn
        mtcnn = load_mtcnn(extra.mtcnn_path, device=device)
    elif extra.mtcnn_path:
        print(f"evaluate: mtcnn weights not found at {extra.mtcnn_path}; "
              "face crops fall back to SMPL head geometry")
    yolo = None
    if extra.yolo_cfg and extra.yolo_weights:
        if os.path.exists(extra.yolo_cfg) and os.path.exists(
                extra.yolo_weights):
            from impersonator_tpu_torch.metrics.yolo import YoloHumanDetector
            yolo = YoloHumanDetector(extra.yolo_cfg, extra.yolo_weights,
                                     device=device)
        else:
            print("evaluate: yolo cfg/weights not found; reid metrics "
                  "embed full frames")
    if extra.task == "swap":
        results = evaluate_at_protocol(
            cfg, extra.protocol_file, extra.max_videos, extra.max_frames,
            extra.num_sources, lpips_apply, face_fn, reid_fn,
            extra.save_preds, protocol_name=extra.protocol,
            target_part=extra.swap_part, save_video=extra.save_video,
            device=device)
    elif extra.task == "view":
        results = evaluate_view_protocol(
            cfg, extra.protocol_file, extra.max_videos, extra.max_frames,
            extra.num_sources, lpips_apply, face_fn, reid_fn,
            extra.save_preds, protocol_name=extra.protocol,
            prior_poses_path=extra.prior_poses, device=device)
    else:
        results = evaluate_protocol(
            cfg, extra.protocol_file, extra.max_videos, extra.max_frames,
            extra.num_sources, extra.cross_imitation,
            lpips_apply, inception_fn, face_fn, reid_fn, pcb_fn,
            extra.save_preds, prior_poses_path=extra.prior_poses,
            sspe=extra.sspe, protocol_name=extra.protocol, mtcnn=mtcnn,
            yolo=yolo, device=device)

    os.makedirs(cfg.output_dir, exist_ok=True)
    if extra.task == "imitate":
        save_results(os.path.join(cfg.output_dir, "results.txt"), results)
    else:
        save_si_results(os.path.join(cfg.output_dir, "results.txt"),
                        results)
    with open(os.path.join(cfg.output_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({k: results[k] for k in
                      ("self_imitation", "cross_imitation")
                      if k in results}))
    return results


if __name__ == "__main__":
    main()
