"""Motion imitation (torch port of
``impersonator_tpu/tasks/imitator.py:67-293, 300-487, 663-693``).

* :func:`personalize_core` — once per source: SMPL -> raster (fim, wim)
  -> conditioning -> morphology masks -> background inpainting (the
  generator's BG stream, or the DeepFill net when ``bg_model`` is not
  ORIGINAL) and the source-feature cache;
* :func:`imitate_core` — per frame batch: SMPL -> fused raster + flow ->
  warp of the source image -> cached-feature LWB decode -> compositing,
  and with ``front_warp`` the warped source face pasted over the head;
* :class:`Imitator` — ``personalize`` (from a given θ, or HMR's),
  ``inference_by_smpls`` and ``inference`` (HMR on each target image,
  then imitation), and the streamed feeds ``inference_from_paths`` (image
  files through the codec's prefetch ring, uint8 over H2D) and
  ``inference_from_video`` (raw I420 from ffmpeg), whose predictions can
  come back packed on the device as uint8 RGB or I420 (:489-661 of the
  JAX module).

Tensors at these functions are NHWC, flows (B, H, W, 2), as in the JAX
package; the networks run NCHW and the transpose happens at their call.
Dtype policy (JAX's ``gen_apply``): the task keeps float32 master
weights and runs a copy of the generator in the compute dtype (bf16 by
default); feature inputs in the compute dtype, flows float32, outputs
float32, the source-image warp in the compute dtype; cached source
features are cast to the compute dtype at the decode; HMR, the DeepFill
net and the geometry in float32.
With ``has_detector`` the task falls back, loudly, to no detector, as
the JAX package does where Mask R-CNN cannot be built
(``utils.detectors``); on a mesh (``parallel.mesh``) the Imitator runs
each frame batch split over the devices.
"""

from __future__ import annotations

import copy
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
from torch import nn

from impersonator_tpu_torch.assets import SMPLAssets
from impersonator_tpu_torch.config import TestConfig
from impersonator_tpu_torch.data import native
from impersonator_tpu_torch.models.generator import ImpersonatorGenerator
from impersonator_tpu_torch.models.hmr import HumanModelRecovery, init_hmr
from impersonator_tpu_torch.models.inpaintor import (InpaintSANet,
                                                     init_inpaintor)
from impersonator_tpu_torch.models.layers import init_weights
from impersonator_tpu_torch.ops import morphology
from impersonator_tpu_torch.ops.colorspace import (i420_to_rgb_device,
                                                   rgb_to_i420, rgb_to_u8)
from impersonator_tpu_torch.ops import smpl as smpl_ops
from impersonator_tpu_torch.ops.sampler import grid_sample_nchw
from impersonator_tpu_torch.parallel.mesh import (Mesh, data_devices,
                                                  to_device)
from impersonator_tpu_torch.tasks.renderer import SMPLRenderer
from impersonator_tpu_torch.utils.cv_utils import resize_img_hwc
from impersonator_tpu_torch.utils.detectors import (MaskRCNNDetector,
                                                    build_detector)
from impersonator_tpu_torch.utils.profiling import span

# Random HMR weights send θ far from any body on screen: the ResNet's
# features grow to ~10^3 through the identity BatchNorms, and fc3 adds
# them to θ three times. Scaling the seeded fc3 weights by this factor
# keeps θ within ~0.06 of mean_theta on [-1, 1] images (seed 0), so a
# randomly initialised Imitator still renders a body. Loaded weights
# replace it all.
RANDOM_HMR_FC3_SCALE = 5e-5
# Random He-normal DeepFill weights halve the activations at every gated
# layer (the sigmoid gate), so the 35-layer net's output comes out ~1e-6
# and a random background is flat. 1.8× on the feature convs keeps the
# activations O(0.1) through the net (seed 0, [-1, 1] images).
RANDOM_BGNET_GAIN = 1.8


@dataclasses.dataclass
class ImitatorNets:
    """The networks of the task. The given-SMPL path never calls HMR, so
    ``hmr`` may be None; ``bgnet`` (DeepFill) is there only when
    ``bg_model`` is not ORIGINAL."""

    generator: ImpersonatorGenerator
    hmr: Optional[nn.Module] = None
    bgnet: Optional[InpaintSANet] = None


def build_nets(cfg: TestConfig, assets: SMPLAssets) -> ImitatorNets:
    """Randomly initialised networks (float32, CPU), seeded by cfg.seed;
    the same seed gives the same weights on every device. HMR starts its
    IEF from ``assets.mean_theta`` and has its fc3 weights scaled by
    :data:`RANDOM_HMR_FC3_SCALE`; the DeepFill net is built when
    ``cfg.bg_model`` is not ORIGINAL, its feature convs scaled by
    :data:`RANDOM_BGNET_GAIN`."""
    cond_nc = 3  # uv_seg conditioning
    gen = ImpersonatorGenerator(bg_dim=4, src_dim=3 + cond_nc,
                                tsf_dim=3 + cond_nc,
                                repeat_num=cfg.repeat_num)
    rng = torch.Generator().manual_seed(cfg.seed)
    init_weights(gen, rng)
    hmr = HumanModelRecovery()
    init_hmr(hmr, rng, assets.mean_theta, fc3_scale=RANDOM_HMR_FC3_SCALE)
    bgnet = None
    if cfg.bg_model != "ORIGINAL":
        bgnet = InpaintSANet(c_dim=4)
        init_inpaintor(bgnet, rng, feature_gain=RANDOM_BGNET_GAIN)
    return ImitatorNets(gen, hmr, bgnet)


def _to_net(x, dtype):
    """NHWC float32 -> NCHW in the compute dtype."""
    return x.permute(0, 3, 1, 2).to(dtype)


def _from_net(x):
    """NCHW generator output -> NHWC float32."""
    return x.float().permute(0, 2, 3, 1)


def swap_smpl(src_cam, src_shape, tgt_smpl, first_cam,
              cam_strategy: str = "smooth"):
    """Keep the source's cam and shape, take the target's pose.

    smooth: source cam + the target's xy drift from its first frame;
    source: source cam; copy: target cam."""
    tgt_cam = tgt_smpl[:, 0:3]
    pose = tgt_smpl[:, 3:75]
    n = tgt_cam.shape[0]
    src_cam = src_cam.expand(n, 3)
    if cam_strategy == "smooth":
        delta_xy = tgt_cam[:, 1:] - first_cam[:, 1:]
        cam = torch.cat([src_cam[:, 0:1], src_cam[:, 1:] + delta_xy], dim=1)
    elif cam_strategy == "source":
        cam = src_cam
    else:
        cam = tgt_cam
    return torch.cat([cam, pose, src_shape.expand(n, src_shape.shape[-1])],
                     dim=1)


@torch.no_grad()
def personalize_core(nets: ImitatorNets, renderer: SMPLRenderer,
                     smpl_params: smpl_ops.SMPLParams, parents, img,
                     src_theta, bg_ks: int, ft_ks: int,
                     only_vis: bool = False, compute_dtype=torch.float32,
                     ext_body_mask=None):
    """img (1, S, S, 3) in [-1, 1], src_theta (1, 85) -> the cached source
    state. ``ext_body_mask`` (1, S, S, 1), a detector's body mask, takes
    the place of the eroded silhouette for the background."""
    info = smpl_ops.get_details(smpl_params, src_theta, parents)
    f2verts, fim, wim = renderer.render_fim_wim(info["cam"], info["verts"])
    p2verts = renderer.f2pts_from_f2verts(f2verts)
    if only_vis:
        p2verts = renderer.get_vis_f2pts(p2verts, fim)
    cond = renderer.encode_fim(fim)
    return personalize_from_raster(nets, img, info, fim, wim, p2verts, cond,
                                   bg_ks, ft_ks, compute_dtype,
                                   ext_body_mask)


@torch.no_grad()
def personalize_from_raster(nets: ImitatorNets, img, info, fim, wim,
                            p2verts, cond, bg_ks: int, ft_ks: int,
                            compute_dtype=torch.float32,
                            ext_body_mask=None):
    """Everything of :func:`personalize_core` after the rasterizer."""
    gen = nets.generator
    if ext_body_mask is not None:
        body_mask = ext_body_mask
        bg_mask = 1.0 - body_mask
    else:
        bg_mask = morphology.morph(cond[..., -1:], ks=bg_ks, mode="erode")
        body_mask = 1.0 - bg_mask
    if nets.bgnet is not None:
        # DeepFill's refined output over the whole frame, not its composite
        bg_img = _from_net(nets.bgnet(_to_net(img, torch.float32),
                                      _to_net(body_mask, torch.float32),
                                      only_x=True))
    else:
        bg_inputs = torch.cat([img * bg_mask, bg_mask], dim=-1)
        bg_img = _from_net(gen.run_bg(_to_net(bg_inputs, compute_dtype)))
    ft_mask = 1.0 - morphology.morph(cond[..., -1:], ks=ft_ks, mode="erode")
    src_inputs = torch.cat([img * ft_mask, cond], dim=-1)
    # cached NCHW in the compute dtype, as the decode consumes them
    feats = gen.encode_src(_to_net(src_inputs, compute_dtype))
    return {
        "theta": info["theta"], "cam": info["cam"], "shape": info["shape"],
        "pose": info["pose"], "j2d": info["j2d"],
        "fim": fim, "wim": wim, "cond": cond, "p2verts": p2verts,
        "img": img, "bg": bg_img, "feats": feats,
    }


@torch.no_grad()
def imitate_with_swap_core(nets, renderer, smpl_params, parents, src_state,
                           tgt_smpls, first_cam, cam_strategy: str = "smooth",
                           front_warp: bool = False,
                           compute_dtype=torch.float32):
    """Cam/shape swap, then one imitation step."""
    tsf = swap_smpl(src_state["cam"], src_state["shape"], tgt_smpls,
                    first_cam, cam_strategy)
    return imitate_core(nets, renderer, smpl_params, parents, src_state, tsf,
                        front_warp, compute_dtype)


@torch.no_grad()
def imitate_core(nets: ImitatorNets, renderer: SMPLRenderer,
                 smpl_params: smpl_ops.SMPLParams, parents, src_state,
                 tsf_theta, front_warp: bool = False,
                 compute_dtype=torch.float32):
    """tsf_theta (N, 85), already swapped -> preds (N, S, S, 3) in
    [-1, 1]."""
    with span("imitate.geometry"):
        info = smpl_ops.get_details(smpl_params, tsf_theta, parents)
        fim, t = renderer.render_flow(info["cam"], info["verts"],
                                      src_state["p2verts"])
        cond = renderer.encode_fim(fim)
    return imitate_from_flow(nets, renderer, src_state, fim, t, cond,
                             front_warp, compute_dtype)


@torch.no_grad()
def imitate_from_raster(nets: ImitatorNets, renderer: SMPLRenderer,
                        src_state, fim, wim, cond, front_warp: bool = False,
                        compute_dtype=torch.float32):
    """The imitation tail from classic (fim, wim) raster products: the
    flow from them, then :func:`imitate_from_flow`."""
    t = renderer.cal_bc_transform(src_state["p2verts"], fim, wim)
    return imitate_from_flow(nets, renderer, src_state, fim, t, cond,
                             front_warp, compute_dtype)


@torch.no_grad()
def imitate_from_flow(nets: ImitatorNets, renderer: SMPLRenderer,
                      src_state, fim, t, cond, front_warp: bool = False,
                      compute_dtype=torch.float32):
    """After raster + flow: warp the (batch-1) source image, decode
    against the cached features, composite over the background; with
    ``front_warp`` paste the warped source image over the target's face
    (fim's front faces) where the mask lets the generator's colour
    through."""
    tsf_img = grid_sample_nchw(_to_net(src_state["img"], compute_dtype), t)
    tsf_inputs = torch.cat([tsf_img, _to_net(cond, compute_dtype)], dim=1)
    with span("imitate.generator"):
        enc, res = cast_feats(src_state["feats"], compute_dtype)
        color, mask = nets.generator.inference(enc, res, tsf_inputs, t)
    with span("imitate.composite"):
        color, mask = _from_net(color), _from_net(mask)
        preds = mask * src_state["bg"] + (1.0 - mask) * color
        if front_warp:
            preds = paste_front(renderer, preds, fim, _from_net(tsf_img),
                                mask)
    return preds


def cast_feats(feats, dtype):
    """Cached source features (encoder outs, resnet outs) in dtype, as
    ``gen_apply``'s ``cast_in`` casts them at the decode."""
    enc, res = feats
    return [e.to(dtype) for e in enc], [r.to(dtype) for r in res]


def paste_front(renderer: SMPLRenderer, preds, fim, img, mask):
    """(1 - front) · preds + img · front · (1 - mask), front the face
    mask of fim."""
    front = renderer.encode_front_fim(fim)
    return (1 - front) * preds + img * front * (1 - mask)


@dataclasses.dataclass
class Replica:
    """What a task holds on one device of its mesh: the float32 master
    nets, the compute copy of the generator, the renderer's tables and the
    SMPL constants."""

    device: torch.device
    nets: Optional[ImitatorNets]
    compute_nets: Optional[ImitatorNets]
    renderer: SMPLRenderer
    smpl_params: smpl_ops.SMPLParams


class Imitator:
    """``personalize`` once, then ``inference_by_smpls`` or ``inference``
    per request, on one device (``device``, default CUDA; there is no CPU
    fallback) or on a mesh.

    ``nets`` are the float32 master weights, never cast in place;
    ``compute_nets`` holds the generator in the compute dtype, which every
    imitation, swap and view decode runs (:meth:`refresh_compute_nets`
    rebuilds it after the master changes). The geometry, HMR and the
    DeepFill net run in full float32 on their own
    (``utils.precision.full_fp32``); the Imitator leaves the process's
    TF32 flags as it finds them.

    ``mesh`` (a ``parallel.mesh.Mesh`` with a ``data`` axis; it takes the
    place of ``device``): the task lives on the mesh's first device, and
    the first device of every other index along ``data`` (the one at
    index 0 of each other axis) holds a :class:`Replica` copied from the
    same master (:meth:`refresh_compute_nets` copies it again). Each
    frame batch is rounded up to a multiple of the mesh's size, as JAX
    rounds it, and split into one equal piece per ``data`` index, in
    order; each of those devices runs the same core on its piece with
    the source state personalised once and copied to it, and the camera
    reference of frame 0 of the request; the pieces come back in frame
    order on the first device (or packed to the host on the streamed
    path). JAX computes each piece again on every device along the other
    axes; the port computes it once. Every device's launches of a batch
    are issued before anything synchronises, so the cards overlap.
    Without a mesh the same path runs with one replica and one piece.

    ``cfg.has_detector`` asks for Mask R-CNN body masks, which cannot be
    built here (``utils.detectors``): the fallback is printed and
    ``detector`` stays None. A detector set on the task (an object with
    ``inference(img_hwc) -> (bbox, body_mask (1, S, S, 1))``) gives the
    body mask of each :meth:`personalize`, kept as ``_src_body_mask`` for
    post-tune's refresh."""

    # The Imitator personalises in the compute dtype, as JAX's does; the
    # Swapper and Viewer personalise in float32 with the master (JAX's
    # personalise jits of those tasks pass no compute dtype).
    source_in_compute_dtype = True

    def __init__(self, cfg: TestConfig, assets: SMPLAssets | None = None,
                 nets: ImitatorNets | None = None, device="cuda",
                 mesh: Mesh | None = None):
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            if "data" not in mesh.axis_names:
                raise ValueError(f"mesh axes {mesh.axis_names} name no "
                                 f"'data' axis")
            device = mesh.device_list[0]
        self.device = torch.device(device)
        self.assets = assets if assets is not None else cfg.assets()
        self.renderer = SMPLRenderer.create(self.assets, self.device,
                                            image_size=cfg.image_size,
                                            tex_size=cfg.tex_size,
                                            has_front=cfg.front_warp)
        self.smpl_params = smpl_ops.SMPLParams.from_assets(self.assets,
                                                           self.device)
        self.parents = self.assets.parents
        self.compute_dtype = (torch.bfloat16
                              if cfg.compute_dtype == "bfloat16"
                              else torch.float32)
        self.nets = nets if nets is not None else build_nets(cfg,
                                                             self.assets)
        for net in (self.nets.generator, self.nets.hmr, self.nets.bgnet):
            if net is not None:
                net.to(device=self.device, dtype=torch.float32).eval()
        det = build_detector(cfg.has_detector, cfg.bg_ks)
        self.detector = det if isinstance(det, MaskRCNNDetector) else None
        self._src_body_mask = None
        self._other_replicas = [
            Replica(d, None, None, to_device(self.renderer, d),
                    to_device(self.smpl_params, d))
            for d in (data_devices(mesh)[1:] if mesh else ())]
        self._src_copies = (None, [])
        self.refresh_compute_nets()
        self.src_info = None
        self.first_cam = None

    def refresh_compute_nets(self):
        """Rebuild ``compute_nets`` from the float32 master: the master
        itself under float32, else a copy of its generator cast to the
        compute dtype (HMR and DeepFill stay the master's); on a mesh,
        every other device's replica is copied from both again."""
        if self.compute_dtype == torch.float32:
            self.compute_nets = self.nets
        else:
            gen = copy.deepcopy(self.nets.generator).to(self.compute_dtype)
            self.compute_nets = dataclasses.replace(
                self.nets, generator=gen.requires_grad_(False))
        for r in self._other_replicas:
            r.nets = to_device(self.nets, r.device)
            r.compute_nets = (r.nets if self.compute_nets is self.nets
                              else dataclasses.replace(
                                  r.nets, generator=to_device(
                                      self.compute_nets.generator,
                                      r.device)))

    @property
    def replicas(self) -> list:
        """One :class:`Replica` per index of the mesh's ``data`` axis, the
        task's own first; the task's own alone without a mesh."""
        return [Replica(self.device, self.nets, self.compute_nets,
                        self.renderer, self.smpl_params),
                *self._other_replicas]

    def _round_batch(self, batch: int) -> int:
        """A batch splits evenly over the mesh: round it up to a multiple
        of the mesh's size."""
        n = 1 if self.mesh is None else self.mesh.size
        return -(-batch // n) * n

    def _sources(self, state) -> list:
        """``state`` on every replica's device (copied once per state)."""
        if self._src_copies[0] is not state:
            self._src_copies = (state, [state] + [
                to_device(state, r.device) for r in self._other_replicas])
        return self._src_copies[1]

    @torch.no_grad()
    def regress_smpl(self, img224, rep: Replica | None = None):
        """img224 (B, 224, 224, 3) in [-1, 1], array or tensor -> θ
        (B, 85) float32 on the Imitator's device (or ``rep``'s, by its
        HMR)."""
        rep = rep or self.replicas[0]
        if rep.nets.hmr is None:
            raise RuntimeError("the Imitator's nets have no HMR")
        img = torch.as_tensor(img224, dtype=torch.float32,
                              device=rep.device)
        with span("hmr"):
            return rep.nets.hmr(img)

    def personalize(self, src_img, src_smpl=None):
        """src_img (S, S, 3) float in [-1, 1]; src_smpl (85,) θ, or None
        to regress it with HMR. As in the JAX package, HMR then sees
        ``resize_img_hwc(src_img, 224)``, which maps the [-1, 1] image
        once more by ``* 2 - 1``, to [-3, 1]. With a detector, its body
        mask takes the place of the eroded silhouette for the background,
        and is kept for post-tune's refresh."""
        with span("personalize"):
            self._src_body_mask = self._detect(src_img)
            self.src_info = self._source_state(src_img, src_smpl,
                                               self._src_body_mask)
        return self.src_info

    def _detect(self, src_img):
        """The detector's body mask (1, S, S, 1) of src_img on the device,
        or None without a detector."""
        if self.detector is None:
            return None
        img = (src_img.detach().cpu().numpy() if torch.is_tensor(src_img)
               else np.asarray(src_img, np.float32))
        _, body_mask = self.detector.inference(img)
        return torch.as_tensor(np.asarray(body_mask), dtype=torch.float32,
                               device=self.device)

    def _source_state(self, src_img, src_smpl=None, body_mask=None):
        """The personalised state of one source image (see
        :meth:`personalize`; image and θ as arrays or tensors; body_mask a
        detector's, or None), which the Imitator does not keep."""
        img = torch.as_tensor(src_img, dtype=torch.float32,
                              device=self.device)[None]
        if src_smpl is None:
            theta = self.regress_smpl(
                resize_img_hwc(img[0].cpu().numpy(), 224)[None])
        else:
            theta = torch.as_tensor(src_smpl, dtype=torch.float32,
                                    device=self.device).reshape(1, 85)
        nets, dtype = ((self.compute_nets, self.compute_dtype)
                       if self.source_in_compute_dtype
                       else (self.nets, torch.float32))
        return personalize_core(
            nets, self.renderer, self.smpl_params, self.parents, img,
            theta, bg_ks=self.cfg.bg_ks, ft_ks=self.cfg.ft_ks,
            only_vis=self.cfg.only_vis, compute_dtype=dtype,
            ext_body_mask=body_mask)

    def _batches(self, frames, batch: int):
        """Frames (N, ...) array or tensor -> float32 batches of ``batch``
        on the device, the last one padded with the final frame."""
        x = torch.as_tensor(frames, dtype=torch.float32, device=self.device)
        n = x.shape[0]
        pad = (-n) % batch
        if pad:
            x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
        return n, [x[i:i + batch] for i in range(0, n + pad, batch)]

    def _imitate(self, src_state, tgt_smpls, first_cam, cam_strategy,
                 rep: Replica | None = None):
        rep = rep or self.replicas[0]
        return imitate_with_swap_core(
            rep.compute_nets, rep.renderer, rep.smpl_params, self.parents,
            src_state, tgt_smpls, first_cam, cam_strategy,
            self.cfg.front_warp, self.compute_dtype)

    def _imitate_by_smpls(self, src_state, tgt_smpls, cam_strategy, batch):
        """Imitation of src_state driven by tgt_smpls (N, 85) in
        fixed-size batches (the last one padded with its final pose); the
        first θ's camera is the reference of ``smooth``."""
        n, chunks = self._batches(tgt_smpls, self._round_batch(batch))
        self.first_cam = chunks[0][0:1, 0:3]
        return self._sharded(src_state, chunks, cam_strategy)[:n]

    def _sharded(self, src_state, chunks, cam_strategy, hmr: bool = False):
        """Each batch of ``chunks`` (θs, or with ``hmr`` 224² images that
        each replica's HMR turns into θs) split into one piece per
        replica, each piece imitated by its replica from its copy of
        src_state; ``first_cam`` (already set, or with ``hmr`` frame 0's
        θ) copied to every replica. -> every frame's preds, in order, on
        the first device."""
        reps, srcs = self.replicas, self._sources(src_state)
        cams = None if hmr else [self.first_cam.to(r.device) for r in reps]
        outs = []
        for chunk in chunks:
            with span("imitate.batch"):
                pieces = [p.to(r.device) for r, p in zip(
                    reps, chunk.split(chunk.shape[0] // len(reps)))]
                if hmr:
                    pieces = [self.regress_smpl(p, r)
                              for r, p in zip(reps, pieces)]
                    if cams is None:
                        self.first_cam = pieces[0][0:1, 0:3]
                        cams = [self.first_cam.to(r.device) for r in reps]
                outs += [self._imitate(s, p, c, cam_strategy, r)
                         for r, s, p, c in zip(reps, srcs, pieces, cams)]
        return torch.cat([o.to(self.device) for o in outs])

    def _require_source(self):
        if self.src_info is None:
            raise RuntimeError("call personalize() first")

    def inference_by_smpls(self, tgt_smpls, cam_strategy: str = "smooth",
                           batch: int = 8):
        """tgt_smpls (N, 85) array or tensor -> preds (N, S, S, 3) on the
        Imitator's device, in fixed-size batches (the last one padded with
        its final pose)."""
        self._require_source()
        return self._imitate_by_smpls(self.src_info, tgt_smpls,
                                      cam_strategy, batch)

    def inference(self, tgt_imgs224, cam_strategy: str = "smooth",
                  batch: int = 8):
        """tgt_imgs224 (N, 224, 224, 3) in [-1, 1], array or tensor ->
        preds (N, S, S, 3): per batch, HMR then the imitation step; the
        first batch's first θ gives the camera reference, and the last
        batch is padded with its final image."""
        self._require_source()
        n, chunks = self._batches(tgt_imgs224, self._round_batch(batch))
        return self._sharded(self.src_info, chunks, cam_strategy,
                             hmr=True)[:n]

    @torch.no_grad()
    def regress_smpl_u8(self, u8, rep: Replica | None = None):
        """uint8 RGB (B, 224, 224, 3), array or tensor -> θ (B, 85): the
        [-1, 1] normalise ``u8 / 127.5 - 1`` runs on the device (``rep``'s
        when given)."""
        rep = rep or self.replicas[0]
        x = torch.as_tensor(u8, device=rep.device)
        return self.regress_smpl(x.float() / 127.5 - 1.0, rep)

    @torch.no_grad()
    def regress_smpl_i420(self, packed, rep: Replica | None = None):
        """Packed I420 (B, 336, 224) uint8 -> θ (B, 85): the BT.601
        inverse runs on the device (:func:`..ops.colorspace.
        i420_to_rgb_device`; ``rep``'s when given)."""
        rep = rep or self.replicas[0]
        x = torch.as_tensor(packed, device=rep.device)
        return self.regress_smpl(i420_to_rgb_device(x), rep)

    def inference_from_paths(self, paths, cam_strategy: str = "smooth",
                             batch: int = 8, as_uint8: bool = False,
                             as_i420: bool = False):
        """Image files -> preds, streamed: the codec's prefetch ring
        (``data.native``, 3 threads, 2·batch frames ahead; the codec of
        the Imitator's device type) decodes and resizes to 224² uint8
        while the device runs earlier batches; the frames go to the
        device as uint8 and HMR normalises them there. The last batch is
        padded with the last path. Returns a device tensor (N, S, S, 3),
        or with ``as_uint8`` / ``as_i420`` a host array packed on the
        device (see :meth:`_stream_infer`)."""
        self._require_source()
        paths = list(paths)
        if not paths:
            raise ValueError("no frames to imitate")
        batch = self._round_batch(batch)
        n = len(paths)
        all_paths = paths + [paths[-1]] * ((-n) % batch)

        def batches():
            with native.NativeImageLoader(224, threads=3,
                                          capacity=2 * batch, u8=True,
                                          device=self.device) as loader:
                ahead = min(2 * batch, len(all_paths))
                for p in all_paths[:ahead]:
                    loader.submit(p)
                buf = []
                for _ in range(len(all_paths)):
                    frame, _ = loader.next()
                    if ahead < len(all_paths):
                        loader.submit(all_paths[ahead])
                        ahead += 1
                    buf.append(frame)
                    if len(buf) == batch:
                        yield np.stack(buf)
                        buf = []

        return self._stream_infer(batches(), self.regress_smpl_u8, n,
                                  cam_strategy, as_uint8, as_i420)

    def inference_from_video(self, video_path: str,
                             cam_strategy: str = "smooth", batch: int = 8,
                             as_uint8: bool = False, as_i420: bool = False,
                             fps: int | None = None):
        """A video file -> preds: ffmpeg decodes to raw I420 at 224²
        (``utils.video.stream_i420``; raises without ffmpeg), the packed
        frames go to the device at 1.5 bytes a pixel and HMR unpacks them
        there. The frame count is known only at the end: the last batch is
        padded with its last frame and the pad dropped."""
        self._require_source()
        from impersonator_tpu_torch.utils.video import stream_i420
        batch = self._round_batch(batch)
        counter = {"n": 0}

        def batches():
            buf = []
            for frame in stream_i420(video_path, size=224, fps=fps):
                buf.append(frame)
                counter["n"] += 1
                if len(buf) == batch:
                    yield np.stack(buf)
                    buf = []
            if buf:
                buf.extend([buf[-1]] * (batch - len(buf)))
                yield np.stack(buf)

        out = self._stream_infer(batches(), self.regress_smpl_i420, None,
                                 cam_strategy, as_uint8, as_i420)
        return out[:counter["n"]]

    @staticmethod
    def _upload(chunk, stream, device):
        """A host batch -> ``device``: from pinned memory on ``stream``
        (the compute stream waits for it), or as it is on the CPU."""
        host = torch.from_numpy(np.ascontiguousarray(chunk))
        if stream is None:
            return host.to(device)
        with torch.cuda.stream(stream):
            x = host.pin_memory().to(device, non_blocking=True)
        compute = torch.cuda.current_stream(device)
        compute.wait_stream(stream)
        x.record_stream(compute)
        return x

    @staticmethod
    def _readback(packed, stream):
        """Start ``packed``'s copy into pinned host memory on ``stream``
        after the compute that made it -> (host tensor, event)."""
        host = torch.empty(packed.shape, dtype=packed.dtype,
                           pin_memory=True)
        stream.wait_stream(torch.cuda.current_stream(packed.device))
        with torch.cuda.stream(stream):
            host.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        packed.record_stream(stream)
        return host, done

    @staticmethod
    def _drain(host, done):
        done.synchronize()
        return host.numpy()

    @torch.no_grad()
    def _stream_infer(self, chunks, hmr_fn, n, cam_strategy, as_uint8,
                      as_i420):
        """The streaming core: for each host batch of ``chunks`` (uint8 RGB
        224² or packed I420), the upload, ``hmr_fn`` and the imitation
        step; the first batch's first θ gives the camera reference
        (``first_cam``). With ``as_i420`` (:func:`..ops.colorspace.
        rgb_to_i420`) or ``as_uint8`` the preds are packed on the device
        and each batch's readback goes into pinned host memory on a copy
        stream, drained by a thread, so batch k transfers while batch k+1
        decodes and computes; the result is then a host array (N, ...),
        else a device tensor (on the first device of a mesh). On CUDA,
        uploads and readbacks run on two side streams of their own on each
        device. ``hmr_fn(x, replica)`` regresses a batch on a replica; each
        host batch splits into one piece per replica, and the camera
        reference is frame 0's. ``n`` None keeps every frame. An
        empty stream raises ValueError."""
        pack = rgb_to_i420 if as_i420 else rgb_to_u8 if as_uint8 else None
        cuda = self.device.type == "cuda"
        reps = self.replicas
        up_streams = [torch.cuda.Stream(r.device) if cuda else None
                      for r in reps]
        down_streams = [torch.cuda.Stream(r.device) if cuda else None
                        for r in reps]
        drain = ThreadPoolExecutor(1) if pack is not None and cuda else None
        srcs = self._sources(self.src_info)
        outs = []
        cams = None
        self.first_cam = None
        try:
            for chunk in chunks:
                pieces = np.split(chunk, len(reps))
                thetas = [hmr_fn(self._upload(p, up, r.device), r)
                          for r, p, up in zip(reps, pieces, up_streams)]
                if cams is None:
                    self.first_cam = thetas[0][0:1, 0:3]
                    cams = [self.first_cam.to(r.device) for r in reps]
                for r, s, th, c, down in zip(reps, srcs, thetas, cams,
                                             down_streams):
                    pred = self._imitate(s, th, c, cam_strategy, r)
                    if pack is None:
                        outs.append(pred)
                    elif cuda:
                        outs.append(drain.submit(
                            self._drain, *self._readback(pack(pred), down)))
                    else:
                        outs.append(pack(pred).numpy())
            if not outs:
                raise ValueError("stream produced no frames (unreadable "
                                 "or empty video?)")
            if pack is None:
                out = torch.cat([o.to(self.device) for o in outs])
            else:
                out = np.concatenate([o.result() if drain is not None
                                      else o for o in outs])
        finally:
            if drain is not None:
                drain.shutdown()
        return out if n is None else out[:n]
