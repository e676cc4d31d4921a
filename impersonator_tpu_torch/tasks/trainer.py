"""The adversarial LWB trainer (torch port of
``impersonator_tpu/tasks/trainer.py``).

* :func:`body_recovery_flow` — the frozen preprocessing: SMPL of both
  θs, the source's raster (``zbuffer_bucket_rows``), the reference's
  raster fused with the flow T (``zbuffer_bucket_flow``), the
  conditioning maps, the morphology masks and the head / body boxes, all
  without gradient;
* :class:`TrainState` — the float32 master generator and discriminator,
  their Adam optimisers and the step count;
* :class:`Trainer` / :func:`build_trainer` — the renderer, SMPL and the
  frozen VGG19 and face nets on one device, and the per-epoch learning
  rates;
* :func:`make_loss_fns`, :func:`make_policy`, :func:`make_update` (the G
  update on adv + rec + VGG + style + face + mask + TV, then the LSGAN D
  update, on body_recovery_flow products), :func:`make_train_step`
  (body_recovery_flow + the update, or the eval-only losses) and
  :func:`make_visuals_fn`.

Layout: a batch is ``{"images": (B, 2, 3, S, S), "smpls": (B, 2, 85)}``
on the trainer's device (``data.loader.stage_batch`` makes it from the
datasets' NHWC arrays); images and masks are NCHW here, the flow T
(B, S, S, 2) and the conditioning maps of the renderer NHWC until they
join the generator's inputs. The train step differentiates G's loss
with respect to G's parameters only, with D's parameters as they were
before the step, then D's loss on the same step's fake (detached), and
only then updates both.

JAX's ``build_trainer`` also builds an HMR that no step calls; the port
leaves it out.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from impersonator_tpu_torch.assets import SMPLAssets
from impersonator_tpu_torch.config import TrainConfig
from impersonator_tpu_torch.models import losses as L
from impersonator_tpu_torch.models.discriminator import PatchDiscriminator
from impersonator_tpu_torch.models.facenet import (SENet50, Sphere20a,
                                                   init_facenet)
from impersonator_tpu_torch.models.generator import ImpersonatorGenerator
from impersonator_tpu_torch.models.layers import init_weights
from impersonator_tpu_torch.ops import morphology
from impersonator_tpu_torch.ops import smpl as smpl_ops
from impersonator_tpu_torch.ops.sampler import (grid_sample_nchw,
                                                resize_bilinear_align)
from impersonator_tpu_torch.parallel.distributed import all_reduce_mean_
from impersonator_tpu_torch.tasks.renderer import SMPLRenderer


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


# --------------------------------------------------------------------------
# Frozen preprocessing (BodyRecoveryFlow)
# --------------------------------------------------------------------------

@torch.no_grad()
def body_recovery_flow(renderer: SMPLRenderer,
                       smpl_params: smpl_ops.SMPLParams, parents,
                       src_img, ref_img, src_smpl, ref_smpl,
                       bg_both: bool = False) -> dict:
    """(B, 3, S, S) images in [-1, 1] + (B, 85) θs -> the generator's
    inputs (NCHW), the flow T (B, S, S, 2), the crop masks (B, 1, S, S)
    and the fractional head / body boxes (B, 4). ``input_G_tsf_bg`` is
    None unless ``bg_both``."""
    src_info = smpl_ops.get_details(smpl_params, src_smpl, parents)
    ref_info = smpl_ops.get_details(smpl_params, ref_smpl, parents)

    src_f2verts, src_fim, _ = renderer.render_fim_wim(src_info["cam"],
                                                      src_info["verts"])
    src_f2pts = renderer.f2pts_from_f2verts(src_f2verts)
    src_cond = _nchw(renderer.encode_fim(src_fim))
    src_sil = _nhwc(src_cond[:, -1:])
    src_crop_mask = _nchw(morphology.morph(src_sil, ks=3, mode="erode"))

    ref_fim, t = renderer.render_flow(ref_info["cam"], ref_info["verts"],
                                      src_f2pts)
    ref_cond = _nchw(renderer.encode_fim(ref_fim))
    ref_sil = _nhwc(ref_cond[:, -1:])
    syn_img = grid_sample_nchw(src_img, t)

    src_bg_mask = _nchw(morphology.morph(src_sil, ks=15, mode="erode"))
    input_g_tsf_bg = None
    if bg_both:
        ref_bg_mask = _nchw(morphology.morph(ref_sil, ks=15, mode="erode"))
        input_g_tsf_bg = torch.cat([ref_img * ref_bg_mask, ref_bg_mask], 1)

    return {
        "input_G_bg": torch.cat([src_img * src_bg_mask, src_bg_mask], 1),
        "input_G_tsf_bg": input_g_tsf_bg,
        "input_G_src": torch.cat([src_img * (1 - src_crop_mask), src_cond],
                                 1),
        "input_G_tsf": torch.cat([syn_img, ref_cond], 1),
        "T": t,
        "src_crop_mask": src_crop_mask,
        "tsf_crop_mask": _nchw(morphology.morph(ref_sil, ks=3,
                                                mode="erode")),
        "head_bbox": L.head_bbox_from_kps(ref_info["j2d"]),
        "body_bbox": L.body_bbox_from_kps(ref_info["j2d"]),
    }


# --------------------------------------------------------------------------
# Train state
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    """The trained nets (float32 master weights, in place) and their
    optimisers; ``step`` counts train steps."""

    generator: ImpersonatorGenerator
    discriminator: PatchDiscriminator
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    step: int = 0


def adam(params, lr: float, b1: float, b2: float) -> torch.optim.Adam:
    """optax.adam's update rule as the JAX trainer sets it (eps 1e-8)."""
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=1e-8)


@dataclasses.dataclass
class Trainer:
    cfg: TrainConfig
    assets: SMPLAssets
    renderer: SMPLRenderer
    smpl_params: smpl_ops.SMPLParams
    device: torch.device
    vgg: Optional[nn.Module]      # frozen L.Vgg19
    face: Optional[nn.Module]     # frozen Sphere20a | SENet50

    def init_state(self, generator: ImpersonatorGenerator | None = None,
                   discriminator: PatchDiscriminator | None = None,
                   seed: int | None = None) -> TrainState:
        """A fresh state on the trainer's device: the given nets, or
        :meth:`new_generator` and :meth:`new_discriminator` with seeded
        random weights (``seed``, cfg.seed by default); Adam for
        each at its base learning rate."""
        cfg = self.cfg
        rng = torch.Generator().manual_seed(cfg.seed if seed is None
                                            else seed)
        if generator is None:
            generator = self.new_generator()
            init_weights(generator, rng)
        if discriminator is None:
            discriminator = self.new_discriminator()
            init_weights(discriminator, rng)
        generator = generator.to(self.device).train()
        discriminator = discriminator.to(self.device).train()
        return TrainState(
            generator, discriminator,
            adam(generator.parameters(), cfg.lr_G, cfg.G_adam_b1,
                 cfg.G_adam_b2),
            adam(discriminator.parameters(), cfg.lr_D, cfg.D_adam_b1,
                 cfg.D_adam_b2))

    def new_generator(self) -> nn.Module:
        """The full-width LWB generator (conv_dim 64)."""
        return ImpersonatorGenerator(bg_dim=4, src_dim=6, tsf_dim=6,
                                     repeat_num=self.cfg.repeat_num)

    def new_discriminator(self) -> nn.Module:
        """The config's PatchGAN over [image, tsf cond] (6 channels)."""
        return PatchDiscriminator(6, 64, self.cfg.d_layers,
                                  self.cfg.norm_type)

    def epoch_lr(self, epoch: int, base: float | None = None) -> float:
        """Learning rate of 0-indexed ``epoch``: ``base`` (lr_G by
        default; lr_D for the discriminator) through epoch
        nepochs_no_decay, then one (base - final_lr) / nepochs_decay step
        lower each epoch."""
        cfg = self.cfg
        base = cfg.lr_G if base is None else base
        step = (base - cfg.final_lr) / max(cfg.nepochs_decay, 1)
        return base - step * max(0, epoch - cfg.nepochs_no_decay)

    def set_lr(self, state: TrainState, lr_g: float,
               lr_d: float | None = None) -> TrainState:
        """Write G's and D's learning rates (D's defaults to G's) into
        their optimisers' parameter groups."""
        for opt, lr in ((state.g_opt, lr_g),
                        (state.d_opt, lr_g if lr_d is None else lr_d)):
            for group in opt.param_groups:
                group["lr"] = lr
        return state


def _frozen(net: nn.Module, device) -> nn.Module:
    return net.to(device).eval().requires_grad_(False)


def build_trainer(cfg: TrainConfig, assets: SMPLAssets | None = None,
                  device="cuda", seed: int | None = None) -> Trainer:
    """The trainer of ``cfg`` on ``device`` (default CUDA). The frozen
    VGG19 and face net (SENet50 when cfg.face_model names a senet, else
    Sphere20a) get seeded random weights (``seed``, cfg.seed + 7 by
    default), as the JAX trainer's do."""
    device = torch.device(device)
    assets = assets if assets is not None else cfg.assets()
    renderer = SMPLRenderer.create(assets, device, image_size=cfg.image_size,
                                   map_name=cfg.map_name,
                                   tex_size=cfg.tex_size)
    smpl_params = smpl_ops.SMPLParams.from_assets(assets, device)
    rng = torch.Generator().manual_seed(cfg.seed + 7 if seed is None
                                        else seed)
    vgg = face = None
    if cfg.use_vgg or cfg.use_style:
        vgg = _frozen(init_facenet(L.Vgg19(), rng), device)
    if cfg.use_face:
        net = SENet50() if "senet" in (cfg.face_model or "") else Sphere20a()
        face = _frozen(init_facenet(net, rng), device)
    return Trainer(cfg, assets, renderer, smpl_params, device, vgg, face)


# --------------------------------------------------------------------------
# The train step
# --------------------------------------------------------------------------

def make_policy(cfg):
    """The train step's precision policy (cfg.train_dtype). float32: a
    plain call. bfloat16: the module runs on a bf16 copy of its
    parameters made inside autograd (gradients land in the float32
    master), its 4-D float32 inputs cast to bf16, the flow (passed as
    ``flow``, the module's last argument) kept float32; every floating
    output comes back float32 before any loss term."""
    tdtype = (torch.bfloat16 if getattr(cfg, "train_dtype", "float32")
              == "bfloat16" else None)

    def to_f32(x):
        if torch.is_tensor(x):
            return x.float() if x.dtype == tdtype else x
        if isinstance(x, (list, tuple)):
            return type(x)(to_f32(v) for v in x)
        return x

    def pol(module, *args, flow=None):
        tail = () if flow is None else (flow,)
        if tdtype is None:
            return module(*args, *tail)
        params = {n: p.to(tdtype) if p.dtype == torch.float32 else p
                  for n, p in module.named_parameters()}
        args = tuple(a.to(tdtype) if torch.is_tensor(a)
                     and a.dtype == torch.float32 and a.ndim == 4 else a
                     for a in args)
        return to_f32(functional_call(module, params, args + tail))

    return pol


def _g_inputs(cfg, inputs):
    if cfg.bg_both:
        return torch.cat([inputs["input_G_bg"], inputs["input_G_tsf_bg"]], 0)
    return inputs["input_G_bg"]


def _composite(cfg, fake_bg, src_color, src_mask, tsf_color, tsf_mask):
    bs = src_color.shape[0]
    src_bg = fake_bg[:bs]
    tsf_bg = fake_bg[bs:] if cfg.bg_both else src_bg
    fake_src = src_mask * src_bg + (1 - src_mask) * src_color
    fake_tsf = tsf_mask * tsf_bg + (1 - tsf_mask) * tsf_color
    return fake_src, fake_tsf


def make_loss_fns(trainer: Trainer):
    """(g_loss_fn, d_loss_fn) over precomputed :func:`body_recovery_flow`
    inputs, so that checks can differentiate the real loss on fixed
    inputs.

    g_loss_fn(gen, disc, inputs, real_src, real_tsf) -> (total, (metrics,
    fake_tsf)); d_loss_fn(disc, fake_tsf, real_tsf, tsf_cond) -> (loss,
    metrics). Metrics are 0-d tensors; an unused term is 0."""
    cfg = trainer.cfg
    pol = make_policy(cfg)

    def _g_forward(gen, inputs):
        fake_bg, src_color, src_mask, tsf_color, tsf_mask = pol(
            gen, _g_inputs(cfg, inputs), inputs["input_G_src"],
            inputs["input_G_tsf"], flow=inputs["T"])
        fake_src, fake_tsf = _composite(cfg, fake_bg, src_color, src_mask,
                                        tsf_color, tsf_mask)
        return fake_bg, fake_src, fake_tsf, torch.cat([src_mask, tsf_mask],
                                                      0)

    def g_forward(gen, inputs):
        if cfg.remat and torch.is_grad_enabled():
            return checkpoint(_g_forward, gen, inputs, use_reentrant=False)
        return _g_forward(gen, inputs)

    def g_loss_fn(gen, disc, inputs, real_src, real_tsf):
        _, fake_src, fake_tsf, fake_masks = g_forward(gen, inputs)
        tsf_cond = inputs["input_G_tsf"][:, 3:]
        zero = fake_tsf.new_zeros(())

        d_fake = pol(disc, torch.cat([fake_tsf, tsf_cond], 1))
        loss_adv = L.lsgan_loss(d_fake, 0.0) * cfg.lambda_D_prob
        loss_rec = L.l1(fake_src, real_src) * cfg.lambda_rec

        loss_tsf = zero
        if cfg.use_vgg:
            fx = pol(trainer.vgg, fake_tsf)
            with torch.no_grad():
                fy = pol(trainer.vgg, real_tsf)
            loss_tsf = L.vgg_loss(fx, fy) * cfg.lambda_tsf

        loss_style = zero
        if cfg.use_style and cfg.lambda_style > 0:
            fx, fy = (pol(trainer.vgg, _nchw(resize_bilinear_align(
                _nhwc(x), 224, 224))) for x in (fake_tsf, real_tsf))
            loss_style = L.style_loss(fx, fy) * cfg.lambda_style

        loss_face = zero
        if cfg.use_face:
            loss_face = L.face_loss(
                trainer.face, _nhwc(fake_tsf), _nhwc(real_tsf),
                bbox1=inputs["head_bbox"], bbox2=inputs["head_bbox"],
            ) * cfg.lambda_face

        crop_masks = torch.cat([inputs["src_crop_mask"],
                                inputs["tsf_crop_mask"]], 0)
        mask_fn = L.bce if cfg.mask_bce else L.mse
        loss_mask = mask_fn(fake_masks, crop_masks) * cfg.lambda_mask
        loss_mask_smooth = (L.tv_smooth(_nhwc(fake_masks))
                            * cfg.lambda_mask_smooth
                            if cfg.lambda_mask_smooth else zero)

        total = (loss_adv + loss_rec + loss_tsf + loss_style + loss_face
                 + loss_mask + loss_mask_smooth)
        metrics = {
            "g_adv": loss_adv, "g_rec": loss_rec, "g_tsf": loss_tsf,
            "g_style": loss_style, "g_face": loss_face, "g_mask": loss_mask,
            "g_mask_smooth": loss_mask_smooth, "g_total": total,
        }
        return total, ({k: v.detach() for k, v in metrics.items()},
                       fake_tsf)

    def d_loss_fn(disc, fake_tsf, real_tsf, tsf_cond):
        d_real = pol(disc, torch.cat([real_tsf, tsf_cond], 1))
        d_fake = pol(disc, torch.cat([fake_tsf.detach(), tsf_cond], 1))
        loss = ((L.lsgan_loss(d_real, 1.0) + L.lsgan_loss(d_fake, -1.0))
                * cfg.lambda_D_prob)
        return loss, {"d_real": d_real.mean().detach(),
                      "d_fake": d_fake.mean().detach(),
                      "d_loss": loss.detach()}

    return g_loss_fn, d_loss_fn


def _grads(loss, params):
    """d loss / d params, zeros for a parameter the loss does not reach
    (optax's Adam still decays its moments)."""
    return torch.autograd.grad(loss, params, materialize_grads=True)


def _apply(opt, params, grads):
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()


def step_nets(state: TrainState, g_loss, d_loss_fn=None,
              metrics=None) -> dict:
    """One update of both nets, in place: G's gradient of ``g_loss`` over
    G's parameters; then, with ``d_loss_fn`` (called only now, after G's
    graph is freed; it returns (loss, metrics)), D's gradient of its
    loss; then Adam on G and on D. Each updated parameter keeps its
    gradient in ``.grad``. Under a process group the gradients, and the
    step's metrics, are first averaged over the processes
    (``parallel.distributed.all_reduce_mean_``): each process holds an
    equal shard of the global batch and every loss term is a mean over
    samples, so that mean is the global batch's gradient. Returns
    ``metrics`` (G's, as given) updated with D's."""
    metrics = dict(metrics or {})
    g_params = list(state.generator.parameters())
    g_grads = _grads(g_loss, g_params)
    d_grads = ()
    if d_loss_fn is not None:
        d_params = list(state.discriminator.parameters())
        d_loss, d_metrics = d_loss_fn()
        d_grads = _grads(d_loss, d_params)
        metrics.update(d_metrics)
    if dist.is_initialized():
        names = sorted(metrics)
        values = torch.stack([metrics[k].float() for k in names])
        all_reduce_mean_([*g_grads, *d_grads, values])
        metrics.update(zip(names, values.unbind()))
    _apply(state.g_opt, g_params, g_grads)
    if d_loss_fn is not None:
        _apply(state.d_opt, d_params, d_grads)
    state.step += 1
    return metrics


def _inputs(trainer, batch):
    images, smpls = batch["images"], batch["smpls"]
    src_img, tsf_img = images[:, 0], images[:, 1]
    inputs = body_recovery_flow(
        trainer.renderer, trainer.smpl_params, trainer.assets.parents,
        src_img, tsf_img, smpls[:, 0], smpls[:, 1],
        bg_both=trainer.cfg.bg_both)
    return inputs, src_img, tsf_img


def make_update(trainer: Trainer, train_d: bool = True):
    """update(state, inputs, src_img, tsf_img) -> (state, metrics): the
    train step after :func:`body_recovery_flow` — G's gradient with D's
    parameters as they are, then (``train_d``) D's on the detached fake,
    then Adam on G and D, in place (:func:`step_nets`)."""
    g_loss_fn, d_loss_fn = make_loss_fns(trainer)

    def update(state: TrainState, inputs, src_img, tsf_img):
        g_loss, (metrics, fake_tsf) = g_loss_fn(
            state.generator, state.discriminator, inputs, src_img, tsf_img)
        d_fn = (partial(d_loss_fn, state.discriminator, fake_tsf, tsf_img,
                        inputs["input_G_tsf"][:, 3:]) if train_d else None)
        return state, step_nets(state, g_loss, d_fn, metrics)

    return update


def make_train_step(trainer: Trainer, train_d: bool = True,
                    eval_only: bool = False):
    """step(state, batch) -> (state, metrics): :func:`body_recovery_flow`
    on the batch, then one G update and, with ``train_d``, one D update
    (:func:`make_update`), in place. ``eval_only``: step(state, batch) ->
    metrics, the same losses without gradients or updates (the
    validation pass)."""
    if eval_only:
        g_loss_fn, d_loss_fn = make_loss_fns(trainer)

        @torch.no_grad()
        def eval_step(state: TrainState, batch):
            inputs, src_img, tsf_img = _inputs(trainer, batch)
            _, (metrics, fake_tsf) = g_loss_fn(
                state.generator, state.discriminator, inputs, src_img,
                tsf_img)
            _, d_metrics = d_loss_fn(state.discriminator, fake_tsf, tsf_img,
                                     inputs["input_G_tsf"][:, 3:])
            metrics.update(d_metrics)
            return metrics

        return eval_step

    update = make_update(trainer, train_d)

    def train_step(state: TrainState, batch):
        return update(state, *_inputs(trainer, batch))

    return train_step


def make_visuals_fn(trainer: Trainer):
    """visuals(state, batch) -> {name: (B, S, S, 3) float32 NHWC in
    [-1, 1]}: the source, the warped source, both fakes, the background,
    the real target and the tsf mask, from the float32 master (no
    precision policy), without gradients."""
    cfg = trainer.cfg

    @torch.no_grad()
    def visuals(state: TrainState, batch):
        inputs, src_img, tsf_img = _inputs(trainer, batch)
        fake_bg, src_color, src_mask, tsf_color, tsf_mask = state.generator(
            _g_inputs(cfg, inputs), inputs["input_G_src"],
            inputs["input_G_tsf"], inputs["T"])
        fake_src, fake_tsf = _composite(cfg, fake_bg, src_color, src_mask,
                                        tsf_color, tsf_mask)
        bs = src_color.shape[0]
        out = {
            "1_real_img": src_img, "2_input_tsf": inputs["input_G_tsf"][:, :3],
            "3_fake_src": fake_src, "4_fake_tsf": fake_tsf,
            "5_fake_bg": fake_bg[:bs], "6_real_tsf": tsf_img,
            "7_fake_mask": tsf_mask.expand(-1, 3, -1, -1),
        }
        return {k: _nhwc(v).float() for k, v in out.items()}

    return visuals
