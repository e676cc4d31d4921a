"""The paper's ablation trainers, ``concat`` / ``texture_warping`` /
``feature_warping`` (torch port of
``impersonator_tpu/tasks/trainer_baseline.py:52-257``).

The three share one loss recipe (LSGAN adversarial + L1 reconstruction
of the target + VGG + face + mask MSE + mask TV) and one conditional
PatchGAN over [image, src cond, tsf cond] (9 channels); they differ in
how the generator's inputs are built (:func:`baseline_recovery_flow`):

* ``concat`` — no warping: one ResUnet over [src image, src cond, tsf
  cond];
* ``texture_warping`` — the source's per-face texture re-rendered in the
  target pose (``SMPLRenderer.extract_texture`` / ``render_textured``),
  beside the tsf cond;
* ``feature_warping`` — the masked source stream and the tsf cond, with
  one bottleneck feature warp by the flow T (``cal_bc_transform``).

Each step rasterises the source and the target once each
(``zbuffer_bucket_rows``). As in the JAX package, the baselines apply
their nets without the precision policy: they train in float32 whatever
``--train_dtype`` says. Batches are the base trainer's.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch

from impersonator_tpu_torch.assets import SMPLAssets
from impersonator_tpu_torch.config import TrainConfig
from impersonator_tpu_torch.models import losses as L
from impersonator_tpu_torch.models.baseline import (ConcatGenerator,
                                                    FeatureWarpingGenerator)
from impersonator_tpu_torch.models.discriminator import PatchDiscriminator
from impersonator_tpu_torch.ops import morphology
from impersonator_tpu_torch.ops import smpl as smpl_ops
from impersonator_tpu_torch.tasks.renderer import SMPLRenderer
from impersonator_tpu_torch.tasks.trainer import (Trainer, TrainState,
                                                  _nchw, _nhwc, build_trainer,
                                                  step_nets)

BASELINE_MODES = ("concat", "texture_warping", "feature_warping")


@torch.no_grad()
def baseline_recovery_flow(renderer: SMPLRenderer,
                           smpl_params: smpl_ops.SMPLParams, parents,
                           src_img, ref_img, src_smpl, ref_smpl,
                           mode: str) -> dict:
    """(B, 3, S, S) images + (B, 85) θs -> one ablation mode's generator
    and discriminator inputs (NCHW), the tsf crop mask and the head box,
    without gradient."""
    if mode not in BASELINE_MODES:
        raise ValueError(f"unknown baseline mode {mode}")
    src_info = smpl_ops.get_details(smpl_params, src_smpl, parents)
    ref_info = smpl_ops.get_details(smpl_params, ref_smpl, parents)

    src_f2verts, src_fim, _ = renderer.render_fim_wim(src_info["cam"],
                                                      src_info["verts"])
    src_cond = renderer.encode_fim(src_fim)                    # NHWC
    _, ref_fim, ref_wim = renderer.render_fim_wim(ref_info["cam"],
                                                  ref_info["verts"])
    tsf_cond = renderer.encode_fim(ref_fim)

    src_bg_mask = _nchw(morphology.morph(src_cond[..., -1:], ks=15,
                                         mode="erode"))
    out = {
        "input_G_bg": torch.cat([src_img * src_bg_mask, src_bg_mask], 1),
        "src_cond": _nchw(src_cond),
        "tsf_cond": _nchw(tsf_cond),
        "tsf_crop_mask": _nchw(morphology.morph(tsf_cond[..., -1:], ks=3,
                                                mode="erode")),
        "head_bbox": L.head_bbox_from_kps(ref_info["j2d"]),
    }
    if mode == "concat":
        out["input_G"] = torch.cat([src_img, out["src_cond"],
                                    out["tsf_cond"]], 1)
    elif mode == "texture_warping":
        tex = renderer.extract_texture(_nhwc(src_img), src_info["cam"],
                                       src_info["verts"])
        tex_render = renderer.render_textured(ref_fim, ref_wim, tex)
        out["input_G"] = torch.cat([_nchw(tex_render), out["tsf_cond"]], 1)
    else:
        src_crop_mask = _nchw(morphology.morph(src_cond[..., -1:], ks=3,
                                               mode="erode"))
        out["input_G_src"] = torch.cat([src_img * (1 - src_crop_mask),
                                        out["src_cond"]], 1)
        out["input_G_tsf"] = out["tsf_cond"]
        out["T"] = renderer.cal_bc_transform(
            renderer.f2pts_from_f2verts(src_f2verts), ref_fim, ref_wim)
    return out


@dataclasses.dataclass
class BaselineTrainer(Trainer):
    """The base trainer's renderer, frozen nets, learning-rate schedule,
    state and checkpoints, with the ablation's generator (cfg.model) and
    the conditional PatchGAN."""

    @property
    def mode(self) -> str:
        return self.cfg.model

    def new_generator(self):
        """The full-width ablation generator (conv_dim 64)."""
        if self.mode == "feature_warping":
            return FeatureWarpingGenerator(repeat_num=self.cfg.repeat_num)
        tsf_dim = 9 if self.mode == "concat" else 6
        return ConcatGenerator(tsf_dim=tsf_dim,
                               repeat_num=self.cfg.repeat_num)

    def new_discriminator(self) -> PatchDiscriminator:
        """The PatchGAN over [image, src cond, tsf cond] (9 channels)."""
        return PatchDiscriminator(9, 64, self.cfg.d_layers,
                                  self.cfg.norm_type)


def build_baseline_trainer(cfg: TrainConfig,
                           assets: SMPLAssets | None = None, device="cuda",
                           seed: int | None = None) -> BaselineTrainer:
    """The ablation trainer of cfg.model on ``device`` (default CUDA)."""
    if cfg.model not in BASELINE_MODES:
        raise ValueError(f"not a baseline mode: {cfg.model}")
    base = build_trainer(cfg, assets, device=device, seed=seed)
    return BaselineTrainer(**{f.name: getattr(base, f.name)
                              for f in dataclasses.fields(base)})


def baseline_inputs(trainer: BaselineTrainer, batch):
    """:func:`baseline_recovery_flow` on a batch -> (inputs, tsf_img)."""
    images, smpls = batch["images"], batch["smpls"]
    inputs = baseline_recovery_flow(
        trainer.renderer, trainer.smpl_params, trainer.assets.parents,
        images[:, 0], images[:, 1], smpls[:, 0], smpls[:, 1], trainer.mode)
    return inputs, images[:, 1]


def make_baseline_loss_fns(trainer: BaselineTrainer):
    """(g_loss_fn, d_loss_fn) over :func:`baseline_recovery_flow`'s
    products, in float32.

    g_loss_fn(gen, disc, inputs, real_tsf) -> (total, (metrics,
    fake_tsf)); d_loss_fn(disc, inputs, fake_tsf, real_tsf) -> (total,
    metrics). ``d_real`` / ``d_fake`` are the two LSGAN losses."""
    cfg = trainer.cfg

    def g_forward(gen, inputs):
        if trainer.mode == "feature_warping":
            fake_bg, _, _, tsf_color, tsf_mask = gen(
                inputs["input_G_bg"], inputs["input_G_src"],
                inputs["input_G_tsf"], inputs["T"])
        else:
            fake_bg, tsf_color, tsf_mask = gen(inputs["input_G_bg"],
                                               inputs["input_G"])
        fake_tsf = tsf_mask * fake_bg + (1 - tsf_mask) * tsf_color
        return fake_tsf, tsf_mask

    def d_input(img, inputs):
        return torch.cat([img, inputs["src_cond"], inputs["tsf_cond"]], 1)

    def g_loss_fn(gen, disc, inputs, real_tsf):
        fake_tsf, fake_mask = g_forward(gen, inputs)
        zero = fake_tsf.new_zeros(())
        loss_adv = (L.lsgan_loss(disc(d_input(fake_tsf, inputs)), 0.0)
                    * cfg.lambda_D_prob)
        loss_rec = L.l1(fake_tsf, real_tsf) * cfg.lambda_rec
        loss_vgg = zero
        if cfg.use_vgg:
            with torch.no_grad():
                fy = trainer.vgg(real_tsf)
            loss_vgg = L.vgg_loss(trainer.vgg(fake_tsf), fy) * cfg.lambda_tsf
        loss_face = zero
        if cfg.use_face:
            loss_face = L.face_loss(
                trainer.face, _nhwc(fake_tsf), _nhwc(real_tsf),
                bbox1=inputs["head_bbox"], bbox2=inputs["head_bbox"],
            ) * cfg.lambda_face
        loss_mask = L.mse(fake_mask, inputs["tsf_crop_mask"]) * cfg.lambda_mask
        loss_mask_tv = L.tv_smooth(_nhwc(fake_mask)) * cfg.lambda_mask_smooth
        total = (loss_adv + loss_rec + loss_vgg + loss_face + loss_mask
                 + loss_mask_tv)
        metrics = {"g_adv": loss_adv, "g_rec": loss_rec, "g_vgg": loss_vgg,
                   "g_face": loss_face, "g_mask": loss_mask,
                   "g_mask_tv": loss_mask_tv, "g_total": total}
        return total, ({k: v.detach() for k, v in metrics.items()},
                       fake_tsf)

    def d_loss_fn(disc, inputs, fake_tsf, real_tsf):
        loss_real = (L.lsgan_loss(disc(d_input(real_tsf, inputs)), 1.0)
                     * cfg.lambda_D_prob)
        loss_fake = (L.lsgan_loss(disc(d_input(fake_tsf.detach(), inputs)),
                                  -1.0) * cfg.lambda_D_prob)
        total = loss_real + loss_fake
        return total, {"d_real": loss_real.detach(),
                       "d_fake": loss_fake.detach(),
                       "d_total": total.detach()}

    return g_loss_fn, d_loss_fn


def make_train_step(trainer: BaselineTrainer, train_d: bool = True):
    """step(state, batch) -> (state, metrics) of one ablation step:
    :func:`baseline_recovery_flow`, G's gradient with D as it is, then
    (``train_d``) D's on the detached fake, then Adam on both, in place
    (``trainer.step_nets``)."""
    g_loss_fn, d_loss_fn = make_baseline_loss_fns(trainer)

    def train_step(state: TrainState, batch):
        inputs, tsf_img = baseline_inputs(trainer, batch)
        g_loss, (metrics, fake_tsf) = g_loss_fn(
            state.generator, state.discriminator, inputs, tsf_img)
        d_fn = (partial(d_loss_fn, state.discriminator, inputs, fake_tsf,
                        tsf_img) if train_d else None)
        return state, step_nets(state, g_loss, d_fn, metrics)

    return train_step
