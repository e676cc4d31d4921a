"""The background-augmented adversarial trainer (torch port of
``impersonator_tpu/tasks/trainer_aug.py:34-192``).

On top of the base trainer (:mod:`.trainer`), a Places2 image masked by
the SOURCE silhouette is a third background stream, which the generator
learns to restore, and the discriminator is a Global + Local pair
(:class:`..models.discriminator.GlobalLocalDiscriminator`): the global
PatchGAN sees [restored background, its mask], the local one
[image, tsf cond] cropped to the target's body box.

A batch adds ``'bg'`` (B, 3, S, S) to the base trainer's (the
``ImPerPlaceDataset`` / ``ImPerFashionPlaceDataset`` / ``synthetic_bg``
streams give it). The background rows are [src | aug | tsf], tsf only
with ``bg_both``. The step has the base trainer's shape: G's gradient
with D as it is, D's on the detached fakes, then both Adam updates, in
place; ``--train_dtype`` goes through ``trainer.make_policy`` and
``--remat`` through ``torch.utils.checkpoint``.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from impersonator_tpu_torch.assets import SMPLAssets
from impersonator_tpu_torch.config import TrainConfig
from impersonator_tpu_torch.models import losses as L
from impersonator_tpu_torch.models.discriminator import \
    GlobalLocalDiscriminator
from impersonator_tpu_torch.ops.sampler import resize_bilinear_align
from impersonator_tpu_torch.tasks.trainer import (Trainer, TrainState,
                                                  _inputs, _nchw, _nhwc,
                                                  build_trainer, make_policy,
                                                  step_nets)


@dataclasses.dataclass
class AugTrainer(Trainer):
    """The base trainer with the Global + Local discriminator."""

    def new_discriminator(self) -> GlobalLocalDiscriminator:
        """The global PatchGAN over [background, mask] (4 channels) and the
        local one over [image, tsf cond] (6), --d_layers deep."""
        return GlobalLocalDiscriminator(4, 6, 64, self.cfg.d_layers,
                                        self.cfg.norm_type)


def build_aug_trainer(cfg: TrainConfig, assets: SMPLAssets | None = None,
                      device="cuda", seed: int | None = None) -> AugTrainer:
    """:func:`.trainer.build_trainer`'s trainer (default CUDA) with the
    Global + Local discriminator."""
    base = build_trainer(cfg, assets, device=device, seed=seed)
    return AugTrainer(**{f.name: getattr(base, f.name)
                         for f in dataclasses.fields(base)})


def init_aug_state(trainer: AugTrainer, generator=None, discriminator=None,
                   seed: int | None = None) -> TrainState:
    """``trainer.init_state``: the given nets, or seeded full-width ones."""
    return trainer.init_state(generator, discriminator, seed)


def aug_inputs(trainer: Trainer, batch):
    """:func:`.trainer.body_recovery_flow` on the batch plus the extra
    stream ``input_G_aug_bg`` = [bg · src_bg_mask, src_bg_mask] -> (inputs,
    src_img, tsf_img, bg)."""
    inputs, src_img, tsf_img = _inputs(trainer, batch)
    aug_bg = batch["bg"]
    src_bg_mask = inputs["input_G_bg"][:, -1:]
    inputs["input_G_aug_bg"] = torch.cat([aug_bg * src_bg_mask,
                                          src_bg_mask], 1)
    return inputs, src_img, tsf_img, aug_bg


def make_aug_loss_fns(trainer: Trainer):
    """(g_loss_fn, d_loss_fn) over :func:`aug_inputs`' products.

    g_loss_fn(gen, disc, inputs, real_src, real_tsf, real_bg) -> (total,
    (metrics, fake_aug_bg, fake_tsf)); d_loss_fn(disc, fake_aug_bg,
    fake_tsf, real_bg, real_tsf, inputs) -> (loss, metrics). Metrics are
    0-d tensors; an unused term is 0."""
    cfg = trainer.cfg
    pol = make_policy(cfg)

    def _g_forward(gen, inputs):
        streams = [inputs["input_G_bg"], inputs["input_G_aug_bg"]]
        if cfg.bg_both:
            streams.append(inputs["input_G_tsf_bg"])
        fake_bg, src_color, src_mask, tsf_color, tsf_mask = pol(
            gen, torch.cat(streams, 0), inputs["input_G_src"],
            inputs["input_G_tsf"], flow=inputs["T"])
        bs = src_color.shape[0]
        src_bg = fake_bg[:bs]
        aug_bg = fake_bg[bs:2 * bs]
        tsf_bg = fake_bg[2 * bs:3 * bs] if cfg.bg_both else src_bg
        fake_src = src_mask * src_bg + (1 - src_mask) * src_color
        fake_tsf = tsf_mask * tsf_bg + (1 - tsf_mask) * tsf_color
        return aug_bg, fake_src, fake_tsf, torch.cat([src_mask, tsf_mask], 0)

    def g_forward(gen, inputs):
        if cfg.remat and torch.is_grad_enabled():
            return checkpoint(_g_forward, gen, inputs, use_reentrant=False)
        return _g_forward(gen, inputs)

    def d_apply(disc, fake_aug_bg, tsf_imgs, inputs):
        global_x = torch.cat([fake_aug_bg, inputs["input_G_aug_bg"][:, -1:]],
                             1)
        local_x = torch.cat([tsf_imgs, inputs["input_G_tsf"][:, 3:]], 1)
        rects = inputs["body_bbox"] * float(cfg.image_size)   # pixels
        return pol(disc, global_x, local_x, rects)

    def vgg(x):
        return pol(trainer.vgg, x)

    def vgg224(x):
        return pol(trainer.vgg, _nchw(resize_bilinear_align(_nhwc(x), 224,
                                                            224)))

    def g_loss_fn(gen, disc, inputs, real_src, real_tsf, real_bg):
        fake_aug_bg, fake_src, fake_tsf, fake_masks = g_forward(gen, inputs)
        zero = fake_tsf.new_zeros(())

        d_fake = d_apply(disc, fake_aug_bg, fake_tsf, inputs)
        loss_adv = L.lsgan_loss(d_fake, 0.0) * cfg.lambda_D_prob
        loss_rec = L.l1(fake_src, real_src) * cfg.lambda_rec

        loss_tsf = zero
        if cfg.use_vgg:
            with torch.no_grad():
                fy, by = vgg(real_tsf), vgg(real_bg)
            loss_tsf = (L.vgg_loss(vgg(fake_tsf), fy)
                        + L.vgg_loss(vgg(fake_aug_bg), by)) * cfg.lambda_tsf
        loss_style = zero
        if cfg.use_style and cfg.lambda_style > 0:
            loss_style = (L.style_loss(vgg224(fake_tsf), vgg224(real_tsf))
                          + L.style_loss(vgg224(fake_aug_bg),
                                         vgg224(real_bg))) * cfg.lambda_style
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
        loss_smooth = (L.tv_smooth(_nhwc(fake_masks))
                       * cfg.lambda_mask_smooth
                       if cfg.lambda_mask_smooth else zero)

        total = (loss_adv + loss_rec + loss_tsf + loss_style + loss_face
                 + loss_mask + loss_smooth)
        metrics = {"g_adv": loss_adv, "g_rec": loss_rec, "g_tsf": loss_tsf,
                   "g_style": loss_style, "g_face": loss_face,
                   "g_mask": loss_mask, "g_mask_smooth": loss_smooth,
                   "g_total": total}
        return total, ({k: v.detach() for k, v in metrics.items()},
                       fake_aug_bg, fake_tsf)

    def d_loss_fn(disc, fake_aug_bg, fake_tsf, real_bg, real_tsf, inputs):
        d_fake = d_apply(disc, fake_aug_bg.detach(), fake_tsf.detach(),
                         inputs)
        d_real = d_apply(disc, real_bg, real_tsf, inputs)
        loss = ((L.lsgan_loss(d_real, 1.0) + L.lsgan_loss(d_fake, -1.0))
                * cfg.lambda_D_prob)
        return loss, {"d_real": d_real.mean().detach(),
                      "d_fake": d_fake.mean().detach(),
                      "d_loss": loss.detach()}

    return g_loss_fn, d_loss_fn


def make_aug_update(trainer: Trainer, train_d: bool = True):
    """update(state, inputs, src_img, tsf_img, bg) -> (state, metrics):
    the aug step after :func:`aug_inputs` — G's gradient with D's
    parameters as they are, then (``train_d``) D's on the detached fakes,
    then Adam on G and D, in place (``trainer.step_nets``)."""
    g_loss_fn, d_loss_fn = make_aug_loss_fns(trainer)

    def update(state: TrainState, inputs, src_img, tsf_img, real_bg):
        g_loss, (metrics, fake_aug_bg, fake_tsf) = g_loss_fn(
            state.generator, state.discriminator, inputs, src_img, tsf_img,
            real_bg)
        d_fn = (partial(d_loss_fn, state.discriminator, fake_aug_bg,
                        fake_tsf, real_bg, tsf_img, inputs)
                if train_d else None)
        return state, step_nets(state, g_loss, d_fn, metrics)

    return update


def make_aug_train_step(trainer: Trainer, train_d: bool = True):
    """step(state, batch{'images', 'smpls', 'bg'}) -> (state, metrics):
    :func:`aug_inputs` on the batch, then :func:`make_aug_update`'s
    update, in place."""
    update = make_aug_update(trainer, train_d)

    def train_step(state: TrainState, batch):
        return update(state, *aug_inputs(trainer, batch))

    return train_step
