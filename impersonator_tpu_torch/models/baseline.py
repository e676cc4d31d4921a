"""The paper's ablation generators (torch port of
``impersonator_tpu/models/baseline.py:33-108``), NCHW.

* :class:`ConcatGenerator` — no warping: one ResUnet over early-
  concatenated inputs (``tsf_dim`` 9 for ``concat``'s [source image,
  source cond, target cond], 6 for ``texture_warping``'s [re-rendered
  texture, target cond]);
* :func:`texture_warp_inputs` — the source's pixels warped by T beside
  the target cond;
* :class:`FeatureWarpingGenerator` — the source's bottleneck features
  warped by T once, at the target stream's bottleneck entry, instead of
  the Liquid Warping Block's link at every stage.

All are built from the LWB generator's ResNet / ResUnet stacks with 3×3
down and up convs; ``utils.convert`` maps the JAX package's params onto
them.
"""

from __future__ import annotations

import torch
from torch import nn

from impersonator_tpu_torch.models.generator import (ResNetGenerator,
                                                     ResUnetGenerator, warp)
from impersonator_tpu_torch.ops.sampler import grid_sample_nchw


class ConcatGenerator(nn.Module):
    """The background stream and one ResUnet over ``tsf_dim`` input
    channels -> (img_bg, tsf_img, tsf_mask)."""

    def __init__(self, bg_dim: int = 4, tsf_dim: int = 9, conv_dim: int = 64,
                 repeat_num: int = 6, n_down: int = 3):
        super().__init__()
        self.bg_model = ResNetGenerator(bg_dim, conv_dim, repeat_num, 3,
                                        n_down)
        self.tsf_model = ResUnetGenerator(tsf_dim, conv_dim, repeat_num, 3,
                                          n_down)

    def forward(self, bg_inputs, inputs):
        tsf_img, tsf_mask = self.tsf_model(inputs)
        return self.bg_model(bg_inputs), tsf_img, tsf_mask

    def inference(self, inputs):
        return self.tsf_model(inputs)


def texture_warp_inputs(src_img, t, tsf_cond):
    """[src_img warped by T, tsf_cond] on the channel axis (NCHW)."""
    return torch.cat([grid_sample_nchw(src_img, t), tsf_cond], 1)


class FeatureWarpingGenerator(nn.Module):
    """Three streams as the LWB generator's, with one feature warp: the
    source's last encoder output warped by T is added to the target's
    before its residual blocks -> (img_bg, src_img, src_mask, tsf_img,
    tsf_mask)."""

    def __init__(self, bg_dim: int = 4, src_dim: int = 6, tsf_dim: int = 3,
                 conv_dim: int = 64, repeat_num: int = 6, n_down: int = 3):
        super().__init__()
        self.bg_model = ResNetGenerator(bg_dim, conv_dim, repeat_num, 3,
                                        n_down)
        self.src_model = ResUnetGenerator(src_dim, conv_dim, repeat_num, 3,
                                          n_down)
        self.tsf_model = ResUnetGenerator(tsf_dim, conv_dim, repeat_num, 3,
                                          n_down)

    def forward(self, bg_inputs, src_inputs, tsf_inputs, t):
        img_bg = self.bg_model(bg_inputs)
        src, tsf = self.src_model, self.tsf_model
        src_enc = src.encode(src_inputs)
        src_x = src_enc[-1]
        for block in src.resnets:
            src_x = block(src_x)
        src_img, src_mask = src.regress(src.decode(src_x, src_enc))

        tsf_enc = tsf.encode(tsf_inputs)
        tsf_x = tsf_enc[-1] + warp(src_enc[-1], t)
        for block in tsf.resnets:
            tsf_x = block(tsf_x)
        tsf_img, tsf_mask = tsf.regress(tsf.decode(tsf_x, tsf_enc))
        return img_bg, src_img, src_mask, tsf_img, tsf_mask
