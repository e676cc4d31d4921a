"""Liquid Warping GAN generator (torch port of
``impersonator_tpu/models/generator.py:47-283``), NCHW.

Three streams: ``bg_model`` inpaints the background, ``src_model``
encodes the source, ``tsf_model`` synthesises the frame, adding the
source features warped by the flow T (resized per stage) at every
encoder stage and every residual block (the Liquid Warping Block).
Flows are (B, H, W, 2) in [-1, 1], -2 on background.

Ported: ``forward`` (the training forward: ``run_bg`` + ``infer_front``),
``run_bg``, ``encode_src``, ``inference`` (imitation and novel view),
``swap`` (appearance transfer) and ``infer_front`` (both streams live).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from impersonator_tpu_torch.models.layers import (ResidualBlock, conv,
                                                  conv_in_relu,
                                                  deconv_in_relu)
from impersonator_tpu_torch.ops.sampler import grid_sample_nchw, resize_flow


def warp(x, t_full):
    """LWB warp: resize T to x's resolution and sample x bilinearly."""
    return grid_sample_nchw(x, resize_flow(t_full, x.shape[2], x.shape[3]))


class ResNetGenerator(nn.Module):
    """Encoder / residual bottleneck / decoder, tanh RGB (the background
    stream). ``model`` is one flat Sequential, as in the reference."""

    def __init__(self, c_dim: int, conv_dim: int = 64, repeat_num: int = 6,
                 k_size: int = 3, n_down: int = 3):
        super().__init__()
        d = conv_dim
        layers = list(conv_in_relu(c_dim, d, 7, 1, 3))
        for _ in range(n_down):
            layers += list(conv_in_relu(d, d * 2, k_size, 2, 1))
            d *= 2
        layers += [ResidualBlock(d) for _ in range(repeat_num)]
        for _ in range(n_down):
            layers += list(deconv_in_relu(d, d // 2, k_size))
            d //= 2
        layers += [conv(d, 3, 7, 1, 3), nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)


class ResUnetGenerator(nn.Module):
    """U-net with a residual bottleneck; heads: tanh RGB and sigmoid
    attention mask (``attetion_reg`` keeps the reference's spelling)."""

    def __init__(self, c_dim: int, conv_dim: int = 64, repeat_num: int = 6,
                 k_size: int = 3, n_down: int = 3):
        super().__init__()
        self.n_down = n_down
        d = conv_dim
        encoders = [conv_in_relu(c_dim, d, 7, 1, 3)]
        for _ in range(n_down):
            encoders.append(conv_in_relu(d, d * 2, k_size, 2, 1))
            d *= 2
        self.encoders = nn.ModuleList(encoders)
        self.resnets = nn.ModuleList(ResidualBlock(d)
                                     for _ in range(repeat_num))
        decoders, skippers = [], []
        for _ in range(n_down):
            decoders.append(deconv_in_relu(d, d // 2, k_size))
            # skip merge over [skip, up]
            skippers.append(conv_in_relu(d, d // 2, k_size, 1, 1))
            d //= 2
        self.decoders = nn.ModuleList(decoders)
        self.skippers = nn.ModuleList(skippers)
        self.img_reg = nn.Sequential(conv(d, 3, 7, 1, 3), nn.Tanh())
        self.attetion_reg = nn.Sequential(conv(d, 1, 7, 1, 3), nn.Sigmoid())

    def encode(self, x) -> list:
        outs = [self.encoders[0](x)]
        for enc in self.encoders[1:]:
            outs.append(enc(outs[-1]))
        return outs

    def run_resnets(self, x) -> list:
        outs = []
        for block in self.resnets:
            x = block(x)
            outs.append(x)
        return outs

    def decode(self, x, encoder_outs):
        for i, (dec, skip_conv) in enumerate(zip(self.decoders,
                                                 self.skippers)):
            x = dec(x)
            x = skip_conv(torch.cat([encoder_outs[self.n_down - 1 - i], x],
                                    dim=1))
        return x

    def regress(self, x):
        """Both heads as one 7×7 conv over the concatenated kernels: one
        read of the full-resolution features instead of two."""
        k = torch.cat([self.img_reg[0].weight, self.attetion_reg[0].weight])
        out = F.conv2d(x, k, padding=3)
        return torch.tanh(out[:, :3]), torch.sigmoid(out[:, 3:])

    def forward(self, x):
        """The plain U-net: (tanh RGB, sigmoid mask)."""
        enc = self.encode(x)
        h = enc[-1]
        for block in self.resnets:
            h = block(h)
        return self.regress(self.decode(h, enc))

    def inference(self, x):
        """Source-feature cache: every encoder stage and every residual
        block output."""
        enc = self.encode(x)
        return enc, self.run_resnets(enc[-1])


class ImpersonatorGenerator(nn.Module):
    """Three-stream LWB generator."""

    def __init__(self, bg_dim: int = 4, src_dim: int = 6, tsf_dim: int = 6,
                 conv_dim: int = 64, repeat_num: int = 6, n_down: int = 3):
        super().__init__()
        if repeat_num < 1:
            raise ValueError("ImpersonatorGenerator needs repeat_num >= 1")
        self.repeat_num = repeat_num
        self.n_down = n_down
        self.bg_model = ResNetGenerator(bg_dim, conv_dim, repeat_num, 3,
                                        n_down)
        self.src_model = ResUnetGenerator(src_dim, conv_dim, repeat_num, 3,
                                          n_down)
        self.tsf_model = ResUnetGenerator(tsf_dim, conv_dim, repeat_num, 3,
                                          n_down)

    def forward(self, bg_inputs, src_inputs, tsf_inputs, t):
        """Training forward, inputs NCHW, t (B, H, W, 2) ->
        (img_bg, src_img, src_mask, tsf_img, tsf_mask)."""
        img_bg = self.bg_model(bg_inputs)
        return (img_bg, *self.infer_front(src_inputs, tsf_inputs, t))

    def run_bg(self, bg_inputs):
        return self.bg_model(bg_inputs)

    def encode_src(self, src_inputs):
        return self.src_model.inference(src_inputs)

    def _lwb_decode(self, tsf_inputs, sources):
        """The tsf stream with the Liquid Warping Block: after every
        encoder stage past the first and every residual block, add each
        source's features warped by its flow, in the order given (bf16
        rounding depends on it). sources: [(encoder outs, resnet outs,
        t (N, H, W, 2))], the features of batch 1 or N."""
        tsf = self.tsf_model
        x = tsf.encoders[0](tsf_inputs)
        enc = [x]
        for i in range(1, self.n_down + 1):
            x = tsf.encoders[i](x)
            for src_enc, _, t in sources:
                x = x + warp(src_enc[i], t)
            enc.append(x)
        # a source's residual-block warps share one resized flow: warp its
        # block outputs once, channel-concatenated
        d = x.shape[1]
        warped = [grid_sample_nchw(torch.cat(res, dim=1),
                                   resize_flow(t, x.shape[2], x.shape[3]))
                  for _, res, t in sources]
        for i in range(self.repeat_num):
            x = tsf.resnets[i](x)
            for w in warped:
                x = x + w[:, i * d:(i + 1) * d]
        return tsf.regress(tsf.decode(x, enc))

    def inference(self, src_encoder_outs, src_resnet_outs, tsf_inputs, t):
        """Per-frame decode against the cached (batch-1) source features.
        tsf_inputs (N, C, H, W); t (N, H, W, 2)."""
        return self._lwb_decode(tsf_inputs,
                                [(src_encoder_outs, src_resnet_outs, t)])

    def infer_front(self, src_inputs, tsf_inputs, t):
        """Both streams live: the source is encoded and decoded in the same
        pass -> (src_img, src_mask, tsf_img, tsf_mask)."""
        src = self.src_model
        src_enc, src_res = src.inference(src_inputs)
        tsf_img, tsf_mask = self._lwb_decode(tsf_inputs,
                                             [(src_enc, src_res, t)])
        src_img, src_mask = src.regress(src.decode(src_res[-1], src_enc))
        return src_img, src_mask, tsf_img, tsf_mask

    def swap(self, tsf_inputs, src_encoder_outs12, src_encoder_outs21,
             src_resnet_outs12, src_resnet_outs21, t12, t21):
        """Dual-source decode for appearance transfer: the "12" features
        warped by t12, then the "21" features by t21, added at every
        stage. (The swapper passes the target's features as "12" with its
        T21 and the source's as "21" with its T11.)"""
        return self._lwb_decode(
            tsf_inputs, [(src_encoder_outs12, src_resnet_outs12, t12),
                         (src_encoder_outs21, src_resnet_outs21, t21)])
