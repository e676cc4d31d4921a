"""DeepFill-v2 background inpaintor (torch port of
``impersonator_tpu/models/inpaintor.py:23-170``), NCHW.

A coarse network of gated convolutions, then a refine network with one
spatial self-attention block at a quarter of the resolution (4,096 ×
4,096 scores per image at 256²). Module names reproduce the reference
state-dict keys (``coarse_net.{i}.conv2d`` / ``.mask_conv2d`` /
``.batch_norm2d``, one more ``.conv2d`` inside the upsampling layers,
``refine_attn.query_conv``, ...), which
``tools/convert_weights.convert_bgnet`` reads. The network is a frozen
preprocessor, as HMR is: BatchNorm runs on its running statistics (eps
1e-5, as the JAX package's ``layers.BatchNorm``) and everything runs in
full float32 (``utils.precision.full_fp32``), outside the generator's
bf16 policy.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from impersonator_tpu_torch.utils.precision import full_fp32


def _get_pad(size, ksize, stride, atrous=1):
    out = math.ceil(float(size) / stride)
    return int(((out - 1) * stride + atrous * (ksize - 1) + 1 - size) / 2)


class GatedConv(nn.Module):
    """act(conv(x)) * sigmoid(mask_conv(x)), then BatchNorm; act is
    LeakyReLU(0.2), or the identity without ``activation``."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1,
                 activation: bool = True):
        super().__init__()
        self.activation = activation
        self.conv2d = nn.Conv2d(cin, cout, kernel, stride, padding,
                                dilation)
        self.mask_conv2d = nn.Conv2d(cin, cout, kernel, stride, padding,
                                     dilation)
        self.batch_norm2d = nn.BatchNorm2d(cout)

    def forward(self, x):
        h = self.conv2d(x)
        if self.activation:
            h = F.leaky_relu(h, 0.2)
        return self.batch_norm2d(h * torch.sigmoid(self.mask_conv2d(x)))


class GatedDeConv(nn.Module):
    """2× nearest upsampling, then a gated conv."""

    def __init__(self, cin: int, cout: int, kernel: int, padding: int):
        super().__init__()
        self.conv2d = GatedConv(cin, cout, kernel, 1, padding)

    def forward(self, x):
        return self.conv2d(F.interpolate(x, scale_factor=2,
                                         mode="nearest"))


class SelfAttention(nn.Module):
    """Spatial SAGAN attention: gamma · softmax(q kᵀ) v + x over the
    H·W positions, q and k of C/8 channels (no 1/sqrt(d) scale)."""

    def __init__(self, channels: int):
        super().__init__()
        self.query_conv = nn.Conv2d(channels, channels // 8, 1)
        self.key_conv = nn.Conv2d(channels, channels // 8, 1)
        self.value_conv = nn.Conv2d(channels, channels, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        b, c, h, w = x.shape
        q = self.query_conv(x).flatten(2).transpose(1, 2)      # (B, N, C/8)
        k = self.key_conv(x).flatten(2)                        # (B, C/8, N)
        v = self.value_conv(x).flatten(2).transpose(1, 2)      # (B, N, C)
        attn = torch.softmax(torch.matmul(q, k), dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, c, h, w)
        return self.gamma * out + x


def _gated(specs, cin):
    """Sequential of gated layers from (cout, kernel, stride, padding,
    dilation, activation, upsample) rows."""
    layers = []
    for cout, k, s, p, d, act, up in specs:
        layers.append(GatedDeConv(cin, cout, k, p) if up
                      else GatedConv(cin, cout, k, s, p, d, act))
        cin = cout
    return nn.Sequential(*layers)


class InpaintSANet(nn.Module):
    """Coarse -> refine gated inpainting. ``c_dim`` is the channel count
    of [masked image, mask]."""

    def __init__(self, c_dim: int = 4, cnum: int = 32):
        super().__init__()
        cn = cnum

        def g(cout, k, s, p, d=1, act=True):
            return (cout, k, s, p, d, act, False)

        def up(cout, k, p):
            return (cout, k, 1, p, 1, True, True)

        self.coarse_net = _gated([
            g(cn, 5, 1, _get_pad(256, 5, 1)),
            g(2 * cn, 4, 2, _get_pad(256, 4, 2)),
            g(2 * cn, 3, 1, _get_pad(128, 3, 1)),
            g(4 * cn, 4, 2, _get_pad(128, 4, 2)),
            g(4 * cn, 3, 1, _get_pad(64, 3, 1)),
            g(4 * cn, 3, 1, _get_pad(64, 3, 1)),
            g(4 * cn, 3, 1, _get_pad(64, 3, 1, 2), d=2),
            g(4 * cn, 3, 1, _get_pad(64, 3, 1, 4), d=4),
            g(4 * cn, 3, 1, _get_pad(64, 3, 1, 8), d=8),
            g(4 * cn, 3, 1, _get_pad(64, 3, 1, 16), d=16),
            g(4 * cn, 3, 1, _get_pad(64, 3, 1)),
            g(4 * cn, 3, 1, _get_pad(64, 3, 1)),
            up(2 * cn, 3, _get_pad(128, 3, 1)),
            g(2 * cn, 3, 1, _get_pad(128, 3, 1)),
            up(cn, 3, _get_pad(256, 3, 1)),
            g(cn // 2, 3, 1, _get_pad(256, 3, 1)),
            g(3, 3, 1, _get_pad(128, 3, 1), act=False),
        ], c_dim)
        self.refine_conv_net = _gated([
            g(cn, 5, 1, _get_pad(256, 5, 1)),
            g(cn, 4, 2, _get_pad(256, 4, 2)),
            g(2 * cn, 3, 1, _get_pad(128, 3, 1)),
            g(2 * cn, 4, 2, _get_pad(128, 4, 2)),
            g(4 * cn, 3, 1, _get_pad(64, 3, 1)),
            g(4 * cn, 3, 1, _get_pad(64, 3, 1)),
            g(4 * cn, 3, 1, _get_pad(64, 3, 1)),
            g(4 * cn, 3, 1, _get_pad(64, 3, 1, 2), d=2),
            g(4 * cn, 3, 1, _get_pad(64, 3, 1, 4), d=4),
            g(4 * cn, 3, 1, _get_pad(64, 3, 1, 8), d=8),
            g(4 * cn, 3, 1, _get_pad(64, 3, 1, 16), d=16),
        ], c_dim)
        self.refine_attn = SelfAttention(4 * cn)
        self.refine_upsample_net = _gated([
            g(4 * cn, 3, 1, _get_pad(64, 3, 1)),
            g(4 * cn, 3, 1, _get_pad(64, 3, 1)),
            up(2 * cn, 3, _get_pad(128, 3, 1)),
            g(2 * cn, 3, 1, _get_pad(128, 3, 1)),
            up(cn, 3, _get_pad(256, 3, 1)),
            g(cn // 2, 3, 1, _get_pad(256, 3, 1)),
            g(3, 3, 1, _get_pad(256, 3, 1), act=False),
        ], 4 * cn)

    def forward(self, imgs, masks, only_out: bool = False,
                only_x: bool = False):
        """imgs (B, 3, H, W) in [-1, 1], masks (B, 1, H, W) with 1 where
        to synthesise -> (coarse, x, composite), or only the composite
        (``only_out``) or the refined output x (``only_x``), all clipped
        to [-1, 1]."""
        with full_fp32():
            masked = imgs * (1 - masks) + masks
            coarse = self.coarse_net(torch.cat([masked, masks], dim=1))
            coarse = coarse.clamp(-1.0, 1.0)
            masked = imgs * (1 - masks) + coarse * masks
            x = self.refine_conv_net(torch.cat([masked, masks], dim=1))
            x = self.refine_upsample_net(self.refine_attn(x))
            x = x.clamp(-1.0, 1.0)
        comp = x * masks + imgs * (1 - masks)
        if only_out:
            return comp
        if only_x:
            return x
        return coarse, x, comp


@torch.no_grad()
def init_inpaintor(net: InpaintSANet, generator: torch.Generator,
                   feature_gain: float = 1.0):
    """Seeded random weights with the JAX package's init distributions:
    gated convs He-normal, the attention's 1×1 convs LeCun-normal, biases
    0, gamma 0 (the attention starts as the identity), BatchNorm
    identity (weight 1, bias 0, running mean 0, variance 1).
    ``feature_gain`` multiplies the feature convs' (not the gates')
    weights."""
    attn = set(net.refine_attn.modules())
    for m in net.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            std = np.sqrt((1.0 if m in attn else 2.0) / fan_in)
            m.weight.normal_(0.0, float(std), generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    for m in net.modules():
        if isinstance(m, GatedConv):
            m.conv2d.weight.mul_(feature_gain)
    net.refine_attn.gamma.zero_()
