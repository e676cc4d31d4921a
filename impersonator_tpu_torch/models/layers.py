"""Generator building blocks (torch port of
``impersonator_tpu/models/layers.py:104-160, 239-283``), NCHW.

Sequential indices reproduce the reference checkpoints' state-dict keys
(``.0`` conv, ``.1`` norm, ``main.{0,1,3,4}`` in residual blocks), which
``tools/convert_weights.convert_generator`` reads. The phase form of the
narrow 7×7 heads (``narrow_head_conv`` :31-72) is not ported: it only
fills the TPU matrix unit's lanes; the heads are direct convs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class InstanceNorm(nn.Module):
    """nn.InstanceNorm2d(affine=True), eps 1e-5, whose statistics are
    always taken in float32 (safe under a bf16 compute dtype); the
    output returns in the input dtype."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        y = F.instance_norm(x.float(), weight=self.weight.float(),
                            bias=self.bias.float(), eps=self.eps)
        return y.to(x.dtype)


class BatchNormEval(nn.Module):
    """BatchNorm2d in eval semantics only: ``(x - mean) · rsqrt(var + eps)
    · weight + bias`` over the running statistics, each cast to x's dtype
    (the JAX package's order of operations)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        def c(v):
            return v.to(x.dtype)[:, None, None]
        y = (x - c(self.running_mean)) * torch.rsqrt(c(self.running_var)
                                                     + self.eps)
        return y * c(self.weight) + c(self.bias)


def conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0):
    return nn.Conv2d(cin, cout, k, stride, padding, bias=False)


def conv_in_relu(cin: int, cout: int, k: int, stride: int, padding: int):
    """Conv -> InstanceNorm -> ReLU, the encoder unit."""
    return nn.Sequential(conv(cin, cout, k, stride, padding),
                         InstanceNorm(cout), nn.ReLU())


def deconv_in_relu(cin: int, cout: int, k: int):
    """ConvTranspose2d(k, stride 2, padding 1, output_padding 1) -> IN ->
    ReLU, the decoder unit (exact 2x upsampling)."""
    return nn.Sequential(
        nn.ConvTranspose2d(cin, cout, k, 2, 1, output_padding=1, bias=False),
        InstanceNorm(cout), nn.ReLU())


class ResidualBlock(nn.Module):
    """x + IN(conv3x3(relu(IN(conv3x3(x)))))."""

    def __init__(self, channels: int):
        super().__init__()
        self.main = nn.Sequential(
            conv(channels, channels, 3, 1, 1), InstanceNorm(channels),
            nn.ReLU(), conv(channels, channels, 3, 1, 1),
            InstanceNorm(channels))

    def forward(self, x):
        return x + self.main(x)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator):
    """Conv weights N(0, 0.02) and conv biases 0, norms weight 1 / bias 0
    (the JAX package's and the reference's init, for the generator and the
    discriminator)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.weight.normal_(0.0, 0.02, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (InstanceNorm, BatchNormEval)):
            m.weight.fill_(1.0)
            m.bias.zero_()
