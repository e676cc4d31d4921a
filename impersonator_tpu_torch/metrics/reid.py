"""Person re-id encoders for OS-CS-reid / OS-freid and PCB-CS-reid /
PCB-freid (torch port of ``impersonator_tpu/metrics/reid.py``), NCHW.

* :class:`OSNet`: ``osnet_ibn_x1_0``, the variant the reference evaluator
  loads: omni-scale blocks whose four Lite-3×3 streams share one
  :class:`ChannelGate`, instance norm in the stem and the stage-2 blocks,
  Conv1×1 + AvgPool2 transitions after stages 2 and 3, and a 512-d
  Linear + BatchNorm1d + ReLU embedding head (its eval-mode output);
* :class:`PCBReid`: PCB_test, a torchvision ResNet-50 (``self.model``)
  with layer4's stride 1, pooled into six horizontal parts;
  :func:`pcb_embed` normalises and flattens them.

State-dict keys are the reference's (``conv2.0.conv2b.1.conv1.weight``,
``conv2.2.0.conv.weight``, ``fc.0.weight``; ``model.layer1.0.conv1``),
which ``tools/convert_weights.py``'s ``convert_osnet`` and
``convert_pcb`` read. BatchNorm runs on its running statistics.

The embed functions take frames (N, H, W, 3) in [-1, 1], resize them to
the net's patch with align_corners=True, ImageNet-normalise and embed in
float32 without TF32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from impersonator_tpu_torch.models.layers import InstanceNorm
from impersonator_tpu_torch.utils.precision import full_fp32

OSNET_CHANNELS = (64, 256, 384, 512)


class ConvBNRelu(nn.Module):
    """ConvLayer / Conv1x1 / Conv1x1Linear: conv (no bias) + BatchNorm, or
    an affine instance norm with ``use_in`` (the IBN stem), + ReLU unless
    ``relu`` is False."""

    def __init__(self, cin: int, cout: int, kernel: int = 1,
                 stride: int = 1, padding: int = 0, use_in: bool = False,
                 relu: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding,
                              bias=False)
        self.bn = InstanceNorm(cout) if use_in else nn.BatchNorm2d(cout)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class LightConv3x3(nn.Module):
    """1×1 (linear) + depthwise 3×3 + BatchNorm + ReLU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 1, bias=False)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, groups=cout,
                               bias=False)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv2(self.conv1(x))))


class ChannelGate(nn.Module):
    """Squeeze-excite gate with a sigmoid (reduction 16)."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // reduction, 1)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1)

    def forward(self, x):
        g = x.mean((2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(g))))


class OSBlock(nn.Module):
    """Omni-scale block: streams of 1, 2, 3 and 4 Lite convs, one shared
    gate, 1×1 bottlenecks, a residual (projected when the width
    changes), an instance norm with ``use_in``."""

    def __init__(self, cin: int, cout: int, use_in: bool = False,
                 reduction: int = 4):
        super().__init__()
        mid = cout // reduction
        self.conv1 = ConvBNRelu(cin, mid)
        self.conv2a = LightConv3x3(mid, mid)
        for name, depth in (("b", 2), ("c", 3), ("d", 4)):
            setattr(self, f"conv2{name}", nn.Sequential(
                *(LightConv3x3(mid, mid) for _ in range(depth))))
        self.gate = ChannelGate(mid)
        self.conv3 = ConvBNRelu(mid, cout, relu=False)
        self.downsample = (ConvBNRelu(cin, cout, relu=False)
                           if cin != cout else None)
        self.IN = InstanceNorm(cout) if use_in else None

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = 0.0
        for name in "abcd":
            x2 = x2 + self.gate(getattr(self, f"conv2{name}")(x1))
        residual = x if self.downsample is None else self.downsample(x)
        out = self.conv3(x2) + residual
        if self.IN is not None:
            out = self.IN(out)
        return F.relu(out)


class OSNet(nn.Module):
    """osnet_ibn_x1_0: (B, 3, 256, 128) ImageNet-normalised patches ->
    (B, 512) eval-mode embeddings."""

    def __init__(self, channels=OSNET_CHANNELS, feature_dim: int = 512):
        super().__init__()
        c = channels
        self.conv1 = ConvBNRelu(3, c[0], 7, 2, 3, use_in=True)
        self.conv2 = nn.Sequential(
            OSBlock(c[0], c[1], use_in=True), OSBlock(c[1], c[1], use_in=True),
            nn.Sequential(ConvBNRelu(c[1], c[1]), nn.AvgPool2d(2, 2)))
        self.conv3 = nn.Sequential(
            OSBlock(c[1], c[2]), OSBlock(c[2], c[2]),
            nn.Sequential(ConvBNRelu(c[2], c[2]), nn.AvgPool2d(2, 2)))
        self.conv4 = nn.Sequential(OSBlock(c[2], c[3]), OSBlock(c[3], c[3]))
        self.conv5 = ConvBNRelu(c[3], c[3])
        self.fc = nn.Sequential(nn.Linear(c[3], feature_dim),
                                nn.BatchNorm1d(feature_dim), nn.ReLU())

    def forward(self, x):
        x = F.max_pool2d(self.conv1(x), 3, 2, padding=1)
        x = self.conv5(self.conv4(self.conv3(self.conv2(x))))
        return self.fc(x.mean((2, 3)))


# ImageNet normalisation of the reference's re-id encoders
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _patch(imgs, h: int, w: int) -> torch.Tensor:
    """[-1, 1] NHWC frames -> ImageNet-normalised NCHW (h, w) patches
    (align_corners=True resize)."""
    from impersonator_tpu_torch.ops.sampler import resize_bilinear_align
    x = resize_bilinear_align(torch.as_tensor(imgs, dtype=torch.float32),
                              h, w)
    x01 = (x + 1.0) * 0.5
    mean = x01.new_tensor(_IMAGENET_MEAN)
    std = x01.new_tensor(_IMAGENET_STD)
    return ((x01 - mean) / std).permute(0, 3, 1, 2)


def osnet_reid_embed_fn(model: OSNet):
    """Frame-level re-id embedding for OS-CS-reid / OS-freid: (N, H, W, 3)
    in [-1, 1] -> (N, 512) on the frames' device."""

    def fn(imgs):
        with torch.no_grad(), full_fp32():
            return model(_patch(imgs, 256, 128))

    return fn


# --------------------------------------------------------------------------
# PCB (part-based ResNet-50)
# --------------------------------------------------------------------------


class ResBottleneck(nn.Module):
    """torchvision Bottleneck (stride on conv2), BatchNorm eval."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = (nn.Sequential(
            nn.Conv2d(cin, planes * 4, 1, stride, bias=False),
            nn.BatchNorm2d(planes * 4)) if downsample else None)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(h + residual)


class _ResNet50(nn.Module):
    """torchvision resnet50's trunk (no avgpool / fc), layer4 stride 1."""

    def __init__(self, layers=(3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                  layers), start=1):
            stride = 1 if li in (1, 4) else 2
            mods = []
            for b in range(blocks):
                s = stride if b == 0 else 1
                down = b == 0 and (s != 1 or inplanes != planes * 4)
                mods.append(ResBottleneck(inplanes, planes, s, down))
                inplanes = planes * 4
            setattr(self, f"layer{li}", nn.Sequential(*mods))

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, padding=1)
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
        return x


class PCBReid(nn.Module):
    """PCB_test: (B, 3, 384, 192) ImageNet-normalised -> (B, 6, 2048) raw
    part features (each the mean of one horizontal band)."""

    def __init__(self, parts: int = 6):
        super().__init__()
        self.parts = parts
        self.model = _ResNet50()

    def forward(self, x):
        x = self.model(x)
        b, c, h, w = x.shape
        assert h % self.parts == 0, (h, self.parts)
        x = x.reshape(b, c, self.parts, h // self.parts, w).mean((3, 4))
        return x.transpose(1, 2)


def pcb_embed(parts: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """(B, 6, 2048) -> (B, 12288): each part L2-normalised and scaled by
    1/sqrt(6), flattened in torch's (C, parts) order."""
    n = torch.sqrt(torch.sum(parts * parts, dim=-1, keepdim=True))
    normed = parts / (n * math.sqrt(float(parts.shape[1])) + eps)
    return normed.transpose(1, 2).reshape(parts.shape[0], -1)


def pcb_reid_embed_fn(model: PCBReid):
    """Frame-level PCB embedding: (N, H, W, 3) in [-1, 1] -> (N, 12288)."""

    def fn(imgs):
        with torch.no_grad(), full_fp32():
            return pcb_embed(model(_patch(imgs, 384, 192)))

    return fn
