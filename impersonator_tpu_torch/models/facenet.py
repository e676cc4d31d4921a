"""Face-identity networks (torch port of
``impersonator_tpu/models/facenet.py:31-157``), NCHW.

* :class:`Sphere20a`, the SphereFace backbone: four stages of a strided
  conv + PReLU and residual pairs, returning the four stage features and
  the 512-d fc5 embedding (the fc6 angular head is dropped, as the
  reference's checkpoint loader drops it). Input (B, 3, 112, 96) in
  [-1, 1].
* :class:`SENet50`, VGGFace2's SE-ResNet-50: bottlenecks with the stride
  on the FIRST 1×1 conv, an inline squeeze-excite (global mean -> 1×1
  down by 16 -> ReLU -> 1×1 up -> sigmoid gate), a ceil-mode 3×3/2 stem
  pool and layers [3, 4, 6, 3]. Returns the five stage features and the
  2048-d pooled embedding. Input (B, 3, 224, 224); VGGFace2's
  preprocessing is the caller's.

Module names reproduce the reference state-dict keys (``conv1_1``,
``relu1_1`` for the PReLU slopes, ``fc5``; ``layer1.0.conv4``,
``layer1.0.downsample.0``), which ``tools/convert_weights``'
``convert_sphere`` and ``convert_senet50`` read. Both are frozen
feature extractors: BatchNorm runs on its running statistics (eps 1e-5).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class PReLU(nn.Module):
    """Per-channel PReLU over dim 1 (NCHW maps or (B, C) features), slope
    0.25 at init: ``where(x >= 0, x, a · x)`` (the key ``weight``, as
    torch's nn.PReLU)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x):
        a = self.weight.reshape(-1, *([1] * (x.ndim - 2)))
        return torch.where(x >= 0, x, a * x)


# (stage conv, [(first, second) conv of each residual pair]) of Sphere20a
_SPHERE_STAGES = (
    (1, 64, [(2, 3)]),
    (2, 128, [(2, 3), (4, 5)]),
    (3, 256, [(2, 3), (4, 5), (6, 7), (8, 9)]),
    (4, 512, [(2, 3)]),
)


class Sphere20a(nn.Module):
    """SphereFace-20a: ``forward`` returns [stage1, stage2, stage3, stage4,
    fc5] features."""

    def __init__(self):
        super().__init__()
        cin = 3
        for stage, width, pairs in _SPHERE_STAGES:
            self._unit(f"{stage}_1", cin, width, 2)
            for a, b in pairs:
                self._unit(f"{stage}_{a}", width, width, 1)
                self._unit(f"{stage}_{b}", width, width, 1)
            cin = width
        self.fc5 = nn.Linear(512 * 7 * 6, 512)

    def _unit(self, name, cin, cout, stride):
        setattr(self, f"conv{name}", nn.Conv2d(cin, cout, 3, stride, 1))
        setattr(self, f"relu{name}", PReLU(cout))

    def _run(self, name, x):
        return getattr(self, f"relu{name}")(getattr(self, f"conv{name}")(x))

    def forward(self, x):
        feats = []
        for stage, _, pairs in _SPHERE_STAGES:
            x = self._run(f"{stage}_1", x)
            for a, b in pairs:
                x = x + self._run(f"{stage}_{b}",
                                  self._run(f"{stage}_{a}", x))
            feats.append(x)
        feats.append(self.fc5(x.flatten(1)))
        return feats


class SEBottleneck(nn.Module):
    """1×1 (stride) / 3×3 / 1×1 bottleneck, expansion 4, with the
    squeeze-excite gate of conv4 / conv5 (compress rate 16)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, stride, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.conv4 = nn.Conv2d(planes * 4, planes * 4 // 16, 1)
        self.conv5 = nn.Conv2d(planes * 4 // 16, planes * 4, 1)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
            nn.BatchNorm2d(planes * 4)) if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        se = out.mean((2, 3), keepdim=True)
        se = torch.sigmoid(self.conv5(F.relu(self.conv4(se))))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(se * out + residual)


class SENet50(nn.Module):
    """VGGFace2 SE-ResNet-50 without its classifier: ``forward`` returns
    ([x0, layer1, layer2, layer3, layer4] features, (B, 2048) embed)."""

    def __init__(self, layers=(3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                  layers), start=1):
            stride = 1 if li == 1 else 2
            mods = []
            for b in range(blocks):
                s = stride if b == 0 else 1
                down = b == 0 and (s != 1 or inplanes != planes * 4)
                mods.append(SEBottleneck(inplanes, planes, s, down))
                inplanes = planes * 4
            setattr(self, f"layer{li}", nn.Sequential(*mods))

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        feats = [x]
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
            feats.append(x)
        return feats, x.mean((2, 3))


@torch.no_grad()
def init_facenet(net: nn.Module, generator: torch.Generator):
    """Seeded random weights with flax's default distributions, as the
    JAX package's face nets start: conv and dense weights N(0, 1/fan_in),
    biases 0, PReLU slopes 0.25, BatchNorm identity."""
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            std = float(np.sqrt(1.0 / m.weight[0].numel()))
            m.weight.normal_(0.0, std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, PReLU):
            m.weight.fill_(0.25)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return net
