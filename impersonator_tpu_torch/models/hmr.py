"""HMR: SMPL θ regression from a 224² crop (torch port of
``impersonator_tpu/models/hmr.py:33-136``), NCHW inside, NHWC at the
public call.

A pre-activation ResNet-50 encoder and the iterative error feedback
(IEF) regressor of the reference's TF-ported HMR, with its quirks kept
so the released ``hmr_tf2pt.pth`` loads as it is:

* the 7×7/2 stem conv has a bias; the 3×3/2 max-pool uses ``ceil_mode``;
* bottleneck: pre-activation BN, conv3 has a bias, a 1×1 shortcut conv
  (with bias) only where the channel count changes, otherwise the
  shortcut is subsampled by a 1×1 max-pool of the block's stride;
* the stride sits on the LAST block of each layer; layer4 has stride 1;
* a trailing BN + ReLU + 7×7 average pool;
* θ ← θ + MLP([feat, θ]) three times, from ``mean_theta``.

Module names reproduce the reference state-dict keys
(``resnet.layer1.0.bn1``, ``resnet.layer1.0.shortcut.0``,
``regressor.fc_blocks.fc1``, ``regressor.mean_theta``), which
``tools/convert_weights.convert_hmr`` reads. The network is a frozen
preprocessor: it runs in eval mode (BatchNorm on its running statistics,
eps 1e-5) and in full float32 (no TF32), outside the generator's bf16
policy.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from impersonator_tpu_torch.utils.precision import full_fp32


class PreActBottleneck(nn.Module):
    """Pre-activation bottleneck, expansion 4, stride on conv2."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.bn1 = nn.BatchNorm2d(in_planes)
        self.conv1 = nn.Conv2d(in_planes, planes, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=True)
        if in_planes != planes * 4:
            self.shortcut = nn.Sequential(
                nn.Conv2d(in_planes, planes * 4, 1, stride, bias=True))
        else:
            self.shortcut = None

    def forward(self, x):
        preact = F.relu(self.bn1(x))
        if self.shortcut is not None:
            shortcut = self.shortcut(preact)
        elif self.stride > 1:
            shortcut = F.max_pool2d(x, 1, self.stride)
        else:
            shortcut = x
        h = self.conv1(preact)
        h = self.conv2(F.relu(self.bn2(h)))
        h = self.conv3(F.relu(self.bn3(h)))
        return h + shortcut


class PreActResNet50(nn.Module):
    """Stem, four layers of [3, 4, 6, 3] bottlenecks, post BN, 7×7 average
    pool -> (B, 2048) features."""

    def __init__(self, num_blocks=(3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=True)
        in_planes = 64
        for li, (planes, nb, stride) in enumerate(
                zip((64, 128, 256, 512), num_blocks, (2, 2, 2, 1)), start=1):
            blocks = []
            for bi in range(nb):
                s = stride if (bi == nb - 1 and bi > 0) else 1
                blocks.append(PreActBottleneck(in_planes, planes, s))
                in_planes = planes * 4
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
        self.post_bn = nn.BatchNorm2d(in_planes)

    def forward(self, x):
        x = F.max_pool2d(self.conv1(x), 3, 2, ceil_mode=True)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = F.avg_pool2d(F.relu(self.post_bn(x)), 7)
        return x.flatten(1)


class ThetaRegressor(nn.Module):
    """IEF: θ ← θ + fc3(relu(fc2(relu(fc1([feat, θ]))))), ``iterations``
    times from ``mean_theta``. (The reference's dropout layers are inert
    in eval mode and are left out.)"""

    def __init__(self, feat_dim: int = 2048, out_dim: int = 85,
                 iterations: int = 3):
        super().__init__()
        self.iterations = iterations
        self.fc_blocks = nn.Sequential(OrderedDict([
            ("fc1", nn.Linear(feat_dim + out_dim, 1024)),
            ("relu1", nn.ReLU()),
            ("fc2", nn.Linear(1024, 1024)),
            ("relu2", nn.ReLU()),
            ("fc3", nn.Linear(1024, out_dim)),
        ]))
        self.register_buffer("mean_theta", torch.zeros(out_dim))

    def forward(self, feat):
        theta = self.mean_theta.expand(feat.shape[0], -1)
        for _ in range(self.iterations):
            theta = theta + self.fc_blocks(torch.cat([feat, theta], dim=1))
        return theta


class HumanModelRecovery(nn.Module):
    """Encoder + IEF. ``forward`` takes (B, 224, 224, 3) images in
    [-1, 1], NHWC as the JAX package, and returns θ (B, 85): camera (3),
    pose (72), shape (10).

    Both run in full float32 (``full_fp32``: TF32 off for their convs and
    matmuls, whatever the process's flags): θ feeds the float32 geometry,
    and TF32's 10-bit mantissa moves the features by ~1e-3 relative."""

    def __init__(self, theta_dim: int = 85, iterations: int = 3):
        super().__init__()
        self.resnet = PreActResNet50()
        self.regressor = ThetaRegressor(2048, theta_dim, iterations)

    def features(self, img):
        """(B, 224, 224, 3) images -> (B, 2048) encoder features."""
        with full_fp32():
            return self.resnet(img.permute(0, 3, 1, 2))

    def forward(self, img):
        feat = self.features(img)
        with full_fp32():
            return self.regressor(feat)


@torch.no_grad()
def init_hmr(hmr: HumanModelRecovery, generator: torch.Generator,
             mean_theta, fc3_scale: float):
    """Seeded random weights with the JAX package's init distributions
    (convs He-normal, fc1/fc2 LeCun-normal, fc3 Xavier-normal, biases 0,
    BatchNorm identity: weight 1, bias 0, running mean 0, variance 1)
    and ``mean_theta`` as the IEF start. ``fc3_scale`` multiplies fc3's
    weights."""
    for m in hmr.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_out, fan_in = m.weight.shape[0], m.weight[0].numel()
            if isinstance(m, nn.Conv2d):
                std = np.sqrt(2.0 / fan_in)
            elif m is hmr.regressor.fc_blocks.fc3:
                std = np.sqrt(2.0 / (fan_in + fan_out)) * fc3_scale
            else:
                std = np.sqrt(1.0 / fan_in)
            m.weight.normal_(0.0, float(std), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    hmr.regressor.mean_theta.copy_(
        torch.as_tensor(np.asarray(mean_theta, np.float32)))
