"""Metric model zoo (torch port of ``impersonator_tpu/metrics/zoo.py``),
NCHW ``nn.Module``\\ s in eval semantics:

* :class:`AlexFeatures`, :class:`VGG16Features`, :class:`SqueezeFeatures`:
  torchvision's ``alexnet`` / ``vgg16`` / ``squeezenet1_1`` ``features``
  (the same ``features.{i}`` indices) returning the LPIPS slice outputs;
* :class:`LPIPS`: PNetLin v0.1 (input scaling, a backbone, unit-normalised
  squared feature differences, the per-channel 1×1 lin heads
  ``lin{i}.model.1``, spatial mean, sum over slices);
* :class:`InceptionV3`: torchvision ``inception_v3`` without its aux head,
  returning (pool3 (B, 2048), logits (B, 1000)) for FID and IS;
* :class:`InceptionResnetV1`: facenet-pytorch's face embedder (512-d,
  ``last_bn`` output, normalize=False), the reference's face-CS / FD net.

State-dict keys are the torchvision / reference names that
``tools/convert_weights.py`` reads (``convert_alexnet``,
``convert_vgg16_features``, ``convert_squeeze_features``,
``convert_lpips``, ``convert_inception``, ``convert_facenet_ir``), so a
released ``.pth`` loads into the port as it is, and
``utils.convert`` maps the JAX package's trees onto them. BatchNorm runs
on its running statistics (``eval()``). Callers run the nets in float32
without TF32 (``utils.precision.full_fp32``; the embed functions of
``metrics.unpaired`` do).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# --------------------------------------------------------------------------
# LPIPS backbones
# --------------------------------------------------------------------------

LPIPS_CHNS = (64, 192, 384, 256, 256)
VGG16_CHNS = (64, 128, 256, 512, 512)
SQUEEZE_CHNS = (64, 128, 256, 384, 384, 512, 512)

# PNetLin's input scaling of [-1, 1] images (networks_basic.py:102-103)
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


class _Slices(nn.Module):
    """``features`` as torchvision builds it; ``forward`` returns the
    outputs of the layers at ``taps`` (the LPIPS slice ends)."""

    taps: tuple = ()

    def forward(self, x) -> list:
        feats = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.taps:
                feats.append(x)
        return feats


class AlexFeatures(_Slices):
    """torchvision ``alexnet.features`` up to relu5; the five LPIPS
    slices end after each conv's ReLU."""

    taps = (1, 4, 7, 9, 11)

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, 1, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, 1, 1), nn.ReLU())


# torchvision vgg16 ``features`` config; LPIPS slices end after relu
# 1_2, 2_2, 3_3, 4_3, 5_3 (features idx 3, 8, 15, 22, 29)
_VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512,
              512, "M", 512, 512, 512)


class VGG16Features(_Slices):
    """torchvision ``vgg16.features`` split into the five LPIPS slices."""

    taps = (3, 8, 15, 22, 29)

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for v in _VGG16_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, 1, 1), nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*layers)


class Fire(nn.Module):
    """torchvision squeezenet Fire: 1×1 squeeze -> ReLU -> 1×1 and 3×3
    expands -> ReLU -> channel concat."""

    def __init__(self, cin: int, squeeze: int, expand: int):
        super().__init__()
        self.squeeze = nn.Conv2d(cin, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand, 3, padding=1)

    def forward(self, x):
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(s)),
                          F.relu(self.expand3x3(s))], 1)


class SqueezeFeatures(_Slices):
    """torchvision ``squeezenet1_1.features`` split into the seven LPIPS
    slices ([0:2) [2:5) [5:8) [8:10) [10:11) [11:12) [12:13)); 3×3/2
    ceil-mode pools at idx 2, 5 and 8."""

    taps = (1, 4, 7, 9, 10, 11, 12)

    def __init__(self):
        super().__init__()

        def pool():
            return nn.MaxPool2d(3, 2, ceil_mode=True)

        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 3, 2), nn.ReLU(), pool(),
            Fire(64, 16, 64), Fire(128, 16, 64), pool(),
            Fire(128, 32, 128), Fire(256, 32, 128), pool(),
            Fire(256, 48, 192), Fire(384, 48, 192), Fire(384, 64, 256),
            Fire(512, 64, 256))


_LPIPS_NETS = {
    "alex": (AlexFeatures, LPIPS_CHNS),
    "vgg": (VGG16Features, VGG16_CHNS),
    "squeeze": (SqueezeFeatures, SQUEEZE_CHNS),
}


class NetLinLayer(nn.Module):
    """LPIPS lin head: dropout (inactive in eval) + a 1×1 conv to one
    channel without bias (``lin{i}.model.1.weight``, (1, C, 1, 1))."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(),
                                   nn.Conv2d(channels, 1, 1, bias=False))
        nn.init.constant_(self.model[1].weight, 1.0 / channels)

    def forward(self, x):
        return self.model(x)


class LPIPS(nn.Module):
    """net-lin LPIPS distance (PNetLin.forward, v0.1 semantics) over the
    ``net`` backbone (alex, the reference evaluator's; vgg; squeeze),
    held as ``self.net``; the lin heads are ``lin0`` … ``lin{n-1}``.
    ``forward(a, b)``: (B, 3, H, W) in [-1, 1] -> (B,) distances."""

    def __init__(self, net: str = "alex"):
        super().__init__()
        backbone_cls, chns = _LPIPS_NETS[net]
        self.net_name = net
        self.net = backbone_cls()
        for i, c in enumerate(chns):
            setattr(self, f"lin{i}", NetLinLayer(c))
        self.n_lin = len(chns)
        self.register_buffer("shift", torch.tensor(_LPIPS_SHIFT)
                             .view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_LPIPS_SCALE)
                             .view(1, 3, 1, 1), persistent=False)

    def forward(self, a, b):
        fa = self.net((a - self.shift) / self.scale)
        fb = self.net((b - self.shift) / self.scale)
        total = 0.0
        for i, (x, y) in enumerate(zip(fa, fb)):
            # util.normalize_tensor: x / (||x||_C + 1e-10)
            xn = x / (torch.sqrt(torch.sum(x * x, 1, keepdim=True)) + 1e-10)
            yn = y / (torch.sqrt(torch.sum(y * y, 1, keepdim=True)) + 1e-10)
            d = (xn - yn) ** 2
            total = total + getattr(self, f"lin{i}")(d).mean((1, 2, 3))
        return total


# --------------------------------------------------------------------------
# InceptionV3 (torchvision architecture, eval mode)
# --------------------------------------------------------------------------


class BasicConv2d(nn.Module):
    """conv (no bias) + BatchNorm (eps 1e-3) + ReLU, torchvision's and
    facenet-pytorch's BasicConv2d."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding,
                              bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool3(x):
    """F.avg_pool2d(3, stride 1, padding 1), count_include_pad=True
    (InceptionA / C / E branch_pool)."""
    return F.avg_pool2d(x, 3, 1, 1)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avg_pool3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(_avg_pool3(x))], 1)


class InceptionV3(nn.Module):
    """Eval-mode torchvision ``inception_v3`` (no aux head, no
    transform_input): (B, 3, 299, 299) in [-1, 1] -> (pool3 (B, 2048),
    logits (B, 1000))."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, 1000)

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a",
                     "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        pool = x.mean((2, 3))
        return pool, self.fc(pool)


# --------------------------------------------------------------------------
# InceptionResnetV1 (facenet-pytorch, vggface2, classify=False)
# --------------------------------------------------------------------------


def _branch(specs) -> nn.Sequential:
    """A Sequential of BasicConv2d (cin, cout, kernel, stride, padding)."""
    return nn.Sequential(*(BasicConv2d(*s) for s in specs))


class IRBlock35(nn.Module):
    """Block35, residual scale 0.17."""

    def __init__(self, scale: float = 0.17):
        super().__init__()
        self.scale = scale
        self.branch0 = BasicConv2d(256, 32, 1)
        self.branch1 = _branch(((256, 32, 1), (32, 32, 3, 1, 1)))
        self.branch2 = _branch(((256, 32, 1), (32, 32, 3, 1, 1),
                                (32, 32, 3, 1, 1)))
        self.conv2d = nn.Conv2d(96, 256, 1)

    def forward(self, x):
        out = torch.cat([self.branch0(x), self.branch1(x), self.branch2(x)],
                        1)
        return F.relu(self.conv2d(out) * self.scale + x)


class IRBlock17(nn.Module):
    """Block17, residual scale 0.10."""

    def __init__(self, scale: float = 0.10):
        super().__init__()
        self.scale = scale
        self.branch0 = BasicConv2d(896, 128, 1)
        self.branch1 = _branch(((896, 128, 1), (128, 128, (1, 7), 1, (0, 3)),
                                (128, 128, (7, 1), 1, (3, 0))))
        self.conv2d = nn.Conv2d(256, 896, 1)

    def forward(self, x):
        out = torch.cat([self.branch0(x), self.branch1(x)], 1)
        return F.relu(self.conv2d(out) * self.scale + x)


class IRBlock8(nn.Module):
    """Block8, residual scale 0.20; the last one has no ReLU and scale 1."""

    def __init__(self, scale: float = 0.20, no_relu: bool = False):
        super().__init__()
        self.scale = scale
        self.no_relu = no_relu
        self.branch0 = BasicConv2d(1792, 192, 1)
        self.branch1 = _branch(((1792, 192, 1),
                                (192, 192, (1, 3), 1, (0, 1)),
                                (192, 192, (3, 1), 1, (1, 0))))
        self.conv2d = nn.Conv2d(384, 1792, 1)

    def forward(self, x):
        out = torch.cat([self.branch0(x), self.branch1(x)], 1)
        out = self.conv2d(out) * self.scale + x
        return out if self.no_relu else F.relu(out)


class Mixed6a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = BasicConv2d(256, 384, 3, 2)
        self.branch1 = _branch(((256, 192, 1), (192, 192, 3, 1, 1),
                                (192, 256, 3, 2)))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x),
                          F.max_pool2d(x, 3, 2)], 1)


class Mixed7a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = _branch(((896, 256, 1), (256, 384, 3, 2)))
        self.branch1 = _branch(((896, 256, 1), (256, 256, 3, 2)))
        self.branch2 = _branch(((896, 256, 1), (256, 256, 3, 1, 1),
                                (256, 256, 3, 2)))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          F.max_pool2d(x, 3, 2)], 1)


class InceptionResnetV1(nn.Module):
    """(B, 3, 160, 160) standardised faces in [-1, 1] -> raw (B, 512)
    embeddings (``last_bn`` output, normalize=False: the evaluator's call
    convention)."""

    def __init__(self):
        super().__init__()
        self.conv2d_1a = BasicConv2d(3, 32, 3, 2)
        self.conv2d_2a = BasicConv2d(32, 32, 3)
        self.conv2d_2b = BasicConv2d(32, 64, 3, 1, 1)
        self.conv2d_3b = BasicConv2d(64, 80, 1)
        self.conv2d_4a = BasicConv2d(80, 192, 3)
        self.conv2d_4b = BasicConv2d(192, 256, 3, 2)
        self.repeat_1 = nn.Sequential(*(IRBlock35() for _ in range(5)))
        self.mixed_6a = Mixed6a()
        self.repeat_2 = nn.Sequential(*(IRBlock17() for _ in range(10)))
        self.mixed_7a = Mixed7a()
        self.repeat_3 = nn.Sequential(*(IRBlock8() for _ in range(5)))
        self.block8 = IRBlock8(scale=1.0, no_relu=True)
        self.last_linear = nn.Linear(1792, 512, bias=False)
        self.last_bn = nn.BatchNorm1d(512, eps=1e-3)

    def forward(self, x):
        x = self.conv2d_2b(self.conv2d_2a(self.conv2d_1a(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.conv2d_4b(self.conv2d_4a(self.conv2d_3b(x)))
        x = self.mixed_7a(self.repeat_2(self.mixed_6a(self.repeat_1(x))))
        x = self.block8(self.repeat_3(x))
        return self.last_bn(self.last_linear(x.mean((2, 3))))
