"""Plain PyTorch networks of the Liquid Warping GAN (Liu et al., ICCV
2019, svip-lab/impersonator): the three-stream generator with its
Liquid Warping Block, the PatchGAN discriminator, HMR (a pre-activation
ResNet-50 with the 3-iteration θ regressor of Kanazawa et al.) and the
DeepFill v2 background inpaintor (gated convolutions, Yu et al., ICCV
2019, with the released model's self-attention), NCHW, float32.

The benchmark's own reference: it imports nothing of the program. Its
parameter names are the released checkpoints' (``bg_model.model.0``,
``src_model.encoders.0.0``, ``resnet.layer1.0.bn1``, ...), so one state
dict, made by the benchmark, loads into the program's nets and these.
:func:`fp8_copy` is the control: a copy whose convolutions and warps
compute on float8 (e4m3) inputs, the precision below bfloat16."""

from __future__ import annotations

import copy
from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn


class InstanceNorm(nn.Module):
    """Affine instance norm, eps 1e-5."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=1e-5)


def conv(cin, cout, k, stride=1, padding=0, bias=False):
    return nn.Conv2d(cin, cout, k, stride, padding, bias=bias)


def conv_in_relu(cin, cout, k, stride, padding):
    return nn.Sequential(conv(cin, cout, k, stride, padding),
                         InstanceNorm(cout), nn.ReLU())


def deconv_in_relu(cin, cout, k):
    return nn.Sequential(nn.ConvTranspose2d(cin, cout, k, 2, 1,
                                            output_padding=1, bias=False),
                         InstanceNorm(cout), nn.ReLU())


class ResidualBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.main = nn.Sequential(conv(c, c, 3, 1, 1), InstanceNorm(c),
                                  nn.ReLU(), conv(c, c, 3, 1, 1),
                                  InstanceNorm(c))

    def forward(self, x):
        return x + self.main(x)


class ResNetGenerator(nn.Module):
    """The background stream: encoder, residual blocks, decoder, tanh."""

    def __init__(self, c_dim, conv_dim=64, repeat_num=6, n_down=3):
        super().__init__()
        d = conv_dim
        layers = list(conv_in_relu(c_dim, d, 7, 1, 3))
        for _ in range(n_down):
            layers += list(conv_in_relu(d, 2 * d, 3, 2, 1))
            d *= 2
        layers += [ResidualBlock(d) for _ in range(repeat_num)]
        for _ in range(n_down):
            layers += list(deconv_in_relu(d, d // 2, 3))
            d //= 2
        layers += [conv(d, 3, 7, 1, 3), nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)


class ResUnetGenerator(nn.Module):
    """The source and transfer streams: a U-net with residual blocks and
    two heads, tanh colour and sigmoid attention mask."""

    def __init__(self, c_dim, conv_dim=64, repeat_num=6, n_down=3):
        super().__init__()
        self.n_down = n_down
        d = conv_dim
        enc = [conv_in_relu(c_dim, d, 7, 1, 3)]
        for _ in range(n_down):
            enc.append(conv_in_relu(d, 2 * d, 3, 2, 1))
            d *= 2
        self.encoders = nn.ModuleList(enc)
        self.resnets = nn.ModuleList(ResidualBlock(d)
                                     for _ in range(repeat_num))
        dec, skip = [], []
        for _ in range(n_down):
            dec.append(deconv_in_relu(d, d // 2, 3))
            skip.append(conv_in_relu(d, d // 2, 3, 1, 1))
            d //= 2
        self.decoders = nn.ModuleList(dec)
        self.skippers = nn.ModuleList(skip)
        self.img_reg = nn.Sequential(conv(d, 3, 7, 1, 3), nn.Tanh())
        self.attetion_reg = nn.Sequential(conv(d, 1, 7, 1, 3), nn.Sigmoid())

    def encode(self, x):
        outs = [self.encoders[0](x)]
        for e in self.encoders[1:]:
            outs.append(e(outs[-1]))
        return outs

    def decode(self, x, enc):
        for i, (d, s) in enumerate(zip(self.decoders, self.skippers)):
            x = s(torch.cat([enc[self.n_down - 1 - i], d(x)], 1))
        return self.img_reg(x), self.attetion_reg(x)

    def inference(self, x):
        enc = self.encode(x)
        res, h = [], enc[-1]
        for block in self.resnets:
            h = block(h)
            res.append(h)
        return enc, res


class Generator(nn.Module):
    """The three streams. ``quant`` (None, or a function of a tensor) is
    applied to every warped feature map: the fp8 control's hook."""

    def __init__(self, bg_dim=4, src_dim=6, tsf_dim=6, conv_dim=64,
                 repeat_num=6, n_down=3):
        super().__init__()
        self.repeat_num, self.n_down = repeat_num, n_down
        self.bg_model = ResNetGenerator(bg_dim, conv_dim, repeat_num, n_down)
        self.src_model = ResUnetGenerator(src_dim, conv_dim, repeat_num,
                                          n_down)
        self.tsf_model = ResUnetGenerator(tsf_dim, conv_dim, repeat_num,
                                          n_down)
        self.quant = None

    def warp(self, x, t):
        """Sample x at the flow T resized (bilinear, corners aligned) to
        x's size; zero outside."""
        if t.shape[1:3] != x.shape[2:]:
            t = F.interpolate(t.permute(0, 3, 1, 2), size=x.shape[2:],
                              mode="bilinear",
                              align_corners=True).permute(0, 2, 3, 1)
        x = x.expand(t.shape[0], *x.shape[1:])
        out = F.grid_sample(x, t, mode="bilinear", padding_mode="zeros",
                            align_corners=True)
        return out if self.quant is None else self.quant(out)

    def decode(self, enc_src, res_src, tsf_inputs, t):
        """The transfer stream with the source's features warped by T
        added after every encoder stage past the first and every residual
        block -> (colour, mask)."""
        tsf = self.tsf_model
        x = tsf.encoders[0](tsf_inputs)
        enc = [x]
        for i in range(1, self.n_down + 1):
            x = tsf.encoders[i](x) + self.warp(enc_src[i], t)
            enc.append(x)
        for i in range(self.repeat_num):
            x = tsf.resnets[i](x) + self.warp(res_src[i], t)
        return tsf.decode(x, enc)

    def forward(self, bg_inputs, src_inputs, tsf_inputs, t):
        """The training forward -> (bg, src colour, src mask, tsf colour,
        tsf mask)."""
        enc, res = self.src_model.inference(src_inputs)
        tsf_color, tsf_mask = self.decode(enc, res, tsf_inputs, t)
        src_color, src_mask = self.src_model.decode(res[-1], enc)
        return (self.bg_model(bg_inputs), src_color, src_mask, tsf_color,
                tsf_mask)


class PreActBottleneck(nn.Module):
    def __init__(self, cin, planes, stride=1):
        super().__init__()
        self.stride = stride
        self.bn1 = nn.BatchNorm2d(cin)
        self.conv1 = conv(cin, planes, 1)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv2 = conv(planes, planes, 3, stride, 1)
        self.bn3 = nn.BatchNorm2d(planes)
        self.conv3 = conv(planes, 4 * planes, 1, bias=True)
        self.shortcut = (nn.Sequential(conv(cin, 4 * planes, 1, stride,
                                            bias=True))
                         if cin != 4 * planes else None)

    def forward(self, x):
        pre = F.relu(self.bn1(x))
        if self.shortcut is not None:
            sc = self.shortcut(pre)
        elif self.stride > 1:
            sc = F.max_pool2d(x, 1, self.stride)
        else:
            sc = x
        h = self.conv2(F.relu(self.bn2(self.conv1(pre))))
        return self.conv3(F.relu(self.bn3(h))) + sc


class PreActResNet50(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = conv(3, 64, 7, 2, 3, bias=True)
        cin = 64
        for li, (planes, nb, stride) in enumerate(
                zip((64, 128, 256, 512), (3, 4, 6, 3), (2, 2, 2, 1)), 1):
            blocks = []
            for bi in range(nb):
                blocks.append(PreActBottleneck(
                    cin, planes, stride if bi == nb - 1 and bi > 0 else 1))
                cin = 4 * planes
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
        self.post_bn = nn.BatchNorm2d(cin)

    def forward(self, x):
        x = F.max_pool2d(self.conv1(x), 3, 2, ceil_mode=True)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return F.avg_pool2d(F.relu(self.post_bn(x)), 7).flatten(1)


class ThetaRegressor(nn.Module):
    def __init__(self, feat=2048, out=85, iterations=3):
        super().__init__()
        self.iterations = iterations
        self.fc_blocks = nn.Sequential(OrderedDict([
            ("fc1", nn.Linear(feat + out, 1024)), ("relu1", nn.ReLU()),
            ("fc2", nn.Linear(1024, 1024)), ("relu2", nn.ReLU()),
            ("fc3", nn.Linear(1024, out))]))
        self.register_buffer("mean_theta", torch.zeros(out))

    def forward(self, feat):
        theta = self.mean_theta.expand(feat.shape[0], -1)
        for _ in range(self.iterations):
            theta = theta + self.fc_blocks(torch.cat([feat, theta], 1))
        return theta


class HMR(nn.Module):
    """(B, 224, 224, 3) images in [-1, 1], NHWC -> θ (B, 85)."""

    def __init__(self):
        super().__init__()
        self.resnet = PreActResNet50()
        self.regressor = ThetaRegressor()

    def forward(self, img):
        return self.regressor(self.resnet(img.permute(0, 3, 1, 2)))


def _same_pad(size, k, stride, dilation=1):
    """TensorFlow's "same" padding of the released DeepFill layers."""
    out = -(-size // stride)
    return ((out - 1) * stride + dilation * (k - 1) + 1 - size) // 2


class GatedConv(nn.Module):
    """BatchNorm(act(conv(x)) · sigmoid(mask_conv(x))), act LeakyReLU(0.2)
    or none; 2x nearest upsampling first with ``up``."""

    def __init__(self, cin, cout, k, stride, pad, dilation=1, act=True):
        super().__init__()
        self.act = act
        self.conv2d = nn.Conv2d(cin, cout, k, stride, pad, dilation)
        self.mask_conv2d = nn.Conv2d(cin, cout, k, stride, pad, dilation)
        self.batch_norm2d = nn.BatchNorm2d(cout)

    def forward(self, x):
        h = self.conv2d(x)
        if self.act:
            h = F.leaky_relu(h, 0.2)
        return self.batch_norm2d(h * torch.sigmoid(self.mask_conv2d(x)))


class GatedUp(nn.Module):
    def __init__(self, cin, cout, k, pad):
        super().__init__()
        self.conv2d = GatedConv(cin, cout, k, 1, pad)

    def forward(self, x):
        return self.conv2d(F.interpolate(x, scale_factor=2, mode="nearest"))


class SelfAttention(nn.Module):
    """gamma · softmax(q kᵀ) v + x over the H·W positions (no scale)."""

    def __init__(self, c):
        super().__init__()
        self.query_conv = nn.Conv2d(c, c // 8, 1)
        self.key_conv = nn.Conv2d(c, c // 8, 1)
        self.value_conv = nn.Conv2d(c, c, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        b, c, h, w = x.shape
        q = self.query_conv(x).flatten(2).transpose(1, 2)
        k = self.key_conv(x).flatten(2)
        v = self.value_conv(x).flatten(2).transpose(1, 2)
        out = torch.softmax(q @ k, -1) @ v
        return self.gamma * out.transpose(1, 2).reshape(b, c, h, w) + x


def _gated_stack(rows, cin):
    """Layers from rows (cout, k, stride, size, dilation, act, up), each
    padded "same" for its input size."""
    layers = []
    for cout, k, stride, size, dil, act, up in rows:
        pad = _same_pad(size, k, stride, dil)
        layers.append(GatedUp(cin, cout, k, pad) if up else
                      GatedConv(cin, cout, k, stride, pad, dil, act))
        cin = cout
    return nn.Sequential(*layers)


class DeepFill(nn.Module):
    """DeepFill v2 (the released ``InpaintSANet``): a coarse net of gated
    convolutions, then a refine net with self-attention at a quarter of
    the resolution; BatchNorm on its running statistics. forward(img
    (B, 3, H, W) in [-1, 1], mask (B, 1, H, W), 1 where to fill) -> the
    refined image, clipped to [-1, 1]."""

    def __init__(self, c_dim=4, cn=32):
        super().__init__()

        def g(cout, k, s, size, d=1, act=True):
            return (cout, k, s, size, d, act, False)

        def up(cout, size):
            return (cout, 3, 1, size, 1, True, True)

        dil = [g(4 * cn, 3, 1, 64, d) for d in (2, 4, 8, 16)]
        self.coarse_net = _gated_stack([
            g(cn, 5, 1, 256), g(2 * cn, 4, 2, 256), g(2 * cn, 3, 1, 128),
            g(4 * cn, 4, 2, 128), g(4 * cn, 3, 1, 64), g(4 * cn, 3, 1, 64),
            *dil, g(4 * cn, 3, 1, 64), g(4 * cn, 3, 1, 64),
            up(2 * cn, 128), g(2 * cn, 3, 1, 128), up(cn, 256),
            g(cn // 2, 3, 1, 256), g(3, 3, 1, 128, act=False)], c_dim)
        self.refine_conv_net = _gated_stack([
            g(cn, 5, 1, 256), g(cn, 4, 2, 256), g(2 * cn, 3, 1, 128),
            g(2 * cn, 4, 2, 128), g(4 * cn, 3, 1, 64), g(4 * cn, 3, 1, 64),
            g(4 * cn, 3, 1, 64), *dil], c_dim)
        self.refine_attn = SelfAttention(4 * cn)
        self.refine_upsample_net = _gated_stack([
            g(4 * cn, 3, 1, 64), g(4 * cn, 3, 1, 64), up(2 * cn, 128),
            g(2 * cn, 3, 1, 128), up(cn, 256), g(cn // 2, 3, 1, 256),
            g(3, 3, 1, 256, act=False)], 4 * cn)

    def forward(self, img, mask):
        masked = img * (1 - mask) + mask
        coarse = self.coarse_net(torch.cat([masked, mask], 1)).clamp(-1, 1)
        masked = img * (1 - mask) + coarse * mask
        x = self.refine_conv_net(torch.cat([masked, mask], 1))
        return self.refine_upsample_net(self.refine_attn(x)).clamp(-1, 1)


def fp8(t):
    """t rounded to float8 e4m3 under one scale for the whole tensor (its
    largest magnitude maps to 448), back in t's dtype."""
    scale = t.detach().abs().amax().float().clamp(min=1e-30) / 448.0
    return ((t.float() / scale).to(torch.float8_e4m3fn).float()
            * scale).to(t.dtype)


def fp8_e5m2(t):
    """t rounded to float8 e5m2 (the gradients' float8) under one scale
    for the whole tensor, back in t's dtype."""
    scale = t.detach().abs().amax().float().clamp(min=1e-30) / 57344.0
    return ((t.float() / scale).to(torch.float8_e5m2).float()
            * scale).to(t.dtype)


def fp8_copy(net: nn.Module) -> nn.Module:
    """A copy of ``net`` whose every convolution takes float8 weights and
    inputs (accumulating in float32), and, for a :class:`Generator`,
    whose warped features are rounded to float8 too."""
    net = copy.deepcopy(net)
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            with torch.no_grad():
                m.weight.copy_(fp8(m.weight))
            m.register_forward_pre_hook(lambda _, args: (fp8(args[0]),))
    if isinstance(net, Generator):
        net.quant = fp8
    return net
