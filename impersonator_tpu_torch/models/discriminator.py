"""PatchGAN discriminators (torch port of
``impersonator_tpu/models/discriminator.py``), NCHW: the PatchGAN
(:21-63), the augmented trainer's global + local pair over the body crop
(:66-119) and the multi-scale stack (:122-138).

``model`` is one flat Sequential, as the reference's
``networks/discriminator.py`` builds it: a 4×4 stride-2 conv with bias and
LeakyReLU(0.2), ``n_layers - 1`` blocks of a 4×4 stride-2 conv, a norm and
LeakyReLU, one 4×4 stride-1 block, and the 4×4 stride-1 head to one
channel; every conv pads 1. The convs of the blocks have no bias under
``norm_type == "batch"``. ``utils.convert.discriminator_state_dict_from_jax``
maps the JAX package's params onto these keys.

The JAX train step applies the discriminator without ``train``, so its
BatchNorm always normalises by the running statistics it started with;
``layers.BatchNormEval`` does the same whatever ``module.train()`` says.
``layers.init_weights`` gives it the JAX package's init.

flax infers each conv's input width; here the constructor is given it
(``input_nc``): 6 for the base trainer's [image, tsf cond], 4 and 6 for
the global [background, mask] and local [image, tsf cond] halves of the
augmented trainer's pair, 9 for the baselines' [image, src cond, tsf
cond].
"""

from __future__ import annotations

import torch
from torch import nn

from impersonator_tpu_torch.models.layers import BatchNormEval, InstanceNorm
from impersonator_tpu_torch.ops.sampler import grid_sample_nchw


def _norm(norm_type: str, channels: int) -> nn.Module:
    if norm_type == "batch":
        return BatchNormEval(channels)
    if norm_type == "instance":
        return InstanceNorm(channels)
    raise ValueError(norm_type)


class PatchDiscriminator(nn.Module):
    """n_layers PatchGAN with an LSGAN head (no sigmoid unless asked):
    (B, input_nc, S, S) -> (B, 1, S/2^n_layers - 2, ...)."""

    def __init__(self, input_nc: int = 6, ndf: int = 64, n_layers: int = 4,
                 norm_type: str = "instance", use_sigmoid: bool = False):
        super().__init__()
        use_bias = norm_type != "batch"
        layers = [nn.Conv2d(input_nc, ndf, 4, 2, 1), nn.LeakyReLU(0.2)]
        nf = ndf
        for n in range(1, n_layers + 1):
            nf_next = ndf * min(2 ** n, 8)
            stride = 2 if n < n_layers else 1
            layers += [nn.Conv2d(nf, nf_next, 4, stride, 1, bias=use_bias),
                       _norm(norm_type, nf_next), nn.LeakyReLU(0.2)]
            nf = nf_next
        layers.append(nn.Conv2d(nf, 1, 4, 1, 1))
        if use_sigmoid:
            layers.append(nn.Sigmoid())
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)


def crop_resize_bbox(imgs, bboxes, out_h: int, out_w: int):
    """Crop each image to its box and resize it bilinearly to (out_h,
    out_w), as one sample on an affine grid: imgs (B, C, H, W); bboxes
    (B, 4) float = [min_x, max_x, min_y, max_y] in pixels. The grid spans
    [min, max - 1] inclusive on each axis (the crop x[min:max] resized
    with aligned corners); a box of width 1 or less spans 0 (its first
    row or column, repeated). A half-precision image is sampled in the
    JAX package's arithmetic (ops.sampler.grid_sample_nchw); the grid is
    float32."""
    b, _, h, w = imgs.shape
    boxes = bboxes.float()

    def axis_grid(mn, mx, n_out, size):
        span = (mx - mn - 1.0).clamp(min=0.0)
        t = torch.arange(n_out, dtype=torch.float32,
                         device=imgs.device) / max(n_out - 1, 1)
        coords = mn[:, None] + t[None, :] * span[:, None]
        return coords / (size - 1) * 2.0 - 1.0

    gx = axis_grid(boxes[:, 0], boxes[:, 1], out_w, w)   # (B, out_w)
    gy = axis_grid(boxes[:, 2], boxes[:, 3], out_h, h)   # (B, out_h)
    grid = torch.stack([gx[:, None, :].expand(b, out_h, out_w),
                        gy[:, :, None].expand(b, out_h, out_w)], -1)
    return grid_sample_nchw(imgs, grid)


class GlobalLocalDiscriminator(nn.Module):
    """A global PatchGAN on ``global_x`` and a local one on ``local_x``
    cropped to ``local_rects`` (:func:`crop_resize_bbox`, resized back to
    local_x's size); the two outputs are concatenated on the batch
    axis."""

    def __init__(self, global_nc: int = 4, local_nc: int = 6, ndf: int = 64,
                 n_layers: int = 3, norm_type: str = "instance",
                 use_sigmoid: bool = False):
        super().__init__()
        self.global_model = PatchDiscriminator(global_nc, ndf, n_layers,
                                               norm_type, use_sigmoid)
        self.local_model = PatchDiscriminator(local_nc, ndf, n_layers,
                                              norm_type, use_sigmoid)

    def forward(self, global_x, local_x, local_rects):
        g = self.global_model(global_x)
        crops = crop_resize_bbox(local_x, local_rects, local_x.shape[2],
                                 local_x.shape[3])
        return torch.cat([g, self.local_model(crops)], 0)


class MultiScaleDiscriminator(nn.Module):
    """One PatchGAN (instance norm) per scale; ``xs`` holds one input per
    scale, each with ``input_nc`` channels."""

    def __init__(self, input_nc: int = 6, n_scales: int = 5, ndf: int = 64,
                 n_layers: int = 3, use_sigmoid: bool = False):
        super().__init__()
        self.scale_models = nn.ModuleList(
            PatchDiscriminator(input_nc, ndf, n_layers,
                               use_sigmoid=use_sigmoid)
            for _ in range(n_scales))

    def forward(self, xs):
        return [m(x) for m, x in zip(self.scale_models, xs)]
