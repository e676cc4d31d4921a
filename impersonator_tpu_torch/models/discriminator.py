"""PatchGAN discriminator (torch port of
``impersonator_tpu/models/discriminator.py:21-63``), NCHW.

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
"""

from __future__ import annotations

from torch import nn

from impersonator_tpu_torch.models.layers import BatchNormEval, InstanceNorm


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
