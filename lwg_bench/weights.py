"""Seeded weights made on the device in a few large calls, as state
dicts that load into the program's nets and the reference's alike."""

from __future__ import annotations

import math

import torch
from torch import nn


def gan_std(name: str, shape) -> float | None:
    """The generator's and discriminator's init: conv weights N(0, 0.02),
    norm weights 1 and every bias 0 (None: a constant)."""
    return 0.02 if len(shape) == 4 else None


def hmr_std(name: str, shape) -> float | None:
    """HMR's seeded init: convs He-normal, fc1 / fc2 LeCun-normal, fc3
    Xavier-normal scaled by 5e-5 (the features grow to ~10² through the
    identity BatchNorms, and fc3 adds them to θ three times),
    BatchNorm the identity, biases 0. :func:`hmr_state` then sets the
    regressor to the traffic's images."""
    if not name.endswith("weight") or len(shape) < 2:
        return None
    fan_in = math.prod(shape[1:])
    if len(shape) == 4:
        return math.sqrt(2.0 / fan_in)
    if "fc3" in name:
        return math.sqrt(2.0 / (fan_in + shape[0])) * 5e-5
    return math.sqrt(1.0 / fan_in)


@torch.no_grad()
def hmr_state(net: nn.Module, seed: int, device, mean_theta,
              calib: torch.Tensor, pose_rms: float) -> dict:
    """HMR's seeded state (:func:`hmr_std`), set to the images it will
    see as a trained regressor is: fc1's bias centres the features of
    ``calib`` (B, 224, 224, 3), so the θ that fc3 adds follows how an
    image differs from the others and not what they share, and fc3's
    pose and shape rows are scaled so the pose of ``calib``'s θs lies
    ``pose_rms`` (RMS) from the mean pose; the camera rows keep their
    5e-5 and the body stays on screen. ``net`` is the benchmark's own
    HMR (plain torch) on ``device``; cuDNN runs deterministically
    here."""
    state = seeded_state(net, hmr_std, seed, device,
                         {"regressor.mean_theta": mean_theta})
    net.load_state_dict(state)
    net.eval()
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        feat = net.resnet(calib.permute(0, 3, 1, 2))
        fc1 = net.regressor.fc_blocks.fc1
        fc1.bias.copy_(-(fc1.weight[:, :feat.shape[1]] @ feat.mean(0)))
        dev = net.regressor(feat)[:, 3:75] - net.regressor.mean_theta[3:75]
        net.regressor.fc_blocks.fc3.weight[3:] *= (
            pose_rms / dev.square().mean().sqrt())
    finally:
        torch.backends.cudnn.deterministic = was
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


# Random He-normal DeepFill weights halve the activations at every gated
# layer (the sigmoid gate); 1.8x on the feature convs keeps them O(0.1)
# through the 35 layers, as the port's own seeded DeepFill does.
BGNET_FEATURE_GAIN = 1.8


def bgnet_std(name: str, shape) -> float | None:
    """DeepFill's seeded init: gated convs He-normal, the feature convs
    (not the gates) times :data:`BGNET_FEATURE_GAIN`, the attention's
    1x1 convs LeCun-normal, biases 0, BatchNorm the identity."""
    if not name.endswith("weight") or len(shape) < 2:
        return None
    fan_in = math.prod(shape[1:])
    if name.startswith("refine_attn."):
        return math.sqrt(1.0 / fan_in)
    gain = 1.0 if name.endswith("mask_conv2d.weight") else BGNET_FEATURE_GAIN
    return math.sqrt(2.0 / fan_in) * gain


def seeded_state(net: nn.Module, std_of, seed: int, device,
                 consts: dict | None = None) -> dict:
    """A state dict for ``net`` (built on any device, ``meta`` included):
    every entry that ``std_of(name, shape)`` gives a std is drawn from
    one standard-normal draw of a ``torch.Generator`` on ``device``
    seeded with ``seed``; the others are 1 (norm weights, running
    variances), 0, or ``consts[name]``."""
    consts = consts or {}
    state = net.state_dict()
    drawn = [(k, v.shape, std_of(k, v.shape)) for k, v in state.items()
             if k not in consts and v.is_floating_point()]
    drawn = [(k, shape, std) for k, shape, std in drawn if std is not None]
    total = sum(math.prod(shape) for _, shape, _ in drawn)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for k, shape, std in drawn:
        n = math.prod(shape)
        out[k] = (flat[at:at + n] * std).reshape(shape)
        at += n
    for k, v in state.items():
        if k in out:
            continue
        if k in consts:
            out[k] = torch.as_tensor(consts[k], dtype=v.dtype,
                                     device=device).reshape(v.shape)
        elif k.endswith(("running_var",)) or (
                k.endswith("weight") and v.ndim == 1):
            out[k] = torch.ones(v.shape, dtype=v.dtype, device=device)
        else:
            out[k] = torch.zeros(v.shape, dtype=v.dtype, device=device)
    return out


def facenet_std(name: str, shape) -> float | None:
    """VGG19's and Sphere20a's seeded init (flax's defaults, as the
    trainers' frozen nets start): conv and dense weights N(0,
    1/fan_in), biases 0."""
    if not name.endswith("weight") or len(shape) < 2:
        return None
    return math.sqrt(1.0 / math.prod(shape[1:]))


def prelu_slopes(net: nn.Module) -> dict:
    """Every PReLU slope of ``net`` at 0.25."""
    return {k: torch.full(v.shape, 0.25) for k, v in net.state_dict().items()
            if k.startswith("relu") and k.endswith("weight")}
