"""The one traffic generator: it reads a mix's parameters from
``traffic/<name>.json`` and makes every input of a run from the seed,
on the device, in a few large calls.

An imitation mix (``"driver": "imitate"``) is a stream of jobs, each a
new user: a seeded 256² source image (colour waves, ``"sources":
"waves"``, or a frame of the crops' pattern, ``"pattern"``), its θ (or
none, for HMR to regress), and L targets: θs that walk from the
source's pose (``"targets": "theta"``), or L consecutive 224² crops of
a pool staged on the device, a stand-in video whose pattern drifts from
frame to frame (``"targets": "crops"``). Every seed gets the same multiset of
lengths (each of ``lengths``, in steps of ``length_step``, once per
cycle) in another order, so seeds change the values and not the
work."""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent


def load(name: str) -> dict:
    """The parameters of traffic mix ``name``."""
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


def stream_seeds(seed: int) -> tuple:
    """Independent seeds for the weights and the traffic of one run."""
    ss = np.random.SeedSequence(seed % (1 << 128))
    return tuple(int(s.generate_state(1, np.uint64)[0] >> 1)
                 for s in ss.spawn(2))


@dataclasses.dataclass
class Job:
    index: int
    length: int
    src_img: torch.Tensor              # (S, S, 3) in [-1, 1]
    src_theta: torch.Tensor | None     # (85,), None: regressed by HMR
    targets: torch.Tensor              # (L, 85) θs or (L, 224, 224, 3)


def length_cycle(spec: dict, seed: int) -> list:
    """Each length of ``spec["lengths"]`` ([low, high], inclusive, in
    steps of ``spec["length_step"]``) once, in the seed's order."""
    low, high = spec["lengths"]
    rng = np.random.default_rng(seed)
    values = np.arange(low, high + 1, spec["length_step"])
    return [int(v) for v in rng.permutation(values)]


def source_images(n: int, s: int, gen: torch.Generator, device):
    """n smooth stand-ins for photos (n, s, s, 3) in [-1, 1]: per channel
    0.8 sin(2π(fx x + fy y) + φ) with fx, fy in [0.3, 2] cycles per image
    and φ in [0, 2π)."""
    f = 0.3 + 1.7 * torch.rand(n, 3, 2, generator=gen, device=device)
    ph = 2 * math.pi * torch.rand(n, 3, generator=gen, device=device)
    ax = torch.arange(s, device=device, dtype=torch.float32) / s
    y, x = torch.meshgrid(ax, ax, indexing="ij")
    arg = (f[..., 0, None, None] * x + f[..., 1, None, None] * y)
    img = 0.8 * torch.sin(2 * math.pi * arg + ph[..., None, None])
    return img.permute(0, 2, 3, 1).contiguous()


def source_thetas(n: int, spec: dict, gen: torch.Generator, device):
    """n source θs (n, 85): camera scale and shift uniform in the mix's
    ranges, pose N(0, pose_std) about the rest pose, shape N(0,
    shape_std)."""
    def uniform(lo_hi, *shape):
        lo, hi = lo_hi
        return lo + (hi - lo) * torch.rand(*shape, generator=gen,
                                           device=device)

    theta = torch.zeros(n, 85, device=device)
    theta[:, 0] = uniform(spec["cam_scale"], n)
    theta[:, 1:3] = uniform(spec["cam_shift"], n, 2)
    theta[:, 3:75] = spec["pose_std"] * torch.randn(n, 72, generator=gen,
                                                    device=device)
    theta[:, 75:] = spec["shape_std"] * torch.randn(n, 10, generator=gen,
                                                    device=device)
    return theta


def pose_walks(src: torch.Tensor, length: int, spec: dict,
               gen: torch.Generator):
    """L target θs (L, 85) of one job: the source's camera and shape, the
    72 pose values a random walk from the source's pose with steps
    N(0, walk_std)."""
    steps = spec["walk_std"] * torch.randn(length, 72, generator=gen,
                                           device=src.device)
    out = src[None].repeat(length, 1)
    out[:, 3:75] = src[3:75] + steps.cumsum(0)
    return out


def pattern(ph: torch.Tensor, s: int, gen: torch.Generator,
            noise: float):
    """Images (n, s, s, 3) in [-1, 1] of one smooth pattern at the phases
    ``ph`` (n, 3), plus N(0, noise), clipped."""
    ax = torch.arange(s, device=ph.device, dtype=torch.float32) / s
    y, x = torch.meshgrid(ax, ax, indexing="ij")
    ph = ph[..., None, None]
    img = torch.stack([torch.sin(6.0 * x + ph[:, 0]),
                       torch.cos(4.0 * y + ph[:, 1]),
                       torch.sin(5.0 * x * y + ph[:, 2])], -1)
    img = 0.8 * img + noise * torch.randn(img.shape, generator=gen,
                                          device=ph.device)
    return img.clamp(-1, 1)


def random_phases(n: int, gen: torch.Generator, device):
    return 2 * math.pi * torch.rand(n, 3, generator=gen, device=device)


def crop_pool(n: int, gen: torch.Generator, device, noise: float,
              phase_step: float):
    """n stand-ins for the 224² crops of a video, in [-1, 1]: the pattern
    with its phases a random walk of steps N(0, phase_step) from random
    ones, so HMR's θ drifts from frame to frame as a body moves."""
    ph = random_phases(1, gen, device) + (phase_step * torch.randn(
        n, 3, generator=gen, device=device)).cumsum(0)
    return pattern(ph, 224, gen, noise)


def pattern_sources(n: int, s: int, gen: torch.Generator, device,
                    noise: float):
    """n source images (n, s, s, 3) of the crops' pattern at random
    phases, in [0, 1]: the port maps a source once more by ``* 2 - 1``
    before HMR (as the reference's ``transform_img`` does to an image it
    takes for [0, 1]), so HMR sees the crops' kind of image."""
    return (pattern(random_phases(n, gen, device), s, gen, noise) + 1) / 2


def imitation_jobs(spec: dict, seed: int, image_size: int, device) -> list:
    """The job pool of one run: ``spec["cycles"]`` cycles of the length
    multiset, job i of length ``cycle[i % len(cycle)]``; the window runs
    them in order and starts the pool again if it ends."""
    cycle = length_cycle(spec, seed)
    n = len(cycle) * spec["cycles"]
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    if spec["sources"] == "pattern":
        imgs = pattern_sources(n, image_size, gen, device,
                               spec["crop_noise"])
    else:
        imgs = source_images(n, image_size, gen, device)
    thetas = source_thetas(n, spec, gen, device)
    pool = None
    if spec["targets"] == "crops":
        pool = crop_pool(spec["pool"], gen, device, spec["crop_noise"],
                         spec["phase_step"])
        room = torch.tensor([spec["pool"] - cycle[i % len(cycle)] + 1
                             for i in range(n)], device=device)
        starts = (torch.rand(n, generator=gen, device=device)
                  * room).long().tolist()
    jobs = []
    for i in range(n):
        length = cycle[i % len(cycle)]
        if pool is None:
            targets = pose_walks(thetas[i], length, spec, gen)
        else:   # a view: the pool holds every job's crops in one piece
            targets = pool[starts[i]:starts[i] + length]
        given = thetas[i] if spec["source_theta"] == "given" else None
        jobs.append(Job(i, length, imgs[i], given, targets))
    return jobs
