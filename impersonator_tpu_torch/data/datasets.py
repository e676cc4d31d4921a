"""Datasets of the trainer (torch port of
``impersonator_tpu/data/datasets.py:189-270``).

Every dataset yields numpy dicts with the trainer's contract
``{'images': (2, S, S, 3) float32 in [-1, 1], 'smpls': (2, 85) float32}``
(and ``'bg': (S, S, 3)`` for the background-augmented streams).
:class:`SyntheticPairDataset` lets the training stack run with no data on
disk; it gives the JAX package's arrays, item for item, for the same
seed. The iPER, Places2 and DeepFashion readers decode JPEGs, which waits
for the port's image decoder (``ROADMAP.md`` Queue 1 item 11).
"""

from __future__ import annotations

import numpy as np


class SyntheticPairDataset:
    """Procedural pairs: uniform-noise images and θs with cam scale 0.9
    and N(0, 0.05) poses, each item from numpy's generator of
    ``seed * 100003 + idx``."""

    def __init__(self, image_size: int = 64, length: int = 64, seed: int = 0,
                 with_bg: bool = False):
        self.image_size = image_size
        self.length = length
        self.seed = seed
        self.with_bg = with_bg

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        s = self.image_size
        images = rng.uniform(-1, 1, (2, s, s, 3)).astype(np.float32)
        smpls = np.zeros((2, 85), np.float32)
        smpls[:, 0] = 0.9
        smpls[:, 3:75] = rng.normal(0, 0.05, (2, 72))
        out = {"images": images, "smpls": smpls}
        if self.with_bg:
            out["bg"] = rng.uniform(-1, 1, (s, s, 3)).astype(np.float32)
        return out


_NEEDS_DECODER = ("iPER", "iPER_place", "fashion", "iPER_fashion_place",
                  "place")


def dataset_by_name(name: str, cfg, ids_file: str | None = None):
    """The dataset registry of the reference's ``--dataset_mode`` names.
    ``ids_file`` (the split file) matters only to the iPER readers."""
    if name == "synthetic":
        return SyntheticPairDataset(cfg.image_size)
    if name == "synthetic_bg":
        return SyntheticPairDataset(cfg.image_size, with_bg=True)
    if name in _NEEDS_DECODER:
        raise NotImplementedError(
            f"dataset {name!r} decodes JPEG frames, which waits for the "
            "port's image decoder (ROADMAP.md Queue 1 item 11); use "
            "--dataset_mode synthetic")
    raise ValueError(f"unknown dataset: {name}")
