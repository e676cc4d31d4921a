"""Datasets of the trainers (torch port of
``impersonator_tpu/data/datasets.py:40-270``).

Every dataset yields numpy dicts with the trainers' contract
``{'images': (2, S, S, 3) float32 in [-1, 1], 'smpls': (2, 85) float32}``
(and ``'bg': (S, S, 3)`` for the background-augmented streams):

* :class:`ImPerDataset` — iPER pairs: two frames of one video and their
  θs from the video's ``pose_shape.pkl``;
* :class:`PlaceDataset` — Places2 backgrounds, randomly cropped and
  flipped;
* :class:`FashionPairDataset` — DeepFashion pairs from a pair list, each
  image with a sibling ``_smpl.pkl``;
* :class:`ImPerPlaceDataset` / :class:`ImPerFashionPlaceDataset` — iPER
  (and DeepFashion) pairs, each with a random Places2 background;
* :class:`SyntheticPairDataset` — procedural pairs, so that the training
  stack runs with no data on disk.

Images are decoded by the port's codec on an explicit ``device``'s build
(``utils.cv_utils.read_img``: nvJPEG for ``"cuda"``, libjpeg for
``"cpu"``) and resized on the host (``resize_img_hwc``). The random draws
are the JAX package's, draw for draw: one ``random.Random(seed)`` per
dataset, drawn in the same order (a pair's frame i, then its interval; a
crop's y, then x, then the flip; a composite's background index after
its pair), over the same ``sorted(glob(...))`` file lists. That holds for
items read one after another. The loader's worker threads call
``__getitem__`` concurrently, so there the draws are shared out among
the items in the order the threads reach them, as in the JAX package's
loader.
"""

from __future__ import annotations

import glob
import os
import pickle
import random

import numpy as np

from impersonator_tpu_torch.utils import cv_utils


def _load_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _theta85(d, flat: bool = False) -> np.ndarray:
    """cams (·, 3), pose (·, 72), shape (·, 10) -> (·, 85) float32."""
    parts = [np.asarray(d[k], np.float32) for k in ("cams", "pose", "shape")]
    if flat:
        return np.concatenate([p.reshape(-1) for p in parts])
    return np.concatenate(parts, axis=1)


class ImPerDataset:
    """iPER pair sampler over ``{data_dir}/{images_folder}/{video}/*`` and
    ``{data_dir}/{smpls_folder}/{video}/pose_shape.pkl`` (keys 'cams'
    (N, 3), 'pose' (N, 72), 'shape' (N, 10)), for the videos listed in
    ``{data_dir}/{ids_file}``; a video with fewer than 2 frames or no
    pickle is skipped. An item is frame i (uniform) and frame
    min(n - 1, i + U{1..interval}) of video ``idx % len``."""

    def __init__(self, data_dir: str, ids_file: str, image_size: int = 256,
                 images_folder: str = "images_HD", smpls_folder: str = "smpls",
                 interval: int = 10, seed: int = 0, device="cuda"):
        self.image_size = image_size
        self.interval = interval
        self.device = device
        self.rng = random.Random(seed)
        self.videos = []
        with open(os.path.join(data_dir, ids_file)) as f:
            vids = [line.strip() for line in f if line.strip()]
        for vid in vids:
            frames = sorted(glob.glob(os.path.join(data_dir, images_folder,
                                                   vid, "*")))
            pkl = os.path.join(data_dir, smpls_folder, vid, "pose_shape.pkl")
            if len(frames) >= 2 and os.path.exists(pkl):
                self.videos.append((frames, pkl))
        self._smpl_cache = {}

    def __len__(self):
        return len(self.videos)

    def _smpls(self, pkl):
        if pkl not in self._smpl_cache:
            self._smpl_cache[pkl] = _theta85(_load_pickle(pkl))
        return self._smpl_cache[pkl]

    def _image(self, path):
        return cv_utils.resize_img_hwc(cv_utils.read_img(path, self.device),
                                       self.image_size)

    def __getitem__(self, idx):
        frames, pkl = self.videos[idx % len(self.videos)]
        smpls = self._smpls(pkl)
        n = min(len(frames), smpls.shape[0])
        i = self.rng.randrange(n)
        j = min(n - 1, i + self.rng.randrange(1, self.interval + 1))
        return {"images": np.stack([self._image(frames[i]),
                                    self._image(frames[j])]),
                "smpls": smpls[[i, j]]}


class PlaceDataset:
    """Every ``*.jpg`` under ``data_dir`` (recursive, sorted); an item is
    a random image_size² crop where the image is larger on both sides
    (else the whole image), resized to image_size², flipped left-right
    with probability 1/2 -> {'bg': (S, S, 3)}."""

    def __init__(self, data_dir: str, image_size: int = 256, seed: int = 0,
                 device="cuda"):
        self.paths = sorted(glob.glob(os.path.join(data_dir, "**", "*.jpg"),
                                      recursive=True))
        self.image_size = image_size
        self.device = device
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx):
        img = cv_utils.read_img(self.paths[idx % len(self.paths)],
                                self.device)
        h, w = img.shape[:2]
        s = self.image_size
        if h > s and w > s:
            y = self.rng.randrange(h - s + 1)
            x = self.rng.randrange(w - s + 1)
            img = img[y:y + s, x:x + s]
        out = cv_utils.resize_img_hwc(img, s)
        if self.rng.random() < 0.5:
            out = out[:, ::-1].copy()
        return {"bg": out}


class FashionPairDataset:
    """DeepFashion (src, tsf) pairs: each line of ``{data_dir}/{pairs_file}``
    names two image paths relative to data_dir; each image's θ is in the
    sibling ``<name>_smpl.pkl`` ('cams', 'pose', 'shape'). No file, no
    pairs."""

    def __init__(self, data_dir: str, pairs_file: str = "pairs.txt",
                 image_size: int = 256, device="cuda"):
        self.data_dir = data_dir
        self.image_size = image_size
        self.device = device
        self.pairs = []
        path = os.path.join(data_dir, pairs_file)
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 2:
                        self.pairs.append((parts[0], parts[1]))

    def __len__(self):
        return len(self.pairs)

    def _load(self, rel):
        img = cv_utils.resize_img_hwc(
            cv_utils.read_img(os.path.join(self.data_dir, rel), self.device),
            self.image_size)
        smpl = _theta85(_load_pickle(os.path.join(
            self.data_dir, os.path.splitext(rel)[0] + "_smpl.pkl")),
            flat=True)
        return img, smpl

    def __getitem__(self, idx):
        a, b = self.pairs[idx % len(self.pairs)]
        img_a, smpl_a = self._load(a)
        img_b, smpl_b = self._load(b)
        return {"images": np.stack([img_a, img_b]),
                "smpls": np.stack([smpl_a, smpl_b])}


class ImPerPlaceDataset:
    """An iPER pair with a random Places2 background (the augmented
    trainer's stream)."""

    def __init__(self, imper: ImPerDataset, place: PlaceDataset,
                 seed: int = 0):
        self.imper = imper
        self.place = place
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.imper)

    def __getitem__(self, idx):
        sample = self.imper[idx]
        sample["bg"] = self.place[self.rng.randrange(len(self.place))]["bg"]
        return sample


class ImPerFashionPlaceDataset:
    """iPER and DeepFashion pairs pooled (iPER's first; an empty source
    is left out), each with a random Places2 background."""

    def __init__(self, imper: ImPerDataset, fashion: FashionPairDataset,
                 place: PlaceDataset, seed: int = 0):
        self.sources = [d for d in (imper, fashion) if len(d) > 0]
        self.place = place
        self.rng = random.Random(seed)

    def __len__(self):
        return sum(len(d) for d in self.sources)

    def __getitem__(self, idx):
        for d in self.sources:
            if idx < len(d):
                sample = d[idx]
                break
            idx -= len(d)
        else:
            sample = self.sources[0][idx]
        sample["bg"] = self.place[self.rng.randrange(len(self.place))]["bg"]
        return sample


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


def dataset_by_name(name: str, cfg, ids_file: str | None = None,
                    device="cuda"):
    """The dataset registry of the reference's ``--dataset_mode`` names.
    ``ids_file`` overrides the iPER split file (cfg.train_ids_file);
    ``device`` picks the codec build that decodes the images."""
    ids = ids_file or cfg.train_ids_file
    s = cfg.image_size

    def imper():
        return ImPerDataset(cfg.data_dir, ids, s, cfg.images_folder,
                            cfg.smpls_folder, device=device)

    def place():
        return PlaceDataset(cfg.place_dir, s, device=device)

    def fashion():
        return FashionPairDataset(cfg.fashion_dir, image_size=s,
                                  device=device)

    if name == "iPER":
        return imper()
    if name == "iPER_place":
        return ImPerPlaceDataset(imper(), place())
    if name == "fashion":
        return fashion()
    if name == "iPER_fashion_place":
        return ImPerFashionPlaceDataset(imper(), fashion(), place())
    if name == "place":
        return place()
    if name == "synthetic":
        return SyntheticPairDataset(s)
    if name == "synthetic_bg":
        return SyntheticPairDataset(s, with_bg=True)
    raise ValueError(f"unknown dataset: {name}")
