"""The repository's tools on the port (torch counterparts of the JAX
package's ``tools/*.py``), each run as ``python -m
impersonator_tpu_torch.tools.<name>``: ``convert_weights``,
``prepare_iper``, ``make_prior_poses``, ``visual_iper``,
``parity_harness``, ``posttune_artifact`` and ``trainconv_artifact``.
They run on CUDA unless ``--device cpu`` is given, and raise when asked
for a card that is not there.

Weight files: a tool's ``*_ckpt`` flag takes a released ``.pth`` (the
reference's keys, loaded with ``weights_only=True`` through
``utils.convert.reference_state_dict``) or a JAX-package msgpack (read
without flax).
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; no fallback) or cpu")


def resolve_device(name: str) -> torch.device:
    """``name`` as a torch.device; a card that is not there raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this tool runs on CUDA unless --device cpu is "
                           "given, and no card is visible")
    return device


def load_reference(path: str) -> dict:
    """A released weight file -> its state dict on the CPU: a ``.pth``
    read with ``weights_only=True``, or the SENet50 release's pickle of
    numpy arrays keyed like a state dict (its ``fc`` head dropped, as
    ``tools/convert_weights.py`` reads it)."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            raw = pickle.load(f, encoding="latin1")
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in raw.items() if not k.startswith("fc")}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: not a state dict ({type(sd).__name__})")
    return sd


def net_state_dict(kind: str, path: str) -> dict:
    """The port module's state dict for a ``kind`` file (the converter's
    kinds): a JAX msgpack through ``utils.convert.FROM_JAX``, anything
    else as a released file through ``reference_state_dict``."""
    from impersonator_tpu_torch.utils import convert
    from impersonator_tpu_torch.utils.checkpoint import read_flax_msgpack
    if path.endswith(".msgpack"):
        return convert.FROM_JAX[kind](read_flax_msgpack(path))
    return convert.reference_state_dict(kind, load_reference(path))


def image_paths(folder: str) -> list:
    return sorted(os.path.join(folder, p) for p in os.listdir(folder)
                  if p.lower().endswith((".jpg", ".jpeg", ".png")))
