"""Run configuration of the inference tasks.

The port's own copy of ``impersonator_tpu/config.py``'s ``BaseConfig``
and ``TestConfig``: the reference's option names and defaults
(``options/base_options.py``, ``test_options.py``) as typed dataclasses.
Defaults must stay equal to the JAX package's
(``tests/test_torch_assets.py`` and ``tests/test_torch_train_loop.py``
compare them field by field). ``TrainConfig`` holds the training flags;
``to_argparse`` / ``from_args`` give the entry points the same flags, and
``BaseConfig.save`` writes the ``opt_*.txt`` audit file.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass
from typing import Tuple

from impersonator_tpu_torch.utils.checkpoint import latest_epoch


@dataclass
class BaseConfig:
    # --- data / assets ---
    data_dir: str = "/data/iPER"
    place_dir: str = "/data/places365_standard"
    fashion_dir: str = "/data/fashion"
    dataset_mode: str = "auto"
    images_folder: str = "images_HD"
    smpls_folder: str = "smpls"
    train_ids_file: str = "train.txt"
    test_ids_file: str = "val.txt"
    checkpoints_dir: str = "./outputs/checkpoints"
    name: str = "default"

    # asset files; empty → synthetic procedural assets (tests/benches)
    smpl_model: str = ""
    uv_mapping: str = ""
    part_info: str = ""
    front_info: str = ""
    head_info: str = ""
    hmr_model: str = ""
    face_model: str = ""

    # --- model ---
    model: str = "impersonator_trainer"
    gen_name: str = "impersonator"
    image_size: int = 256
    batch_size: int = 16
    tex_size: int = 3
    repeat_num: int = 6
    map_name: str = "uv_seg"
    norm_type: str = "instance"
    bg_ks: int = 13
    ft_ks: int = 3

    # --- runtime ---
    load_epoch: int = -1
    load_path: str = ""
    n_threads: int = 4
    serial_batches: bool = False
    seed: int = 0

    # numeric policy: params fp32; compute dtype for conv-heavy nets
    compute_dtype: str = "bfloat16"

    # parallelism
    mesh_shape: Tuple[int, ...] = (-1,)   # -1 → all devices on 'data'
    mesh_axes: Tuple[str, ...] = ("data",)

    def assets(self):
        """Resolve the asset bundle (real files or synthetic)."""
        from impersonator_tpu_torch import assets as A
        if self.smpl_model:
            return A.load_smpl_assets(
                self.smpl_model, self.uv_mapping, self.part_info,
                self.front_info, self.head_info)
        return A.synthetic_assets()

    # ---- persistence ----------------------------------------------------

    def expr_dir(self) -> str:
        return os.path.join(self.checkpoints_dir, self.name)

    def save(self, phase: str = "train") -> str:
        """Write every option to ``{expr_dir}/opt_{phase}.txt``."""
        os.makedirs(self.expr_dir(), exist_ok=True)
        path = os.path.join(self.expr_dir(), f"opt_{phase}.txt")
        with open(path, "w") as f:
            f.write("------------ Options -------------\n")
            for k, v in sorted(dataclasses.asdict(self).items()):
                f.write(f"{k}: {v}\n")
            f.write("-------------- End ----------------\n")
        return path

    def resolve_load_epoch(self) -> int:
        """load_epoch == -1 → the latest complete checkpoint epoch in
        expr_dir (``utils.checkpoint.latest_epoch``; 0 when there is
        none)."""
        if self.load_epoch >= 0:
            return self.load_epoch
        return latest_epoch(self.expr_dir())


@dataclass
class TrainConfig(BaseConfig):
    """Training flags (the reference's options/train_options.py)."""

    is_train: bool = True
    nepochs_no_decay: int = 5
    nepochs_decay: int = 25
    lr_G: float = 2e-4
    lr_D: float = 2e-4
    final_lr: float = 2e-6
    G_adam_b1: float = 0.5
    G_adam_b2: float = 0.999
    D_adam_b1: float = 0.5
    D_adam_b2: float = 0.999
    train_G_every_n_iterations: int = 1
    d_layers: int = 4  # PatchGAN depth (needs image_size >= 64)

    # loss weights (the paper's recipe)
    lambda_D_prob: float = 1.0
    lambda_rec: float = 10.0
    lambda_tsf: float = 10.0
    lambda_face: float = 5.0
    lambda_style: float = 0.0
    lambda_mask: float = 1.0
    lambda_mask_smooth: float = 1.0

    use_vgg: bool = True
    use_style: bool = False
    use_face: bool = True
    mask_bce: bool = True
    bg_both: bool = False
    # train step's compute dtype, "float32" | "bfloat16": G / D / VGG run
    # in it with float32 master weights and float32 loss terms
    train_dtype: str = "float32"
    # recompute the generator forward in the backward pass
    # (torch.utils.checkpoint) instead of keeping its activations
    remat: bool = False

    # logging / checkpoint cadence (seconds, except display_freq_steps)
    print_freq_s: int = 60
    display_freq_s: int = 300
    display_freq_steps: int = 500
    save_latest_freq_s: int = 3600
    num_iters_validate: int = 1


@dataclass
class TestConfig(BaseConfig):
    """Inference flags (the reference's options/test_options.py)."""

    is_train: bool = False
    bg_model: str = "ORIGINAL"       # deepfillv2 ckpt path, or ORIGINAL
    src_path: str = ""
    tgt_path: str = ""
    output_dir: str = "./outputs/results"
    cam_strategy: str = "smooth"     # smooth | source | copy
    post_tune: bool = False
    front_warp: bool = False
    only_vis: bool = False
    has_detector: bool = False
    bg_replace: bool = False
    save_res: bool = True

    # swapper
    swap_part: str = "body"

    # viewer
    T_pose: bool = False
    view_params: str = "R=0,90,0/t=0,0,0"

    def parse_view_params(self):
        """'R=xxx,yyy,zzz/t=dx,dy,dz' (degrees) → dict."""
        params = {}
        for part in self.view_params.split("/"):
            key, vals = part.split("=")
            params[key.strip()] = [float(v) for v in vals.split(",")]
        return params


def to_argparse(config_cls) -> argparse.ArgumentParser:
    """One ``--name`` flag per field: booleans as ``--flag`` /
    ``--no-flag``, tuples as comma-separated strings."""
    parser = argparse.ArgumentParser()
    for f in dataclasses.fields(config_cls):
        if f.type in ("bool", bool):
            parser.add_argument(f"--{f.name}",
                                action=argparse.BooleanOptionalAction,
                                default=f.default)
        elif isinstance(f.default, tuple):
            parser.add_argument(f"--{f.name}", type=str,
                                default=",".join(map(str, f.default)))
        else:
            typ = type(f.default) if f.default is not None else str
            parser.add_argument(f"--{f.name}", type=typ, default=f.default)
    return parser


def from_args(config_cls, argv=None):
    """The config of ``argv`` (unknown flags are left to other parsers)."""
    ns, _ = to_argparse(config_cls).parse_known_args(argv)
    kwargs = vars(ns)
    for f in dataclasses.fields(config_cls):
        if isinstance(f.default, tuple) and isinstance(kwargs[f.name], str):
            parts = [p for p in kwargs[f.name].split(",") if p]
            cast = int if all(p.lstrip("-").isdigit() for p in parts) else str
            kwargs[f.name] = tuple(cast(p) for p in parts)
    return config_cls(**kwargs)
