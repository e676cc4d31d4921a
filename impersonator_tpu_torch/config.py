"""Run configuration of the inference tasks.

The port's own copy of ``impersonator_tpu/config.py``'s ``BaseConfig``
and ``TestConfig``: the reference's option names and defaults
(``options/base_options.py``, ``test_options.py``) as typed dataclasses.
Defaults must stay equal to the JAX package's
(``tests/test_torch_assets.py`` compares them field by field). Training
flags, argparse parity and the ``opt_*.txt`` audit file come with the
port's trainer and CLI.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


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
