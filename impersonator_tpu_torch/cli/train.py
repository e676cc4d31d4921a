"""Training entry point of the port, one process on one device (torch port of
``impersonator_tpu/cli/train.py:30-214``).

The epoch loop of the reference's train.py: G every step and D every
``train_G_every_n_iterations``-th step, G's and D's learning rates set
per epoch (each decays on its own), timed printing, the visuals dump and
the validation pass on a wall-clock cadence, "latest" snapshots and a
checkpoint per epoch through an :class:`AsyncCheckpointer`, and resume
from ``--load_epoch`` (-1: the latest epoch on disk).

``--model`` picks the trainer: ``impersonator_trainer`` (the base LWB
trainer), ``impersonator_trainer_aug`` (Places2 backgrounds, Global +
Local D) or an ablation baseline (``concat``, ``texture_warping``,
``feature_warping``). As in the JAX package, the augmented and baseline
runs have no validation pass and no visuals. ``--dataset_mode auto``
reads ``iPER`` (``iPER_place`` for the augmented trainer) when an SMPL
model is configured, else the synthetic pairs (``synthetic_bg``).

Usage:
    python -m impersonator_tpu_torch.cli.train --dataset_mode synthetic
    python -m impersonator_tpu_torch.cli.train --dataset_mode synthetic \\
        --device cpu --image_size 64 --batch_size 2
    python -m impersonator_tpu_torch.cli.train --model feature_warping \\
        --dataset_mode synthetic --device cpu --image_size 64

Besides every TrainConfig flag: ``--device`` (default cuda; no fallback
when there is no card).
"""

from __future__ import annotations

import argparse
import time

import torch

from impersonator_tpu_torch.config import TrainConfig, from_args
from impersonator_tpu_torch.data.datasets import dataset_by_name
from impersonator_tpu_torch.data.loader import DataLoader
from impersonator_tpu_torch.tasks import trainer as trainer_mod
from impersonator_tpu_torch.tasks import trainer_aug as aug_mod
from impersonator_tpu_torch.tasks import trainer_baseline as base_mod
from impersonator_tpu_torch.utils import checkpoint as ckpt
from impersonator_tpu_torch.utils.visualizer import Visualizer


def _parse_extra(argv):
    parser = argparse.ArgumentParser(allow_abbrev=False)
    parser.add_argument("--device", default="cuda")
    extra, _ = parser.parse_known_args(argv)
    return extra


def _dataset_name(cfg) -> str:
    if cfg.dataset_mode != "auto":
        return cfg.dataset_mode
    aug = cfg.model == "impersonator_trainer_aug"
    if not cfg.smpl_model:
        return "synthetic_bg" if aug else "synthetic"
    return "iPER_place" if aug else "iPER"


def _validate(eval_fn, state, val_loader, n_iters: int) -> dict:
    """Mean eval-mode losses over the first n_iters validation batches."""
    sums, n = {}, 0
    for val_batch in val_loader:
        if n >= n_iters:
            break
        for k, v in eval_fn(state, val_batch).items():
            sums[k] = sums.get(k, 0.0) + float(v)
        n += 1
    return {k: v / n for k, v in sums.items()} if n else {}


def main(argv=None):
    extra = _parse_extra(argv)
    cfg = from_args(TrainConfig, argv)
    if cfg.model == "impersonator_trainer":
        build, make_step = (trainer_mod.build_trainer,
                            trainer_mod.make_train_step)
    elif cfg.model == "impersonator_trainer_aug":
        build, make_step = (aug_mod.build_aug_trainer,
                            aug_mod.make_aug_train_step)
    elif cfg.model in base_mod.BASELINE_MODES:
        build, make_step = (base_mod.build_baseline_trainer,
                            base_mod.make_train_step)
    else:
        raise ValueError(f"--model {cfg.model} is not a trainer")
    cfg.save("train")
    trainer = build(cfg, device=extra.device)
    state = trainer.init_state()

    name = _dataset_name(cfg)
    loader = DataLoader(dataset_by_name(name, cfg, device=trainer.device),
                        cfg.batch_size, num_workers=cfg.n_threads,
                        seed=cfg.seed, device=trainer.device)
    vis = Visualizer(cfg.expr_dir())
    step_fn = make_step(trainer, train_d=True)
    step_g_only = make_step(trainer, train_d=False)
    visuals_fn = eval_fn = val_loader = None
    if cfg.model == "impersonator_trainer":
        val_loader = DataLoader(
            dataset_by_name(name, cfg, ids_file=cfg.test_ids_file,
                            device=trainer.device),
            cfg.batch_size, num_workers=1, seed=cfg.seed + 1,
            device=trainer.device)
        visuals_fn = trainer_mod.make_visuals_fn(trainer)
        eval_fn = trainer_mod.make_train_step(trainer, eval_only=True)

    start_epoch = cfg.resolve_load_epoch()
    if start_epoch > 0:
        state = ckpt.load_train_state(state, cfg.expr_dir(), start_epoch)
        print(f"resumed from epoch {start_epoch}", flush=True)

    total_epochs = cfg.nepochs_no_decay + cfg.nepochs_decay
    i_step = 0
    last_print = last_save = last_display = time.time()
    saver = ckpt.AsyncCheckpointer()
    try:
        for epoch in range(start_epoch, total_epochs):
            state = trainer.set_lr(state, trainer.epoch_lr(epoch),
                                   trainer.epoch_lr(epoch, base=cfg.lr_D))
            for batch in loader:
                train_d = i_step % cfg.train_G_every_n_iterations == 0
                t0 = time.perf_counter()
                state, metrics = (step_fn if train_d else step_g_only)(
                    state, batch)
                if time.time() - last_print > cfg.print_freq_s:
                    errors = {k: float(v) for k, v in metrics.items()}
                    dt = time.perf_counter() - t0   # float() synchronised
                    vis.print_current_errors(epoch, i_step, errors,
                                             dt / cfg.batch_size)
                    vis.log_scalars(i_step, epoch, errors)
                    last_print = time.time()
                if (visuals_fn is not None
                        and time.time() - last_display > cfg.display_freq_s):
                    vis.save_images(i_step, visuals_fn(state, batch))
                    val_errors = _validate(eval_fn, state, val_loader,
                                           cfg.num_iters_validate)
                    if val_errors:
                        vis.print_current_errors(epoch, i_step, val_errors,
                                                 0.0)
                        vis.log_scalars(i_step, epoch, val_errors,
                                        phase="val")
                    last_display = time.time()
                if time.time() - last_save > cfg.save_latest_freq_s:
                    saver.submit(state, cfg.expr_dir(), "latest")
                    last_save = time.time()
                i_step += 1
            saver.submit(state, cfg.expr_dir(), epoch + 1)
            print(f"saved epoch {epoch + 1}", flush=True)
    finally:
        saver.close()   # drain queued saves; re-raise writer errors
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    print("training done.", flush=True)
    return state


if __name__ == "__main__":
    main()
