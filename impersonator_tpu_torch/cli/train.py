"""Training entry point of the port, one process per device (torch port
of ``impersonator_tpu/cli/train.py:30-214``).

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
when there is no card), and ``--coordinator`` (host:port of process 0),
``--num_processes`` and ``--process_id`` for one process of a
multi-process run (``parallel.distributed``; NCCL between cards, gloo on
the CPU). Each process trains on its own shard of every global batch of
``--batch_size`` (``batch_size / num_processes`` rows), the gradients
averaged over the processes every step; only process 0 saves the
options, prints, writes visuals and checkpoints, and every process loads
a resume. The display and validation cadence is then
``display_freq_steps``: a wall-clock trigger would put the processes'
collectives out of step.

On one host with more than one card and none of those three flags, the
run starts one process per card itself, over the cards that
``make_data_mesh(batch_size)`` picks (or ``--mesh_shape`` /
``--mesh_axes``: processes that differ only along a non-``data`` axis
train on the same shard, as JAX replicates the batch over such an axis).
With one card it is one process.

    python -m impersonator_tpu_torch.cli.train --dataset_mode synthetic \\
        --device cpu --coordinator 127.0.0.1:29500 --num_processes 2 \\
        --process_id 0   # and --process_id 1 in a second process
"""

from __future__ import annotations

import argparse
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from impersonator_tpu_torch.config import TrainConfig, from_args
from impersonator_tpu_torch.data.datasets import dataset_by_name
from impersonator_tpu_torch.data.loader import DataLoader
from impersonator_tpu_torch.parallel import distributed as pdist
from impersonator_tpu_torch.parallel.mesh import make_data_mesh, make_mesh
from impersonator_tpu_torch.tasks import trainer as trainer_mod
from impersonator_tpu_torch.tasks import trainer_aug as aug_mod
from impersonator_tpu_torch.tasks import trainer_baseline as base_mod
from impersonator_tpu_torch.utils import checkpoint as ckpt
from impersonator_tpu_torch.utils.visualizer import Visualizer


def _parse_extra(argv):
    parser = argparse.ArgumentParser(allow_abbrev=False)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of process 0 for multi-process runs")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
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
    """Mean eval-mode losses over the first n_iters validation batches;
    under a process group, averaged over the processes too (each holds
    as many batches of its own shard)."""
    sums, n = {}, 0
    for val_batch in val_loader:
        if n >= n_iters:
            break
        for k, v in eval_fn(state, val_batch).items():
            sums[k] = sums.get(k, 0.0) + float(v)
        n += 1
    out = {k: v / n for k, v in sums.items()} if n else {}
    if out and dist.is_initialized():
        names = sorted(out)
        values = torch.tensor([out[k] for k in names], dtype=torch.float64,
                              device=next(iter(state.generator.parameters()
                                               )).device)
        pdist.all_reduce_mean_([values])
        out = dict(zip(names, values.tolist()))
    return out


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def local_mesh(cfg):
    """The devices a run without the multi-process flags trains on: the
    cards that divide the batch (``make_data_mesh``), or ``mesh_shape`` /
    ``mesh_axes`` over the visible cards."""
    if tuple(cfg.mesh_shape) == (-1,):
        return make_data_mesh(cfg.batch_size)
    return make_mesh(cfg.mesh_shape, cfg.mesh_axes)


def spawn_local(argv, mesh) -> None:
    """One training process per device of ``mesh`` on this host
    (``torch.multiprocessing.spawn``, the rendezvous on a free local
    port): process r trains on device r of the mesh, on the data shard of
    its ``data`` coordinate."""
    torch.multiprocessing.spawn(_local_worker,
                                args=(list(argv), mesh, _free_port()),
                                nprocs=mesh.size, join=True)


def _local_worker(rank, argv, mesh, port):
    device = mesh.device_list[rank]
    pdist.init_distributed(f"127.0.0.1:{port}", mesh.size, rank,
                           device=device)
    ax = mesh.axis_names.index("data")
    idx = np.unravel_index(rank, mesh.devices.shape)
    try:
        train(from_args(TrainConfig, argv), device,
              (int(idx[ax]), mesh.devices.shape[ax]))
    finally:
        dist.destroy_process_group()


def main(argv=None):
    extra = _parse_extra(argv)
    cfg = from_args(TrainConfig, argv)
    flags = (extra.coordinator, extra.num_processes, extra.process_id)
    device = torch.device(extra.device)
    if all(f is None for f in flags):
        if device.type == "cuda" and torch.cuda.device_count() > 1:
            mesh = local_mesh(cfg)
            if mesh.size > 1:
                spawn_local(sys.argv[1:] if argv is None else argv, mesh)
                return None
        return train(cfg, device)
    pdist.init_distributed(extra.coordinator, extra.num_processes,
                           extra.process_id, device=device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    try:
        return train(cfg, device, (pdist.rank(), pdist.world_size()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def train(cfg, device, shard=(0, 1)):
    """The epoch loop of ``cfg`` on ``device``, on data shard
    ``shard = (index, count)`` of each global batch. Returns the last
    train state."""
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
    multiprocess = pdist.world_size() > 1
    is_chief = pdist.rank() == 0
    shard_index, shard_count = shard
    if cfg.batch_size % shard_count:
        raise ValueError(f"--batch_size {cfg.batch_size} does not split "
                         f"into {shard_count} equal shards")
    local_bs = cfg.batch_size // shard_count
    if is_chief:
        cfg.save("train")
    trainer = build(cfg, device=device)
    state = trainer.init_state()

    name = _dataset_name(cfg)
    loader = DataLoader(dataset_by_name(name, cfg, device=trainer.device),
                        local_bs, num_workers=cfg.n_threads,
                        seed=cfg.seed, device=trainer.device,
                        shard_index=shard_index, shard_count=shard_count)
    vis = Visualizer(cfg.expr_dir()) if is_chief else None
    step_fn = make_step(trainer, train_d=True)
    step_g_only = make_step(trainer, train_d=False)
    visuals_fn = eval_fn = val_loader = None
    if cfg.model == "impersonator_trainer":
        val_loader = DataLoader(
            dataset_by_name(name, cfg, ids_file=cfg.test_ids_file,
                            device=trainer.device),
            local_bs, num_workers=1, seed=cfg.seed + 1,
            device=trainer.device, shard_index=shard_index,
            shard_count=shard_count)
        visuals_fn = trainer_mod.make_visuals_fn(trainer)
        eval_fn = trainer_mod.make_train_step(trainer, eval_only=True)

    start_epoch = cfg.resolve_load_epoch()
    if start_epoch > 0:
        state = ckpt.load_train_state(state, cfg.expr_dir(), start_epoch)
        if is_chief:
            print(f"resumed from epoch {start_epoch}", flush=True)

    total_epochs = cfg.nepochs_no_decay + cfg.nepochs_decay
    i_step = 0
    last_print = last_save = last_display = time.time()
    saver = ckpt.AsyncCheckpointer() if is_chief else None
    try:
        for epoch in range(start_epoch, total_epochs):
            state = trainer.set_lr(state, trainer.epoch_lr(epoch),
                                   trainer.epoch_lr(epoch, base=cfg.lr_D))
            for batch in loader:
                train_d = i_step % cfg.train_G_every_n_iterations == 0
                t0 = time.perf_counter()
                state, metrics = (step_fn if train_d else step_g_only)(
                    state, batch)
                if is_chief and time.time() - last_print > cfg.print_freq_s:
                    errors = {k: float(v) for k, v in metrics.items()}
                    dt = time.perf_counter() - t0   # float() synchronised
                    vis.print_current_errors(epoch, i_step, errors,
                                             dt / cfg.batch_size)
                    vis.log_scalars(i_step, epoch, errors)
                    last_print = time.time()
                # every process runs validation at the same step: its
                # losses are averaged over the processes
                if multiprocess:
                    do_display = i_step > 0 and (
                        i_step % max(cfg.display_freq_steps, 1) == 0)
                else:
                    do_display = (time.time() - last_display
                                  > cfg.display_freq_s)
                if visuals_fn is not None and do_display:
                    if is_chief:
                        vis.save_images(i_step, visuals_fn(state, batch))
                    val_errors = _validate(eval_fn, state, val_loader,
                                           cfg.num_iters_validate)
                    if val_errors and is_chief:
                        vis.print_current_errors(epoch, i_step, val_errors,
                                                 0.0)
                        vis.log_scalars(i_step, epoch, val_errors,
                                        phase="val")
                    last_display = time.time()
                if is_chief and \
                        time.time() - last_save > cfg.save_latest_freq_s:
                    saver.submit(state, cfg.expr_dir(), "latest")
                    last_save = time.time()
                i_step += 1
            if is_chief:
                saver.submit(state, cfg.expr_dir(), epoch + 1)
                print(f"saved epoch {epoch + 1}", flush=True)
    finally:
        if saver is not None:
            saver.close()   # drain queued saves; re-raise writer errors
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    if is_chief:
        print("training done.", flush=True)
    return state


if __name__ == "__main__":
    main()
