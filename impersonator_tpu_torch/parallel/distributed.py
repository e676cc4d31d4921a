"""Multi-process training on ``torch.distributed`` (torch port of
``impersonator_tpu/parallel/distributed.py``).

Every process calls :func:`init_distributed`, trains on its own device
on its own shard of each global batch (the loader's ``shard_index`` /
``shard_count``), and averages its gradients with the others' by
:func:`all_reduce_mean_` between the backward and the optimiser step —
the all-reduce that XLA inserts into JAX's sharded step. NCCL carries it
between cards, gloo on the CPU.

Usage (one process per card; the rendezvous at process 0's address)::

    python -m impersonator_tpu_torch.cli.train --coordinator 10.0.0.1:1234 \\
        --num_processes 4 --process_id $RANK ...

On one host with several cards, ``cli.train`` without these flags starts
one process per card itself.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from impersonator_tpu_torch.parallel.mesh import Mesh, make_mesh, to_device


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device="cuda") -> bool:
    """Join the process group of ``num_processes`` processes at
    ``coordinator`` (host:port of process 0) as ``process_id``, when
    ``coordinator`` is set or ``num_processes`` > 1; a process that trains
    on a card (``device`` of type cuda) then works on card ``process_id``
    mod the visible cards. The backend is NCCL on a card and gloo on the
    CPU unless ``backend`` names one. Idempotent. Returns whether a group
    of more than one process is active (JAX: ``process_count() > 1``)."""
    if not dist.is_initialized() and (coordinator
                                      or (num_processes or 0) > 1):
        if coordinator is None or num_processes is None \
                or process_id is None:
            raise ValueError("--coordinator, --num_processes and "
                             "--process_id go together")
        on_card = torch.device(device).type == "cuda"
        if on_card:
            torch.cuda.set_device(process_id % torch.cuda.device_count())
        dist.init_process_group(
            backend or ("nccl" if on_card else "gloo"),
            init_method=f"tcp://{coordinator}", world_size=num_processes,
            rank=process_id)
    return world_size() > 1


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(axes=("data",), shape=(-1,), device_type="cuda") -> Mesh:
    """The mesh of every process's device, which every process builds the
    same: process r's card is r mod the visible cards of its host (as
    :func:`init_distributed` sets it), or the CPU for ``device_type``
    "cpu"."""
    if device_type == "cuda":
        n = torch.cuda.device_count()
        devices = [torch.device("cuda", r % n) for r in range(world_size())]
    else:
        devices = [torch.device("cpu")] * world_size()
    return make_mesh(shape, axes, devices)


def global_shard_batch(batch, mesh: Mesh):
    """This process's shard of the global batch (the loader gives each
    process its own rows) on this process's device of ``mesh``. A world
    of one returns ``batch`` as it is."""
    if world_size() == 1:
        return batch
    return to_device(batch, mesh.device_list[rank()])


def process_local_slice(n_items: int) -> slice:
    """Which rows of a global dataset this process loads."""
    per = n_items // max(world_size(), 1)
    start = rank() * per
    return slice(start, start + per)


def all_reduce_mean_(tensors) -> None:
    """Replace each tensor by its mean over the process group, in place:
    one flattened bucket per (device, dtype), all-reduced by sum, then
    divided by the world size. Nothing happens without a process group."""
    if not dist.is_initialized():
        return
    n = dist.get_world_size()
    buckets = {}
    for t in tensors:
        buckets.setdefault((t.device, t.dtype), []).append(t)
    for group in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat.div_(n)
        for t, v in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(v.view_as(t))
