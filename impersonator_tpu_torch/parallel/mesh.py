"""Device meshes and the placement of trees on them (torch port of
``impersonator_tpu/parallel/mesh.py``).

JAX's mesh is a ``jax.sharding.Mesh`` and XLA places a batch and
inserts the gradient all-reduce from its shardings. Here a :class:`Mesh`
is an array of ``torch.device``s with axis names, and placement is
explicit: :func:`shard_batch` gives each device its piece of a batch,
:func:`replicate_tree` gives each device its own copy of a tree (tensors,
modules, dataclasses of them, dicts, lists). The task or the trainer then
runs the same code on each piece; the gradient all-reduce of a train step
is ``parallel.distributed.all_reduce_mean_``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn


class Mesh:
    """Devices (a NumPy object array of ``torch.device``) and the name of
    each of its axes."""

    def __init__(self, devices: np.ndarray, axis_names):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError((self.devices.shape, self.axis_names))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> dict:
        """{axis name: its length}, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device_list(self) -> list:
        """The devices in the mesh's (row-major) order."""
        return list(self.devices.flat)

    def __repr__(self):
        return f"Mesh({self.shape}, {self.device_list})"


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tree goes on ``mesh``: its leading axis split along the
    mesh axis ``axis``, or a whole copy on every device (``axis`` None)."""

    mesh: Mesh
    axis: Optional[str] = None


def visible_devices(device_type: str = "cuda") -> list:
    """Every visible card, each once, for ``"cuda"``; the CPU alone for
    ``"cpu"``. Raises when there is no card."""
    if device_type == "cpu":
        return [torch.device("cpu")]
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is visible")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(shape=(-1,), axes=("data",), devices=None) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (default: every visible card,
    each once); a -1 entry takes the devices the others leave. A list in
    which a device repeats (``["cpu"] * 8``, the one card twice) is a test
    seam only: it runs the multi-device code paths where there is one
    device, and measures no scaling."""
    devices = [torch.device(d) for d in (devices if devices is not None
                                         else visible_devices())]
    shape = list(shape)
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1])) or 1
        shape[shape.index(-1)] = len(devices) // known
    n = int(np.prod(shape))
    if not 0 < n <= len(devices):
        raise ValueError(f"mesh {shape} over {len(devices)} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(shape), axes)


def make_data_mesh(batch_size: int, devices=None) -> Mesh:
    """A 1-D ``data`` mesh of the most devices that divide the batch."""
    devices = list(devices) if devices is not None else visible_devices()
    n = len(devices)
    while n > 1 and batch_size % n:
        n -= 1
    return make_mesh((n,), ("data",), devices[:n])


def data_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """The leading (batch / frame) axis split along ``axis``."""
    return Sharding(mesh, axis)


def replicate(mesh: Mesh) -> Sharding:
    """A whole copy on every device."""
    return Sharding(mesh, None)


def data_devices(mesh: Mesh, axis: str = "data") -> list:
    """One device per index along ``axis``: the one at index 0 of every
    other axis, in order. A task that splits a batch along ``axis`` only
    runs each piece there (every device along the other axes would hold
    the same piece)."""
    ax = mesh.axis_names.index(axis)
    return list(np.moveaxis(mesh.devices, ax, 0).reshape(
        mesh.devices.shape[ax], -1)[:, 0])


def to_device(tree, device):
    """``tree`` on ``device``: tensors moved (no copy where one is
    already there), modules deep-copied and moved, dataclasses, dicts,
    lists and tuples rebuilt around their moved fields; anything else as
    it is."""
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, nn.Module):
        return copy.deepcopy(tree).to(device)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: to_device(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree


def _split(tree, n: int, i: int):
    """Piece i of n of every tensor's leading axis in ``tree``."""
    if torch.is_tensor(tree):
        if tree.shape[0] % n:
            raise ValueError(f"batch {tree.shape[0]} does not split into "
                             f"{n} equal pieces")
        per = tree.shape[0] // n
        return tree[i * per:(i + 1) * per]
    if isinstance(tree, dict):
        return {k: _split(v, n, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_split(v, n, i) for v in tree)
    return tree


def _put(tree, sharding: Sharding) -> list:
    """``tree`` placed by ``sharding``: one tree for each device of the
    mesh, in the mesh's order."""
    mesh = sharding.mesh
    if sharding.axis is None:
        return [to_device(tree, d) for d in mesh.device_list]
    ax = mesh.axis_names.index(sharding.axis)
    n = mesh.devices.shape[ax]
    return [to_device(_split(tree, n, idx[ax]), mesh.devices[idx])
            for idx in np.ndindex(mesh.devices.shape)]


def shard_batch(batch, mesh: Mesh, axis: str = "data") -> list:
    """The leading axis of every tensor of ``batch`` split evenly along
    ``axis``, one piece on each device, in order (devices that differ
    only along other axes hold the same piece)."""
    return _put(batch, data_sharding(mesh, axis))


def replicate_tree(tree, mesh: Mesh) -> list:
    """One copy of ``tree`` for each device of the mesh (see
    :func:`to_device`)."""
    return _put(tree, replicate(mesh))
