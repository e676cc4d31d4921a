"""Checkpoints of the trainer, with the reference's naming contract
(torch port of ``impersonator_tpu/utils/checkpoint.py:20-159``).

Each epoch saves ``net_epoch_{E}_id_{G|D}.pth`` (a module's state dict)
and ``opt_epoch_{E}_id_{G|D}.pth`` (its optimiser's), as the reference's
``BaseModel._save_network`` / ``_save_optimizer`` did, through a tmp file
and a rename so that a crash never leaves a truncated file for
``resolve_load_epoch`` to resume from (:func:`latest_epoch` takes only an
epoch whose four files all exist). :class:`AsyncCheckpointer` writes
them on a background thread.

:func:`read_flax_msgpack` decodes the files the JAX package writes
(``flax.serialization.to_bytes``: its checkpoints, and its generator,
discriminator, face-net and VGG param files) into nested dicts of numpy
arrays, for ``utils.convert``'s ``*_state_dict_from_jax``;
:func:`write_flax_msgpack` writes such files, byte for byte what
``flax.serialization.to_bytes`` writes for the same tree (for
``utils.convert``'s ``*_to_jax`` trees, so a host without flax makes the
JAX package's weight files). Neither needs flax or the msgpack package.
"""

from __future__ import annotations

import os
import queue
import re
import struct
import threading

import numpy as np
import torch


def _path(expr_dir: str, kind: str, epoch, label: str) -> str:
    return os.path.join(expr_dir, f"{kind}_epoch_{epoch}_id_{label}.pth")


def _save_atomic(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _load(path: str, what: str, device=None):
    if not os.path.exists(path):
        raise FileNotFoundError(f"{what} not found: {path}")
    return torch.load(path, map_location=device, weights_only=True)


def _device_of(module):
    return next(module.parameters()).device


def save_network(module, expr_dir: str, label: str, epoch) -> str:
    """``net_epoch_{epoch}_id_{label}.pth``: the state dict of a module
    (or a state dict)."""
    os.makedirs(expr_dir, exist_ok=True)
    path = _path(expr_dir, "net", epoch, label)
    sd = module.state_dict() if hasattr(module, "state_dict") else module
    _save_atomic(sd, path)
    return path


def load_network(module, expr_dir: str, label: str, epoch):
    """Load ``net_epoch_{epoch}_id_{label}.pth`` into ``module`` (in
    place, strict) and return it."""
    path = _path(expr_dir, "net", epoch, label)
    module.load_state_dict(_load(path, "checkpoint", _device_of(module)))
    return module


def save_optimizer(optimizer, expr_dir: str, label: str, epoch) -> str:
    os.makedirs(expr_dir, exist_ok=True)
    path = _path(expr_dir, "opt", epoch, label)
    sd = (optimizer.state_dict() if hasattr(optimizer, "state_dict")
          else optimizer)
    _save_atomic(sd, path)
    return path


def load_optimizer(optimizer, expr_dir: str, label: str, epoch):
    path = _path(expr_dir, "opt", epoch, label)
    optimizer.load_state_dict(_load(path, "optimizer checkpoint"))
    return optimizer


def latest_epoch(expr_dir: str) -> int:
    """The newest epoch whose four files (``{net|opt}_epoch_{E}_id_{G|D}
    .pth``) are all in expr_dir; 0 when there is none. A leftover
    ``.pth.tmp`` or an epoch a crash left without all four does not
    count, so resume falls back to the last complete epoch."""
    if not os.path.isdir(expr_dir):
        return 0
    names = set(os.listdir(expr_dir))
    pat = re.compile(r"net_epoch_(\d+)_id_G\.pth$")
    epochs = [int(m.group(1)) for m in map(pat.match, names) if m]
    return max((e for e in epochs
                if all(os.path.basename(_path("", k, e, label)) in names
                       for k in ("net", "opt") for label in "GD")),
               default=0)


def save_train_state(state, expr_dir: str, epoch) -> None:
    """The four files of a TrainState (or of a snapshot of its state
    dicts, as :class:`AsyncCheckpointer` takes)."""
    save_network(state.generator, expr_dir, "G", epoch)
    save_network(state.discriminator, expr_dir, "D", epoch)
    save_optimizer(state.g_opt, expr_dir, "G", epoch)
    save_optimizer(state.d_opt, expr_dir, "D", epoch)


def load_train_state(state, expr_dir: str, epoch):
    """Restore the nets and optimisers of ``state`` in place."""
    load_network(state.generator, expr_dir, "G", epoch)
    load_network(state.discriminator, expr_dir, "D", epoch)
    load_optimizer(state.g_opt, expr_dir, "G", epoch)
    load_optimizer(state.d_opt, expr_dir, "D", epoch)
    return state


def _map_tensors(obj, fn):
    if torch.is_tensor(obj):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj


class _Snapshot:
    """The four state dicts of a TrainState at one moment."""

    def __init__(self, state):
        def clone(sd):
            return _map_tensors(sd, lambda t: t.detach().clone())
        self.generator = clone(state.generator.state_dict())
        self.discriminator = clone(state.discriminator.state_dict())
        self.g_opt = clone(state.g_opt.state_dict())
        self.d_opt = clone(state.d_opt.state_dict())

    def to_cpu(self):
        for k in ("generator", "discriminator", "g_opt", "d_opt"):
            setattr(self, k, _map_tensors(getattr(self, k),
                                          lambda t: t.cpu()))
        return self


class AsyncCheckpointer:
    """Background-thread checkpoint writer. :meth:`submit` snapshots the
    state's tensors where they lie (a device copy, ordered on the current
    stream after the step that made them), so the next steps may update
    the nets in place; the thread copies the snapshot to the host and
    writes it. A save for the same (expr_dir, epoch) supersedes a queued
    one. Call :meth:`wait` before reading the files, :meth:`close` before
    exiting."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._err = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            snap, expr_dir, epoch = item
            try:
                save_train_state(snap.to_cpu(), expr_dir, epoch)
            except Exception as e:  # surfaced on the next wait()
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, state, expr_dir: str, epoch) -> None:
        snap = _Snapshot(state)
        pending = []
        try:
            while True:
                it = self._q.get_nowait()
                self._q.task_done()
                if it is not None and (it[1], it[2]) == (expr_dir, epoch):
                    continue
                pending.append(it)
        except queue.Empty:
            pass
        for it in pending:
            self._q.put(it)
        self._q.put((snap, expr_dir, epoch))

    def wait(self) -> None:
        """Block until every queued save is on disk; re-raise the first
        writer error."""
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._thread.join(timeout=30)


# --------------------------------------------------------------------------
# flax msgpack files
# --------------------------------------------------------------------------

# flax.serialization's ext type codes
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    """A decoder of the msgpack subset flax.serialization writes: maps,
    arrays, str, bin, ints, floats, nil, bool, and its ext types
    (ndarray, numpy scalar, complex)."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: "B", 0xC5: "H", 0xC6: "I"}            # bin
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        ext = {0xC7: "B", 0xC8: "H", 0xC9: "I"}
        if b in ext:
            n = self.unpack(ext[b])
            return self.ext(self.unpack("b"), n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(self.unpack("b"), fixext[b])
        nums = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in nums:
            return self.unpack(nums[b])
        strs = {0xD9: "B", 0xDA: "H", 0xDB: "I"}
        if b in strs:
            return str(self.take(self.unpack(strs[b])), "utf-8")
        if b in (0xDC, 0xDD):
            return [self.read()
                    for _ in range(self.unpack("H" if b == 0xDC else "I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack("H" if b == 0xDE else "I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code == _EXT_COMPLEX:
            re_, im = _Reader(payload).read()
            return complex(re_, im)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, buf = _Reader(payload).read()
        if dtype == "bfloat16":      # numpy has no bfloat16: widen
            bits = np.frombuffer(buf, "<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        else:
            arr = np.frombuffer(buf, np.dtype(dtype))
        arr = arr.reshape(shape).copy()
        return arr[()] if code == _EXT_NPSCALAR else arr


def _unchunk(tree):
    """flax splits arrays over 1 GiB into {'__msgpack_chunked_array__',
    'shape', 'chunks'} dicts; join them back."""
    if not isinstance(tree, dict):
        return tree
    if tree.get("__msgpack_chunked_array__"):
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_flax_msgpack(path: str):
    """The tree a ``flax.serialization.to_bytes`` file holds, as
    ``flax.serialization.msgpack_restore`` returns it: nested dicts (str
    keys; tuples and NamedTuples as dicts keyed '0', '1', … or by field
    name) of numpy arrays and Python scalars. bfloat16 arrays come back
    float32."""
    with open(path, "rb") as f:
        data = f.read()
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(data):
        raise ValueError(f"{path}: trailing bytes after the msgpack object")
    return _unchunk(tree)


class _Array:
    """An array leaf as flax packs it: shape, numpy dtype name, C-order
    bytes."""

    def __init__(self, shape, dtype: str, data: bytes, itemsize: int):
        self.shape, self.dtype, self.data = tuple(shape), dtype, data
        self.itemsize = itemsize


def _array(x) -> _Array:
    """A numpy array or torch tensor as an :class:`_Array`; torch's
    bfloat16 goes by its bits under the name ``bfloat16``, the name
    ml_dtypes gives numpy's."""
    if torch.is_tensor(x):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return _Array(x.shape, "bfloat16",
                          x.view(torch.int16).numpy().tobytes(), 2)
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be written")
    return _Array(x.shape, x.dtype.name, x.tobytes("C"), x.dtype.itemsize)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _state(x, max_chunk: int):
    """flax's ``to_state_dict`` (dicts, lists and tuples as str-keyed maps
    in their own order, NamedTuples by field) followed by its
    ``_chunk_array_leaves_in_place``: an array of more than ``max_chunk``
    bytes becomes a ``__msgpack_chunked_array__`` map."""
    if _is_namedtuple(x):
        return {k: _state(getattr(x, k), max_chunk) for k in x._fields}
    if isinstance(x, (list, tuple)):
        return {str(i): _state(v, max_chunk) for i, v in enumerate(x)}
    if isinstance(x, dict):
        out = {str(k): _state(v, max_chunk) for k, v in x.items()}
        if len(out) != len(x):
            raise ValueError("dict keys must have unique str forms")
        return out
    if isinstance(x, np.ndarray) or torch.is_tensor(x):
        arr = _array(x)
        if len(arr.data) > max_chunk:
            return _chunk(arr, max_chunk)
        return arr
    return x


def _chunk(arr: _Array, max_chunk: int) -> dict:
    """flax's ``_chunk``: the flat array in pieces of max_chunk bytes."""
    step = max(1, int(max_chunk / arr.itemsize)) * arr.itemsize
    pieces = [arr.data[i:i + step] for i in range(0, len(arr.data), step)]
    return {"__msgpack_chunked_array__": True,
            "shape": {str(i): n for i, n in enumerate(arr.shape)},
            "chunks": {str(i): _Array((len(b) // arr.itemsize,), arr.dtype,
                                      b, arr.itemsize)
                       for i, b in enumerate(pieces)}}


class _Writer:
    """msgpack-python's packer (``use_bin_type=True``, doubles for
    floats, ``strict_types``) for the leaves a flax state dict holds,
    with flax's ext types for arrays, numpy scalars and complex."""

    def __init__(self):
        self.out = []

    def head(self, n: int, fix: int, fix_max: int, codes) -> None:
        if n <= fix_max:
            self.out.append(bytes([fix | n]))
        elif codes[0] is not None and n <= 0xFF:
            self.out.append(struct.pack(">BB", codes[0], n))
        elif n <= 0xFFFF:
            self.out.append(struct.pack(">BH", codes[1], n))
        else:
            self.out.append(struct.pack(">BI", codes[2], n))

    def int_(self, n: int) -> None:
        if 0 <= n < 0x80 or -0x20 <= n < 0:
            self.out.append(struct.pack("b" if n < 0 else "B", n))
            return
        for lo, hi, code, fmt in ((0x80, 0xFF, 0xCC, "B"),
                                  (-0x80, -1, 0xD0, "b"),
                                  (0x100, 0xFFFF, 0xCD, "H"),
                                  (-0x8000, -0x81, 0xD1, "h"),
                                  (0x10000, 0xFFFFFFFF, 0xCE, "I"),
                                  (-0x80000000, -0x8001, 0xD2, "i"),
                                  (1 << 32, (1 << 64) - 1, 0xCF, "Q"),
                                  (-(1 << 63), -0x80000001, 0xD3, "q")):
            if lo <= n <= hi:
                self.out.append(struct.pack(">B" + fmt, code, n))
                return
        raise OverflowError(f"integer {n} out of msgpack's range")

    def ext(self, code: int, data: bytes) -> None:
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        n = len(data)
        if n in fixed:
            self.out.append(bytes([fixed[n]]))
        elif n <= 0xFF:
            self.out.append(struct.pack(">BB", 0xC7, n))
        elif n <= 0xFFFF:
            self.out.append(struct.pack(">BH", 0xC8, n))
        else:
            self.out.append(struct.pack(">BI", 0xC9, n))
        self.out.append(struct.pack("b", code) + data)

    def pack(self, x) -> None:
        t = type(x)
        if x is None:
            self.out.append(b"\xc0")
        elif t is bool:
            self.out.append(b"\xc3" if x else b"\xc2")
        elif t is int:
            self.int_(x)
        elif t in (bytes, bytearray):
            self.head(len(x), 0, -1, (0xC4, 0xC5, 0xC6))
            self.out.append(bytes(x))
        elif t is str:
            b = x.encode("utf-8")
            self.head(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
            self.out.append(b)
        elif t is float:
            self.out.append(struct.pack(">Bd", 0xCB, x))
        elif t in (list, tuple):     # only inside an array's header
            self.head(len(x), 0x90, 15, (None, 0xDC, 0xDD))
            for v in x:
                self.pack(v)
        elif t is dict:
            self.head(len(x), 0x80, 15, (None, 0xDE, 0xDF))
            for k, v in x.items():
                self.pack(k)
                self.pack(v)
        elif t is _Array:
            self.ext(_EXT_NDARRAY, _packed(x))
        elif isinstance(x, np.generic):
            self.ext(_EXT_NPSCALAR, _packed(_array(np.asarray(x))))
        elif t is complex:
            self.ext(_EXT_COMPLEX, _packed_list([x.real, x.imag]))
        else:
            raise TypeError(f"cannot write {t.__name__} to a flax msgpack")


def _packed_list(items) -> bytes:
    w = _Writer()
    w.pack(list(items))
    return b"".join(w.out)


def _packed(arr: _Array) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack of (shape, dtype name,
    bytes)."""
    w = _Writer()
    w.pack([tuple(int(n) for n in arr.shape), arr.dtype, arr.data])
    return b"".join(w.out)


def flax_msgpack_bytes(tree, max_chunk_size: int = 1 << 30) -> bytes:
    """The bytes ``flax.serialization.to_bytes(tree)`` gives for a tree of
    dicts, lists, tuples and NamedTuples over numpy arrays, torch tensors
    (bfloat16 included), numpy scalars, Python scalars, str, bytes and
    None. ``max_chunk_size`` is flax's ``MAX_CHUNK_SIZE``."""
    w = _Writer()
    w.pack(_state(tree, max_chunk_size))
    return b"".join(w.out)


def write_flax_msgpack(tree, path: str, max_chunk_size: int = 1 << 30) -> str:
    """Write :func:`flax_msgpack_bytes` of ``tree`` to ``path``, the
    inverse of :func:`read_flax_msgpack`."""
    data = flax_msgpack_bytes(tree, max_chunk_size)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return path
