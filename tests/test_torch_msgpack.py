"""The port's flax msgpack writer (``utils.checkpoint.write_flax_msgpack``)
against ``flax.serialization.to_bytes`` on the CPU: the same bytes,
exactly, for seeded trees of float32, bfloat16 (numpy through ml_dtypes,
and torch), int and bool arrays, numpy and Python scalars of every width
msgpack distinguishes, str, None, complex, lists, tuples, NamedTuples,
nested and empty maps and keys of every string length class, and an array
chunked under a lowered ``MAX_CHUNK_SIZE`` (patched in flax for the test
and passed to the writer); then each file read back by the port's
``read_flax_msgpack`` equal to ``flax.serialization.msgpack_restore``'s
tree."""

import collections

import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization

from impersonator_tpu_torch.utils.checkpoint import (flax_msgpack_bytes,
                                                     read_flax_msgpack,
                                                     write_flax_msgpack)
from torch_threads import one_torch_thread  # noqa: F401

Pair = collections.namedtuple("Pair", "mu nu")


def _trees():
    rng = np.random.default_rng(61)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    bf = f32(6, 5)
    return {
        "conv_tree": ({"params": {"conv": {"kernel": f32(3, 3, 4, 8),
                                           "bias": f32(8)},
                                  "dense": {"kernel": f32(40, 3)}},
                       "batch_stats": {"bn": {"mean": f32(8),
                                              "var": f32(8) ** 2}}},) * 2,
        "bfloat16": ({"w": bf.astype(ml_dtypes.bfloat16)},
                     {"w": torch.from_numpy(bf).to(torch.bfloat16)}),
        "ints_and_scalars": ({
            "i32": np.arange(-5, 300, dtype=np.int32),
            "u8": np.arange(7, dtype=np.uint8), "b": np.array([True, False]),
            "f64": rng.standard_normal(4), "empty": np.zeros((0, 3),
                                                            np.float32),
            "np_f32": np.float32(1.5), "np_i64": np.int64(-9),
            "np_bool": np.bool_(True), "zero_d": np.array(2.5, np.float32),
            **{f"int{i}": v for i, v in enumerate(
                (0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
                 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
                 -2 ** 31, -2 ** 31 - 1, -2 ** 63))},
            "float": 0.1, "neg_float": -3.0, "true": True, "false": False,
            "none": None, "text": "bfloat16", "complex": 1.5 - 2j,
            "raw": b"\x00\x01\x02"},) * 2,
        "containers": ({
            "list": [f32(2), 3, {"x": f32(1)}], "tuple": (1, (2, 3)),
            "named": Pair(f32(3), np.int32(4)), "empty": {},
            "nested": {"a": {"b": {"c": {}}}},
            "k" * 31: 1, "k" * 32: 2, "k" * 255: 3, "k" * 256: 4,
            "k" * 70000: 5, 7: "int key",
            "wide": {str(i): i for i in range(20)},
            "wider": {str(i): f32(1) for i in range(70000)}},) * 2,
    }


@pytest.mark.parametrize("name", ["conv_tree", "bfloat16",
                                  "ints_and_scalars", "containers",
                                  "chunked"])
def test_write_flax_msgpack_matches_flax(name, tmp_path, monkeypatch):
    """Exact bytes, then the round trip through the port's reader."""
    if name == "chunked":
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
        rng = np.random.default_rng(62)
        w = rng.standard_normal((7, 9)).astype(np.float32)   # 252 bytes
        tree_flax = {"params": {"w": w, "small": w[0, :4].copy()},
                     "bf": w.astype(ml_dtypes.bfloat16)}
        tree_port = {"params": {"w": torch.from_numpy(w),
                                "small": w[0, :4].copy()},
                     "bf": torch.from_numpy(w).to(torch.bfloat16)}
        chunk = 64
    else:
        tree_flax, tree_port = _trees()[name]
        chunk = 1 << 30
    want = serialization.to_bytes(tree_flax)
    assert flax_msgpack_bytes(tree_port, chunk) == want
    path = write_flax_msgpack(tree_port, str(tmp_path / "t.msgpack"), chunk)
    assert open(path, "rb").read() == want
    if name == "chunked":
        assert b"__msgpack_chunked_array__" in want
    got = read_flax_msgpack(path)
    ref = serialization.msgpack_restore(want)

    def same(a, b):
        if isinstance(b, dict):
            assert isinstance(a, dict) and list(a) == list(b)
            for k in b:
                same(a[k], b[k])
        elif isinstance(b, np.ndarray) or isinstance(b, np.generic):
            b = np.asarray(b)
            if b.dtype == ml_dtypes.bfloat16:      # the reader widens
                b = b.astype(np.float32)
            assert np.asarray(a).dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), b)
        else:
            assert type(a) is type(b) and a == b, (a, b)

    same(got, ref)
