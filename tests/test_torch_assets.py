"""The port's own copies of the JAX package's framework-free modules:
``impersonator_tpu_torch.assets`` builds the same arrays as
``impersonator_tpu.assets``, and ``impersonator_tpu_torch.config``'s
TestConfig has the same defaults."""

import dataclasses

import numpy as np
import pytest

from impersonator_tpu import assets as jassets
from impersonator_tpu import config as jconfig
from impersonator_tpu_torch import assets as tassets
from impersonator_tpu_torch import config as tconfig


def _assert_assets_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, dict):
            assert sorted(x) == sorted(y), f.name
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
        else:
            assert np.asarray(x).dtype == np.asarray(y).dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
    for name in ("uv_seg", "par", "front", "head", "back"):
        np.testing.assert_array_equal(a.map_fn(name), b.map_fn(name))


@pytest.mark.parametrize("build", ["synthetic", "bench"])
def test_assets_equal_jax(build):
    if build == "synthetic":
        pair = jassets.synthetic_assets(), tassets.synthetic_assets()
    else:
        pair = jassets.bench_assets(), tassets.bench_assets()
    _assert_assets_equal(*pair)
    assert tassets.NUM_JOINTS == jassets.NUM_JOINTS


def test_test_config_defaults_equal_jax():
    t, j = tconfig.TestConfig(), jconfig.TestConfig()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.parse_view_params() == j.parse_view_params()
    _assert_assets_equal(t.assets(), j.assets())
