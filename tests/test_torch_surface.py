"""The rest of the JAX package's public surface in the port, against the
JAX package on the same numpy inputs: the neural renderer's camera
helpers (as tests/test_aux.py:409-445 holds JAX's), the swapper's masked
identity flow, the Liquid Warping Block's feature warp; and every name
the JAX package's ``__init__``s export, which the port's export too, each
resolving to the port's own object."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impersonator_tpu.ops import flow as jflow
from impersonator_tpu.ops import projection as jproj
from impersonator_tpu.ops import sampler as jsampler
from impersonator_tpu_torch.ops import flow as tflow
from impersonator_tpu_torch.ops import projection as tproj
from impersonator_tpu_torch.ops import sampler as tsampler

from torch_threads import one_torch_thread  # noqa: F401


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_look_at_and_look_match_jax():
    """look_at for a general eye and target, look with the direction
    (at - eye) equal to it (look.py / look_at.py), both against JAX."""
    rng = np.random.default_rng(0)
    v = rng.uniform(-1, 1, (2, 5, 3)).astype(np.float32)
    eye, at = (0.3, -0.2, -2.0), (0.1, 0.4, 0.5)
    direction = tuple(a - e for a, e in zip(at, eye))
    got = tproj.look_at(_t(v), eye, at)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jproj.look_at(jnp.asarray(v), eye,
                                                        at)), atol=1e-6)
    np.testing.assert_allclose(
        tproj.look(_t(v), eye, direction).numpy(),
        np.asarray(jproj.look(jnp.asarray(v), eye, direction)), atol=1e-6)
    np.testing.assert_allclose(tproj.look(_t(v), eye, direction).numpy(),
                               got.numpy(), atol=1e-5)
    # the renderer's on-axis eye: a pure z translation
    np.testing.assert_allclose(
        tproj.look_at(_t(v), (0.0, 0.0, -tproj.DEFAULT_EYE_Z)).numpy(),
        tproj.look_at_on_axis(_t(v)).numpy(), atol=1e-6)


def test_perspective_and_points_from_angles_match_jax():
    rng = np.random.default_rng(1)
    vp = rng.uniform(0.5, 2.0, (1, 4, 3)).astype(np.float32)
    for angle in (30.0, 15.0):
        np.testing.assert_allclose(
            tproj.perspective(_t(vp), angle=angle).numpy(),
            np.asarray(jproj.perspective(jnp.asarray(vp), angle=angle)),
            rtol=1e-6)
    for args in ((2.0, 0.0, 0.0), (2.0, 90.0, 0.0), (1.5, 30.0, -45.0),
                 (np.full(3, 2.0), np.zeros(3), [0.0, 90.0, 180.0])):
        got = tproj.get_points_from_angles(*args)
        want = np.asarray(jproj.get_points_from_angles(
            *(jnp.asarray(a, jnp.float32) for a in args)))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    rad = tproj.get_points_from_angles(2.0, np.pi / 2, 0.0, degrees=False)
    np.testing.assert_allclose(rad.numpy(), [0.0, 2.0, 0.0], atol=1e-6)


def test_masked_identity_and_swap_flows_match_jax():
    rng = np.random.default_rng(2)
    s = 16
    mask = (rng.uniform(size=(2, s, s)) > 0.5).astype(np.float32)
    t21 = rng.uniform(-1, 1, (2, s, s, 2)).astype(np.float32)
    grid = tflow.identity_flow(2, s)
    t11, t21_t = tflow.masked_identity_and_swap_flows(_t(mask), _t(t21),
                                                      grid)
    j11, j21 = jflow.masked_identity_and_swap_flows(
        jnp.asarray(mask), jnp.asarray(t21), jnp.asarray(grid.numpy()))
    np.testing.assert_array_equal(t11.numpy(), np.asarray(j11))
    np.testing.assert_array_equal(t21_t.numpy(), np.asarray(j21))
    assert (t11.numpy()[mask == 0] == tflow.BG_FLOW).all()


@pytest.mark.parametrize("hw", [(16, 16), (8, 8), (32, 32)])
def test_warp_feature_matches_jax(hw):
    """A feature map at 16² warped by a 32² flow resized to its size
    (down, equal, up), some of the flow on the background."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, *hw, 5)).astype(np.float32)
    t = rng.uniform(-1.1, 1.1, (2, 16, 16, 2)).astype(np.float32)
    t[:, :3] = tflow.BG_FLOW
    got = tsampler.warp_feature(_t(x), _t(t))
    want = np.asarray(jsampler.warp_feature(jnp.asarray(x), jnp.asarray(t)))
    assert got.shape == want.shape == (2, *hw, 5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


PACKAGES = ["ops", "models", "tasks", "data", "parallel", "metrics"]


def _exports(pkg: str):
    """The public names of the JAX package's ``pkg/__init__.py``."""
    mod = importlib.import_module(f"impersonator_tpu.{pkg}")
    return sorted(n for n in vars(mod)
                  if not n.startswith("_")
                  and not isinstance(getattr(mod, n), type(importlib))
                  and n not in ("annotations",))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_exports_match_jax(pkg):
    """Every name JAX's package exports, the port's exports, and it is
    the port's own object (defined in a port module); the lazy exports
    are listed in __all__ and unknown names raise AttributeError."""
    port = importlib.import_module(f"impersonator_tpu_torch.{pkg}")
    names = _exports(pkg)
    assert names, pkg
    for name in names:
        obj = getattr(port, name)
        home = getattr(obj, "__module__", None)
        if home is not None:
            assert home.startswith("impersonator_tpu_torch."), (name, home)
        if hasattr(port, "__all__"):
            assert name in port.__all__, name
    with pytest.raises(AttributeError):
        getattr(port, "no_such_name")
