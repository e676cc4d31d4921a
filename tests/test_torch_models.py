"""Port parity of the generator: the weight bridge round-trips the flax
tree exactly, and run_bg / encode_src / inference agree with the JAX
generator on the same weights and inputs (float32, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impersonator_tpu.models.generator import ImpersonatorGenerator as JGen
from impersonator_tpu_torch.models.generator import \
    ImpersonatorGenerator as TGen
from impersonator_tpu_torch.utils.convert import \
    generator_state_dict_from_jax
from tools import convert_weights as cw

import torch_ref
from torch_threads import one_torch_thread  # noqa: F401

S, CONV_DIM, REPEAT = 64, 8, 2


def _tree_equal(a, b, path=""):
    assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=f"{path}/{k}")


def test_weight_bridge_round_trips_flax_init():
    """flax-initialised params -> port state dict -> convert_generator is
    exactly the original tree, and the port module takes the state dict
    with every key present."""
    gen = JGen(bg_dim=4, src_dim=6, tsf_dim=6, conv_dim=CONV_DIM,
               repeat_num=REPEAT)
    z = jnp.zeros
    params = jax.jit(gen.init)(jax.random.PRNGKey(3), z((1, 16, 16, 4)),
                               z((1, 16, 16, 6)), z((1, 16, 16, 6)),
                               z((1, 16, 16, 2)))
    params = jax.tree_util.tree_map(np.asarray, params)
    sd = generator_state_dict_from_jax(params)
    port = TGen(conv_dim=CONV_DIM, repeat_num=REPEAT)
    port.load_state_dict(sd, strict=True)
    back = cw.convert_generator(port.state_dict(), repeat=REPEAT)
    _tree_equal(back, params)


@pytest.fixture(scope="module")
def both_generators():
    """Reference-layout random weights (std 0.1 convs, perturbed norms)
    loaded into both generators."""
    rng = np.random.default_rng(11)
    sd = {**torch_ref.make_bg_sd(rng, 4, CONV_DIM, REPEAT),
          **torch_ref.make_resunet_sd(rng, "src_model", 6, CONV_DIM, REPEAT),
          **torch_ref.make_resunet_sd(rng, "tsf_model", 6, CONV_DIM, REPEAT)}
    jgen = JGen(bg_dim=4, src_dim=6, tsf_dim=6, conv_dim=CONV_DIM,
                repeat_num=REPEAT)
    params = cw.convert_generator(sd, repeat=REPEAT)
    tgen = TGen(conv_dim=CONV_DIM, repeat_num=REPEAT).eval()
    tgen.load_state_dict(sd, strict=True)
    return jgen, params, tgen


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(x):
    return x.detach().numpy().transpose(0, 2, 3, 1)


def test_run_bg_matches_jax(both_generators):
    jgen, params, tgen = both_generators
    x = np.random.default_rng(0).uniform(-1, 1, (1, S, S, 4)) \
        .astype(np.float32)
    out_j = jgen.apply(params, jnp.asarray(x), method="run_bg")
    with torch.no_grad():
        out_t = tgen.run_bg(_nchw(x))
    np.testing.assert_allclose(_nhwc(out_t), np.asarray(out_j), atol=1e-3)


def test_encode_src_and_inference_match_jax(both_generators):
    jgen, params, tgen = both_generators
    rng = np.random.default_rng(1)
    src = rng.uniform(-1, 1, (1, S, S, 6)).astype(np.float32)
    tsf = rng.uniform(-1, 1, (2, S, S, 6)).astype(np.float32)
    t = rng.uniform(-1, 1, (2, S, S, 2)).astype(np.float32)
    t[:, : S // 3] = -2.0                       # background rows
    enc_j, res_j = jgen.apply(params, jnp.asarray(src), method="encode_src")
    with torch.no_grad():
        enc_t, res_t = tgen.encode_src(_nchw(src))
    for a, b in zip(enc_t + res_t, enc_j + res_j):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), atol=1e-3)

    img_j, mask_j = jgen.apply(params, enc_j, res_j, jnp.asarray(tsf),
                               jnp.asarray(t), method="inference")
    with torch.no_grad():
        img_t, mask_t = tgen.inference(enc_t, res_t, _nchw(tsf),
                                       torch.from_numpy(t))
    assert img_t.shape == (2, 3, S, S) and mask_t.shape == (2, 1, S, S)
    np.testing.assert_allclose(_nhwc(img_t), np.asarray(img_j), atol=1e-3)
    np.testing.assert_allclose(_nhwc(mask_t), np.asarray(mask_j), atol=1e-3)
