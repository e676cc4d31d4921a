"""Shared set-up of the trainer parity tests (tests/test_torch_train_*.py):
both packages' trainers at 64², batch 2, with the same weights — a
reference-layout generator at conv_dim 8 (torch_ref's seeded state
dict, carried into JAX by tools/convert_weights), the JAX trainer's
flax-initialised PatchGAN, VGG19 and Sphere20a carried into the port by
impersonator_tpu_torch.utils.convert. The JAX trainer is built once and
re-configured with dataclasses.replace (its build fixes conv_dim 64).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from impersonator_tpu import assets as jassets
from impersonator_tpu.config import TrainConfig as JCfg
from impersonator_tpu.models.discriminator import \
    PatchDiscriminator as JDisc
from impersonator_tpu.models.generator import ImpersonatorGenerator as JGen
from impersonator_tpu.tasks import trainer as JT
from impersonator_tpu_torch import assets as tassets
from impersonator_tpu_torch.config import TrainConfig as TCfg
from impersonator_tpu_torch.data.datasets import SyntheticPairDataset
from impersonator_tpu_torch.data.loader import _collate, stage_batch
from impersonator_tpu_torch.models.discriminator import \
    PatchDiscriminator as TDisc
from impersonator_tpu_torch.models.generator import \
    ImpersonatorGenerator as TGen
from impersonator_tpu_torch.tasks import trainer as TT
from impersonator_tpu_torch.utils import convert
from tools import convert_weights as cw

import torch_ref
from torch_threads import one_torch_thread  # noqa: F401

S, CONV_DIM, REPEAT, BATCH = 64, 8, 2, 2
BASE = dict(image_size=S, repeat_num=REPEAT, batch_size=BATCH, d_layers=2)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def gen_sd(seed: int = 61) -> dict:
    rng = np.random.default_rng(seed)
    return {**torch_ref.make_bg_sd(rng, 4, CONV_DIM, REPEAT),
            **torch_ref.make_resunet_sd(rng, "src_model", 6, CONV_DIM,
                                        REPEAT),
            **torch_ref.make_resunet_sd(rng, "tsf_model", 6, CONV_DIM,
                                        REPEAT)}


def rel(a, b) -> float:
    """max |a - b| / max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def batch(idx=(0, 1), seed: int = 0):
    """(JAX batch NHWC, port batch NCHW) of SyntheticPairDataset items."""
    ds = SyntheticPairDataset(S, seed=seed)
    host = _collate([ds[i] for i in idx])
    return ({k: jnp.asarray(v) for k, v in host.items()},
            stage_batch(host, "cpu"))


def port_inputs(jin: dict) -> dict:
    """JAX body_recovery_flow outputs -> the port's layout (NCHW images
    and masks; T and the boxes as they are)."""
    out = {}
    for k, v in jin.items():
        if v is None:
            out[k] = None
            continue
        t = torch.from_numpy(np.array(v))
        if k.startswith("input_G") or k.endswith("crop_mask"):
            t = t.permute(0, 3, 1, 2).contiguous()
        out[k] = t
    return out


def nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).contiguous()


class Pair:
    """One JAX trainer and one port trainer with every frozen net equal;
    :meth:`states` gives both packages' train states from the same
    generator and discriminator weights."""

    def __init__(self):
        jcfg = JCfg(**BASE)
        jtr = JT.build_trainer(jcfg, jassets.synthetic_assets())
        self.jtr = dataclasses.replace(jtr, generator=JGen(
            bg_dim=4, src_dim=6, tsf_dim=6, conv_dim=CONV_DIM,
            repeat_num=REPEAT))
        ttr = TT.build_trainer(TCfg(**BASE), tassets.synthetic_assets(),
                               device="cpu")
        ttr.vgg.load_state_dict(convert.vgg19_state_dict_from_jax(
            np_tree(jtr.vgg_params)))
        ttr.face.load_state_dict(convert.sphere20a_state_dict_from_jax(
            np_tree(jtr.face_params)))
        self.ttr = ttr
        self.sd = gen_sd()
        self._d = {}

    def trainers(self, **cfg_kw):
        """(JAX trainer, port trainer) under the base config with
        ``cfg_kw`` replaced."""
        jtr = dataclasses.replace(
            self.jtr, cfg=dataclasses.replace(self.jtr.cfg, **cfg_kw),
            discriminator=JDisc(ndf=64, n_layers=cfg_kw.get("d_layers", 2),
                                norm_type=cfg_kw.get("norm_type",
                                                     "instance")))
        ttr = dataclasses.replace(
            self.ttr, cfg=dataclasses.replace(self.ttr.cfg, **cfg_kw))
        return jtr, ttr

    def d_params(self, jtr):
        key = (jtr.discriminator.n_layers, jtr.discriminator.norm_type)
        if key not in self._d:
            self._d[key] = np_tree(jax.jit(jtr.discriminator.init)(
                jax.random.PRNGKey(5), jnp.zeros((1, S, S, 6))))
        return self._d[key]

    def states(self, jtr, ttr):
        """(JAX TrainState, port TrainState) from the same weights and
        fresh Adam states."""
        g = cw.convert_generator(self.sd, repeat=REPEAT)
        d = self.d_params(jtr)
        jstate = JT.TrainState(g, d, jtr.g_tx.init(g), jtr.d_tx.init(d),
                               jnp.zeros((), jnp.int32))
        tgen = TGen(conv_dim=CONV_DIM, repeat_num=REPEAT)
        tgen.load_state_dict(self.sd)
        tdisc = TDisc(6, 64, jtr.discriminator.n_layers,
                      jtr.discriminator.norm_type)
        tdisc.load_state_dict(convert.discriminator_state_dict_from_jax(d))
        return jstate, ttr.init_state(tgen, tdisc)


def gen_weights(jparams) -> dict:
    """JAX generator params as a port state dict."""
    return convert.generator_state_dict_from_jax(np_tree(jparams))


def disc_weights(jparams) -> dict:
    return convert.discriminator_state_dict_from_jax(np_tree(jparams))


def l2_gaps(a: dict, b: dict):
    """(largest per-tensor, all-tensor) |a - b| / |b| in the L2 norm over
    the keys of b whose b is non-zero."""
    keys = [k for k in b if float(b[k].norm()) > 0]
    per = max(float((a[k] - b[k]).norm() / b[k].norm()) for k in keys)
    ca = torch.cat([a[k].flatten() for k in keys])
    cb = torch.cat([b[k].flatten() for k in keys])
    return per, float((ca - cb).norm() / cb.norm())


def perturbed(tree, seed: int, scale: float = 0.05):
    """A flax param tree with N(0, scale) noise added to every array, so
    that norm scales, biases and kernels all leave their init."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.normal(0, scale, np.shape(v))
                   ).astype(np.float32), np_tree(tree))


def capture_loss_fns(step_fn, *args):
    """The functions a JAX train step hands to jax.value_and_grad (its G
    and D losses), caught while the step is traced abstractly on
    ``args``."""
    caught = []
    real = jax.value_and_grad

    def spy(fn, *a, **k):
        caught.append(fn)
        return real(fn, *a, **k)

    jax.value_and_grad = spy
    try:
        jax.eval_shape(step_fn, *args)
    finally:
        jax.value_and_grad = real
    return caught


def grads_by_name(module, loss) -> dict:
    """{parameter name: d loss / d parameter}, zeros where it does not
    reach."""
    names = [n for n, _ in module.named_parameters()]
    return dict(zip(names, torch.autograd.grad(
        loss, list(module.parameters()), materialize_grads=True)))
