"""The port's reference-to-JAX converters (``utils.convert.TO_JAX``)
against ``tools/convert_weights.py``'s on the CPU, and the released key
layouts into the port's modules.

For each kind of the converter CLI, a seeded state dict under the
reference's keys (``tests/torch_ref.make_*_sd`` where there is one, else
a port module's own keys, which are the reference's), with the tensors a
released file holds beyond what the converter reads (Sphere20a's fc6,
torchvision's classifiers and later features, InceptionV3's AuxLogits,
InceptionResnetV1's logits, OSNet's and PCB's classifiers; at stand-in
shapes, since the converter drops them by name):

* ``X_to_jax(sd)`` equals ``cw.convert_X(sd)`` exactly, leaf for leaf and
  in insertion order (the flax files of both are the same bytes);
* the file loads into the port's module with ``load_state_dict(strict=
  True)`` as it is (HMR, the generator, DeepFill, SENet50, MTCNN), or
  fails to and loads through ``reference_state_dict`` (the
  ``*_from_reference`` loaders); a ``module.``-prefixed generator file
  loads through it too;
* either way the module holds exactly ``X_from_jax(cw.convert_X(sd))``,
  and ``X_from_jax(X_to_jax(port_sd))`` gives the port's state dict back.
All comparisons are exact (float32 tensors copied, never computed)."""

import os

import numpy as np
import pytest
import torch
from flax import serialization

import torch_ref
from impersonator_tpu_torch.models import facenet, hmr, inpaintor, losses
from impersonator_tpu_torch.utils import convert as C
from impersonator_tpu_torch.utils.checkpoint import (flax_msgpack_bytes,
                                                     read_flax_msgpack)
from tools import convert_weights as cw
from torch_threads import one_torch_thread  # noqa: F401

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "impersonator_tpu",
                       "weights")
DIRECT = {"hmr", "gen", "bgnet", "senet50", "mtcnn"}


def _seeded(module, seed):
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.randn(v.shape, generator=g) if v.is_floating_point()
                else v) for k, v in module.state_dict().items()}


def _stand_in(*keys):
    return {k: torch.ones(2, 3) for k in keys}


def released(kind):
    """(seeded released-layout state dict, the JAX converter's tree)."""
    rng = np.random.default_rng(63)
    if kind == "gen":
        sd = {**torch_ref.make_bg_sd(rng),
              **torch_ref.make_resunet_sd(rng, "src_model", 6),
              **torch_ref.make_resunet_sd(rng, "tsf_model", 6)}
        return sd, cw.convert_generator(sd, repeat=2)
    if kind == "mtcnn":
        sds = C.mtcnn_state_dicts_from_jax(read_flax_msgpack(
            os.path.join(WEIGHTS, "mtcnn_pro.msgpack")))
        return sds, cw.convert_mtcnn(sds)
    if kind == "lpips":
        sd = (torch_ref.make_lpips_lin_sd(rng),
              {**torch_ref.make_alexnet_sd(rng),
               **_stand_in("classifier.1.weight", "classifier.6.bias")})
        return sd, cw.convert_lpips(*sd)
    sd = {
        "hmr": lambda: _seeded(hmr.HumanModelRecovery(), 64),
        "bgnet": lambda: _seeded(inpaintor.InpaintSANet(cnum=8), 65),
        "sphere": lambda: {**_seeded(facenet.Sphere20a(), 66),
                           **_stand_in("fc6.weight")},
        "vgg19": lambda: {**_seeded(losses.Vgg19(), 67),
                          **_stand_in("features.30.weight",
                                      "features.34.bias",
                                      "classifier.0.weight",
                                      "classifier.6.bias")},
        "senet50": lambda: torch_ref.make_senet50_sd(rng),
        "osnet": lambda: {**torch_ref.make_osnet_sd(rng),
                          **_stand_in("classifier.weight",
                                      "classifier.bias")},
        "pcb": lambda: {**torch_ref.make_pcb_sd(rng),
                        **_stand_in("model.fc.weight", "model.fc.bias",
                                    "classifier0.add_block.0.weight",
                                    "classifier5.classifier.0.bias")},
        "inception": lambda: {**torch_ref.make_inception_sd(rng),
                              **_stand_in("AuxLogits.conv0.conv.weight",
                                          "AuxLogits.fc.bias")},
        "facenet_ir": lambda: {**torch_ref.make_facenet_ir_sd(rng),
                               **_stand_in("logits.weight", "logits.bias")},
        "alexnet": lambda: {**torch_ref.make_alexnet_sd(rng),
                            **_stand_in("classifier.1.weight")},
        "vgg16_features": lambda: {**torch_ref.make_vgg16_sd(rng),
                                   **_stand_in("classifier.0.weight")},
        "squeeze_features": lambda: {**torch_ref.make_squeeze_sd(rng),
                                     **_stand_in("classifier.1.weight")},
    }[kind]()
    return sd, cw.CONVERTERS[kind](sd)


def _flat(tree, prefix=""):
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _flat(v, f"{prefix}{k}/")
        else:
            out.append((prefix + k, v))
    return out


def _same_sd(got, want):
    got = {k: v for k, v in got.items()
           if not k.endswith("num_batches_tracked")}
    want = {k: v for k, v in want.items()
            if not k.endswith("num_batches_tracked")}
    assert list(got) == list(want) or sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], v), k


def _load(kind, module, sd):
    """Load the released layout into the port's module(s), strict."""
    if kind == "mtcnn":
        for name, m in module.items():
            m.load_state_dict(sd[name], strict=True)
        return
    if kind == "lpips":
        module.load_state_dict(C.lpips_from_reference(*sd), strict=True)
        return
    if kind in DIRECT:
        module.load_state_dict(sd, strict=True)
        return
    with pytest.raises(RuntimeError, match="Unexpected key"):
        module.load_state_dict(sd, strict=True)
    module.load_state_dict(C.reference_state_dict(kind, sd), strict=True)


KINDS = ["hmr", "gen", "bgnet", "vgg19", "sphere", "senet50", "osnet",
         "pcb", "facenet_ir", "alexnet", "vgg16_features",
         "squeeze_features", "lpips", "inception", "mtcnn"]


@pytest.mark.parametrize("kind", KINDS)
def test_to_jax_matches_convert_weights_and_released_layout_loads(kind):
    sd, want_tree = released(kind)
    got_tree = (C.lpips_to_jax(*sd) if kind == "lpips"
                else C.TO_JAX[kind](sd))
    got, want = _flat(got_tree), _flat(want_tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    assert flax_msgpack_bytes(got_tree) == serialization.to_bytes(want_tree)

    from_jax = C.FROM_JAX[kind]
    if kind == "lpips":
        from impersonator_tpu_torch.metrics.zoo import LPIPS
        module, want_sd = LPIPS("alex"), from_jax(want_tree, "alex")
    else:
        module = C.reference_module(kind, sd)
        want_sd = from_jax(want_tree)
    _load(kind, module, sd)
    if kind == "mtcnn":
        for name, m in module.items():
            _same_sd(m.state_dict(), want_sd[name])
            _same_sd(from_jax(C.mtcnn_to_jax(
                {n: mm.state_dict() for n, mm in module.items()}))[name],
                m.state_dict())
        return
    port_sd = module.state_dict()
    _same_sd(port_sd, want_sd)
    if kind == "lpips":
        lin = {k: v for k, v in port_sd.items() if k.startswith("lin")}
        back = {k[4:]: v for k, v in port_sd.items() if k.startswith("net.")}
        _same_sd(from_jax(C.lpips_to_jax(lin, back), "alex"), port_sd)
    else:
        _same_sd(from_jax(C.TO_JAX[kind](port_sd)), port_sd)
    if kind == "gen":
        prefixed = {f"module.{k}": v for k, v in sd.items()}
        with pytest.raises(RuntimeError, match="Missing key"):
            C.reference_module(kind, sd).load_state_dict(prefixed)
        module.load_state_dict(C.reference_state_dict(kind, prefixed),
                               strict=True)
