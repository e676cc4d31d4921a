"""Weight bridge from the JAX package's params to this port.

Each function is the exact inverse of a ``tools/convert_weights``
converter: that maps a reference state dict onto the flax tree, this
maps the flax tree back onto the reference key layout the port's
modules use.

* :func:`generator_state_dict_from_jax` inverts ``convert_generator``
  (:class:`..models.generator.ImpersonatorGenerator`): conv kernels
  HWIO -> OIHW, transposed-conv kernels HWIO -> IOHW, instance-norm
  ``scale``/``bias`` -> ``weight``/``bias``. The ablation generators of
  :mod:`..models.baseline` are built from the same stacks under the same
  names, so it maps theirs too (``ConcatGenerator`` has no
  ``src_model``);
* :func:`hmr_state_dict_from_jax` inverts ``convert_hmr``
  (:class:`..models.hmr.HumanModelRecovery`): also Dense kernels
  (in, out) -> Linear weights (out, in), and BatchNorm ``scale``/
  ``bias`` plus ``batch_stats`` ``mean``/``var`` -> ``weight``/``bias``/
  ``running_mean``/``running_var``;
* :func:`inpaintor_state_dict_from_jax` inverts ``convert_bgnet``
  (:class:`..models.inpaintor.InpaintSANet`): biased gated and attention
  convs, and the gated layers' BatchNorms as for HMR;
* :func:`sphere20a_state_dict_from_jax`, :func:`senet50_state_dict_from_jax`
  and :func:`vgg19_state_dict_from_jax` invert ``convert_sphere``,
  ``convert_senet50`` and ``convert_vgg19`` (:mod:`..models.facenet`,
  :class:`..models.losses.Vgg19`);
* :func:`discriminator_state_dict_from_jax` maps the JAX package's
  PatchGAN params onto :class:`..models.discriminator.PatchDiscriminator`
  (no reference converter exists: the reference checkpoints hold no
  discriminator that the JAX package reads), and
  :func:`global_local_state_dict_from_jax` /
  :func:`multi_scale_state_dict_from_jax` each of their PatchGANs
  (``global_model`` / ``local_model``, ``scale_{i}``) onto the same keys
  under its module's name;
* :func:`adam_state_dict_from_optax` turns an optax
  ``inject_hyperparams(adam)`` state into a ``torch.optim.Adam`` state
  dict over a port module's parameters;
* the metric nets (:mod:`..metrics`): :func:`lpips_state_dict_from_jax`
  (lin heads, with or without an alex / vgg / squeeze backbone; inverts
  ``convert_lpips``), :func:`inception_state_dict_from_jax`,
  :func:`facenet_ir_state_dict_from_jax`, :func:`osnet_state_dict_from_jax`,
  :func:`pcb_state_dict_from_jax` and :func:`mtcnn_state_dicts_from_jax`
  (invert ``convert_inception``, ``convert_facenet_ir``,
  ``convert_osnet``, ``convert_pcb`` and ``convert_mtcnn``), and
  :func:`darknet_params_from_jax` (the JAX package's folded darknet
  kernels, HWIO -> OIHW). These walk the port module's own state dict,
  map each key to its flax path, and fail on a tree leaf left over.

The other way, ``*_to_jax`` (``TO_JAX`` by ``tools/convert_weights``'
kind) maps a reference state dict onto the converter's tree leaf for
leaf and in its insertion order, walking the same key lists, so
``utils.checkpoint.write_flax_msgpack`` of it is the converter's file
byte for byte; ``FROM_JAX`` holds each one's inverse. A released file
loads into the port's module (:func:`reference_module`) through
:func:`reference_state_dict`: as it is where the module holds every
tensor of the file, else through a named ``*_from_reference`` loader
(``FROM_REFERENCE`` by kind).
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn


def _generator_keys(n_down: int, repeat: int,
                    unets=("src_model", "tsf_model")):
    """(state-dict key, flax path, kind) of every generator parameter,
    kind in {conv, convt, norm}; follows convert_generator line by line.
    ``unets`` names the ResUnet streams beside ``bg_model``."""
    out = []

    def conv(src, dst):
        out.append((src + ".weight", dst + "/kernel", "conv"))

    def convt(src, dst):
        out.append((src + ".weight", dst, "convt"))

    def inorm(src, dst):
        out.append((src + ".weight", dst + "/scale", "norm"))
        out.append((src + ".bias", dst + "/bias", "norm"))

    idx = 0
    conv(f"bg_model.model.{idx}", "bg_model/stem/conv/conv")
    inorm(f"bg_model.model.{idx + 1}", "bg_model/stem/norm")
    idx += 3
    for i in range(n_down):
        conv(f"bg_model.model.{idx}", f"bg_model/down_{i}/conv/conv")
        inorm(f"bg_model.model.{idx + 1}", f"bg_model/down_{i}/norm")
        idx += 3
    for i in range(repeat):
        main = f"bg_model.model.{idx}.main"
        conv(f"{main}.0", f"bg_model/res_{i}/conv1/conv")
        inorm(f"{main}.1", f"bg_model/res_{i}/norm1")
        conv(f"{main}.3", f"bg_model/res_{i}/conv2/conv")
        inorm(f"{main}.4", f"bg_model/res_{i}/norm2")
        idx += 1
    for i in range(n_down):
        convt(f"bg_model.model.{idx}", f"bg_model/up_{i}/deconv/kernel")
        inorm(f"bg_model.model.{idx + 1}", f"bg_model/up_{i}/norm")
        idx += 3
    conv(f"bg_model.model.{idx}", "bg_model/rgb/conv")

    for p in unets:
        for i in range(n_down + 1):
            conv(f"{p}.encoders.{i}.0", f"{p}/enc_{i}/conv/conv")
            inorm(f"{p}.encoders.{i}.1", f"{p}/enc_{i}/norm")
        for i in range(repeat):
            main = f"{p}.resnets.{i}.main"
            conv(f"{main}.0", f"{p}/res_{i}/conv1/conv")
            inorm(f"{main}.1", f"{p}/res_{i}/norm1")
            conv(f"{main}.3", f"{p}/res_{i}/conv2/conv")
            inorm(f"{main}.4", f"{p}/res_{i}/norm2")
        for i in range(n_down):
            convt(f"{p}.decoders.{i}.0", f"{p}/dec_{i}/deconv/kernel")
            inorm(f"{p}.decoders.{i}.1", f"{p}/dec_{i}/norm")
            conv(f"{p}.skippers.{i}.0", f"{p}/skip_{i}/conv/conv")
            inorm(f"{p}.skippers.{i}.1", f"{p}/skip_{i}/norm")
        conv(f"{p}.img_reg.0", f"{p}/img_reg/conv")
        conv(f"{p}.attetion_reg.0", f"{p}/att_reg/conv")
    return out


def generator_state_dict_from_jax(tree: dict) -> dict:
    """{'params': flax generator tree} of numpy arrays -> this port's
    ImpersonatorGenerator, FeatureWarpingGenerator or ConcatGenerator
    state dict (float32 CPU tensors)."""
    params = tree["params"]
    bg = params["bg_model"]
    repeat = sum(k.startswith("res_") for k in bg)
    n_down = sum(k.startswith("down_") for k in bg)
    unets = [p for p in ("src_model", "tsf_model") if p in params]
    perm = {"conv": (3, 2, 0, 1), "convt": (2, 3, 0, 1), "norm": None}
    sd = {}
    for key, path, kind in _generator_keys(n_down, repeat, unets):
        node = params
        for part in path.split("/"):
            node = node[part]
        arr = np.asarray(node, np.float32)
        if perm[kind] is not None:
            arr = arr.transpose(perm[kind])
        sd[key] = torch.tensor(arr)
    return sd


def _hmr_keys():
    """(state-dict key, collection, flax path, kind) of every HMR tensor,
    kind in {conv, dense, vec}; follows convert_hmr line by line."""
    out = []

    def bn(src, dst):
        out.append((src + ".weight", "params", dst + "/scale", "vec"))
        out.append((src + ".bias", "params", dst + "/bias", "vec"))
        out.append((src + ".running_mean", "batch_stats", dst + "/mean",
                    "vec"))
        out.append((src + ".running_var", "batch_stats", dst + "/var",
                    "vec"))

    def conv(src, dst, bias=False):
        out.append((src + ".weight", "params", dst + "/kernel", "conv"))
        if bias:
            out.append((src + ".bias", "params", dst + "/bias", "vec"))

    conv("resnet.conv1", "resnet/conv1/conv", bias=True)
    in_planes = 64
    for li, (planes, nb) in enumerate(zip((64, 128, 256, 512), (3, 4, 6, 3)),
                                      start=1):
        for bi in range(nb):
            src, dst = f"resnet.layer{li}.{bi}", f"resnet/layer{li}_{bi}"
            for k in (1, 2, 3):
                bn(f"{src}.bn{k}", f"{dst}/bn{k}")
            conv(f"{src}.conv1", f"{dst}/conv1/conv")
            conv(f"{src}.conv2", f"{dst}/conv2/conv")
            conv(f"{src}.conv3", f"{dst}/conv3/conv", bias=True)
            if in_planes != planes * 4:
                conv(f"{src}.shortcut.0", f"{dst}/shortcut/conv", bias=True)
            in_planes = planes * 4
    bn("resnet.post_bn", "resnet/post_bn")
    out.append(("regressor.mean_theta", "params", "regressor/mean_theta",
                "vec"))
    for k in (1, 2, 3):
        fc = f"regressor.fc_blocks.fc{k}"
        out.append((fc + ".weight", "params", f"regressor/fc{k}/kernel",
                    "dense"))
        out.append((fc + ".bias", "params", f"regressor/fc{k}/bias", "vec"))
    return out


def hmr_state_dict_from_jax(tree: dict) -> dict:
    """{'params', 'batch_stats'} flax HMR tree of numpy arrays -> this
    port's HumanModelRecovery state dict (float32 CPU tensors; each
    BatchNorm's ``num_batches_tracked`` is 0, as the module starts)."""
    return _state_dict(tree, _hmr_keys(),
                       {"conv": (3, 2, 0, 1), "dense": (1, 0), "vec": None})


def _state_dict(tree: dict, keys, perm) -> dict:
    """The state dict of (key, collection, flax path, kind) rows, each
    array transposed by ``perm[kind]``; every BatchNorm gets a
    ``num_batches_tracked`` of 0."""
    sd = {}
    for key, coll, path, kind in keys:
        node = tree[coll]
        for part in path.split("/"):
            node = node[part]
        arr = np.asarray(node, np.float32)
        if perm[kind] is not None:
            arr = arr.transpose(perm[kind])
        sd[key] = torch.tensor(arr)
        if key.endswith(".running_var"):
            sd[key[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0)
    return sd


# flax names of the deepfill layers, in the order of the torch Sequentials;
# the upsampling layers nest their gated conv once more
_BGNET_LAYERS = (("coarse_net", [f"c{i}" for i in range(17)]),
                 ("refine_conv_net", [f"r{i}" for i in range(11)]),
                 ("refine_upsample_net", [f"u{i}" for i in range(7)]))
_BGNET_UPSAMPLE = {"c12", "c14", "u2", "u4"}


def _bgnet_keys():
    """(state-dict key, collection, flax path, kind) of every deepfill
    tensor, kind in {conv, vec}; follows convert_bgnet line by line."""
    out = []
    for seq, names in _BGNET_LAYERS:
        for i, name in enumerate(names):
            src, dst = f"{seq}.{i}", name
            if name in _BGNET_UPSAMPLE:
                src, dst = src + ".conv2d", dst + "/conv"
            for t, f in (("conv2d", "conv"), ("mask_conv2d", "mask_conv")):
                out.append((f"{src}.{t}.weight", "params",
                            f"{dst}/{f}/kernel", "conv"))
                out.append((f"{src}.{t}.bias", "params", f"{dst}/{f}/bias",
                            "vec"))
            bn = f"{src}.batch_norm2d"
            out += [(bn + ".weight", "params", dst + "/bn/scale", "vec"),
                    (bn + ".bias", "params", dst + "/bn/bias", "vec"),
                    (bn + ".running_mean", "batch_stats", dst + "/bn/mean",
                     "vec"),
                    (bn + ".running_var", "batch_stats", dst + "/bn/var",
                     "vec")]
    for t in ("query", "key", "value"):
        out.append((f"refine_attn.{t}_conv.weight", "params",
                    f"attn/{t}/kernel", "conv"))
        out.append((f"refine_attn.{t}_conv.bias", "params",
                    f"attn/{t}/bias", "vec"))
    out.append(("refine_attn.gamma", "params", "attn/gamma", "vec"))
    return out


def inpaintor_state_dict_from_jax(tree: dict) -> dict:
    """{'params', 'batch_stats'} flax InpaintSANet tree of numpy arrays ->
    this port's InpaintSANet state dict (float32 CPU tensors; each
    BatchNorm's ``num_batches_tracked`` is 0)."""
    return _state_dict(tree, _bgnet_keys(),
                       {"conv": (3, 2, 0, 1), "vec": None})


# Sphere20a's residual pairs: flax "<pair>a" / "<pair>b" are the reference's
# two convs (convert_weights._SPHERE_PAIRS)
_SPHERE_PAIRS = {
    "conv1_2": ("1_2", "1_3"), "conv2_2": ("2_2", "2_3"),
    "conv2_4": ("2_4", "2_5"), "conv3_2": ("3_2", "3_3"),
    "conv3_4": ("3_4", "3_5"), "conv3_6": ("3_6", "3_7"),
    "conv3_8": ("3_8", "3_9"), "conv4_2": ("4_2", "4_3"),
}


def _sphere_keys():
    """(state-dict key, collection, flax path, kind) of every Sphere20a
    tensor; follows convert_sphere line by line."""
    out = []

    def unit(src, dst):
        out.append((f"conv{src}.weight", "params", dst + "/conv/kernel",
                    "conv"))
        out.append((f"conv{src}.bias", "params", dst + "/conv/bias", "vec"))
        out.append((f"relu{src}.weight", "params", dst + "/prelu/alpha",
                    "vec"))

    for stage in ("1_1", "2_1", "3_1", "4_1"):
        unit(stage, "conv" + stage)
    for ours, (a, b) in _SPHERE_PAIRS.items():
        unit(a, ours + "a")
        unit(b, ours + "b")
    out.append(("fc5.weight", "params", "fc5/kernel", "dense"))
    out.append(("fc5.bias", "params", "fc5/bias", "vec"))
    return out


def sphere20a_state_dict_from_jax(tree: dict) -> dict:
    """{'params'} flax Sphere20a tree of numpy arrays -> this port's
    Sphere20a state dict (float32 CPU tensors)."""
    return _state_dict(tree, _sphere_keys(),
                       {"conv": (3, 2, 0, 1), "dense": (1, 0), "vec": None})


def _senet_keys(layers=(3, 4, 6, 3)):
    """(state-dict key, collection, flax path, kind) of every SENet50
    tensor; follows convert_senet50 line by line."""
    out = []

    def bn(src, dst):
        out.extend([(src + ".weight", "params", dst + "/scale", "vec"),
                    (src + ".bias", "params", dst + "/bias", "vec"),
                    (src + ".running_mean", "batch_stats", dst + "/mean",
                     "vec"),
                    (src + ".running_var", "batch_stats", dst + "/var",
                     "vec")])

    def conv(src, dst, bias=False):
        out.append((src + ".weight", "params", dst + "/kernel", "conv"))
        if bias:
            out.append((src + ".bias", "params", dst + "/bias", "vec"))

    conv("conv1", "conv1")
    bn("bn1", "bn1")
    for li, nb in enumerate(layers, start=1):
        for bi in range(nb):
            src, dst = f"layer{li}.{bi}", f"layer{li}_{bi}"
            for k in (1, 2, 3):
                conv(f"{src}.conv{k}", f"{dst}/conv{k}")
                bn(f"{src}.bn{k}", f"{dst}/bn{k}")
            conv(f"{src}.conv4", f"{dst}/conv4", bias=True)
            conv(f"{src}.conv5", f"{dst}/conv5", bias=True)
            if bi == 0:     # every layer's first block downsamples
                conv(f"{src}.downsample.0", f"{dst}/downsample_conv")
                bn(f"{src}.downsample.1", f"{dst}/downsample_bn")
    return out


def senet50_state_dict_from_jax(tree: dict) -> dict:
    """{'params', 'batch_stats'} flax SENet50 tree of numpy arrays -> this
    port's SENet50 state dict (float32 CPU tensors; each BatchNorm's
    ``num_batches_tracked`` is 0)."""
    return _state_dict(tree, _senet_keys(),
                       {"conv": (3, 2, 0, 1), "vec": None})


# torchvision vgg19.features indices of the 13 convs the Vgg19 holds
_VGG_FEATURE_IDS = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28)


def _vgg19_keys():
    """(state-dict key, collection, flax path, kind) of the Vgg19's 13
    convs; follows convert_vgg19."""
    keys = []
    for ours, idx in enumerate(_VGG_FEATURE_IDS):
        keys.append((f"features.{idx}.weight", "params",
                     f"conv_{ours}/kernel", "conv"))
        keys.append((f"features.{idx}.bias", "params", f"conv_{ours}/bias",
                     "vec"))
    return keys


def vgg19_state_dict_from_jax(tree: dict) -> dict:
    """{'params'} flax Vgg19 tree of numpy arrays -> this port's Vgg19
    state dict (float32 CPU tensors)."""
    return _state_dict(tree, _vgg19_keys(),
                       {"conv": (3, 2, 0, 1), "vec": None})


def discriminator_state_dict_from_jax(tree: dict) -> dict:
    """{'params'[, 'batch_stats']} flax PatchDiscriminator tree of numpy
    arrays -> this port's PatchDiscriminator state dict (float32 CPU
    tensors). The depth and the norm come from the tree."""
    params = tree["params"]
    n_layers = sum(k.startswith("conv_") for k in params) - 1
    norm = "bn" if "bn" in params["norm_1"] else "in"
    keys = []

    def conv(idx, path):
        keys.append((f"model.{idx}.weight", "params", path + "/conv/kernel",
                     "conv"))
        if "bias" in params[path]["conv"]:
            keys.append((f"model.{idx}.bias", "params", path + "/conv/bias",
                         "vec"))

    conv(0, "conv_0")
    for n in range(1, n_layers + 1):
        idx = 3 * n - 1
        conv(idx, f"conv_{n}")
        src, dst = f"model.{idx + 1}", f"norm_{n}/{norm}"
        keys += [(src + ".weight", "params", dst + "/scale", "vec"),
                 (src + ".bias", "params", dst + "/bias", "vec")]
        if norm == "bn":
            keys += [(src + ".running_mean", "batch_stats", dst + "/mean",
                      "vec"),
                     (src + ".running_var", "batch_stats", dst + "/var",
                      "vec")]
    conv(3 * n_layers + 2, "head")
    sd = _state_dict(tree, keys, {"conv": (3, 2, 0, 1), "vec": None})
    # BatchNormEval keeps no batch counter
    return {k: v for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def _sub_tree(tree: dict, name: str) -> dict:
    """The submodule ``name``'s part of every collection of a flax tree."""
    return {coll: v[name] for coll, v in tree.items() if name in v}


def _prefixed(prefix: str, sd: dict) -> dict:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def global_local_state_dict_from_jax(tree: dict) -> dict:
    """{'params'[, 'batch_stats']} flax GlobalLocalDiscriminator tree ->
    this port's GlobalLocalDiscriminator state dict."""
    return {**_prefixed("global_model", discriminator_state_dict_from_jax(
                _sub_tree(tree, "global_model"))),
            **_prefixed("local_model", discriminator_state_dict_from_jax(
                _sub_tree(tree, "local_model")))}


def multi_scale_state_dict_from_jax(tree: dict) -> dict:
    """{'params'} flax MultiScaleDiscriminator tree -> this port's
    MultiScaleDiscriminator state dict (``scale_models.{i}``)."""
    n = sum(k.startswith("scale_") for k in tree["params"])
    sd = {}
    for i in range(n):
        sd.update(_prefixed(f"scale_models.{i}",
                            discriminator_state_dict_from_jax(
                                _sub_tree(tree, f"scale_{i}"))))
    return sd


def adam_state_dict_from_optax(opt_state: dict, state_dict_from_jax,
                               module, optimizer) -> dict:
    """An optax ``inject_hyperparams(adam)`` state as a nested dict
    (``flax.serialization.to_state_dict`` of it, or what
    ``utils.checkpoint.read_flax_msgpack`` reads from its file) -> the
    state dict of ``optimizer``, a ``torch.optim.Adam`` over
    ``module.parameters()`` in that order: ``exp_avg`` / ``exp_avg_sq``
    from optax's ``mu`` / ``nu`` (mapped by ``state_dict_from_jax``, the
    module's ``*_state_dict_from_jax``), ``step`` from its count, and the
    group's ``lr`` from the injected learning rate. optax's update,
    lr · m̂ / (sqrt(v̂) + eps), is torch's Adam with the same eps."""
    inner = opt_state["inner_state"]["0"]
    mu = state_dict_from_jax(inner["mu"])
    nu = state_dict_from_jax(inner["nu"])
    step = float(np.asarray(inner["count"]))
    sd = optimizer.state_dict()
    names = [n for n, _ in module.named_parameters()]
    ids = sd["param_groups"][0]["params"]
    if len(sd["param_groups"]) != 1 or len(ids) != len(names):
        raise ValueError("optimizer must hold one group of the module's "
                         "parameters")
    sd["state"] = {i: {"step": torch.tensor(step),
                       "exp_avg": mu[n].clone(),
                       "exp_avg_sq": nu[n].clone()}
                   for i, n in zip(ids, names)}
    sd["param_groups"][0]["lr"] = float(np.asarray(
        opt_state["hyperparams"]["learning_rate"]))
    return sd


# --------------------------------------------------------------------------
# metric nets: keys from the port module, paths from a rename
# --------------------------------------------------------------------------

def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _leaf_path(mod: nn.Module, leaf: str, path: str):
    """(collection, flax path, kind) of one tensor of a port module whose
    flax counterpart sits at ``path``."""
    from impersonator_tpu_torch.models.facenet import PReLU
    if isinstance(mod, (nn.Conv2d, nn.Linear)):
        if leaf == "bias":
            return "params", f"{path}/bias", "vec"
        kind = "conv" if isinstance(mod, nn.Conv2d) else "dense"
        return "params", f"{path}/kernel", kind
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", f"{path}/{leaf[len('running_'):]}", "vec"
    if isinstance(mod, PReLU):
        return "params", f"{path}/alpha", "vec"
    # BatchNorm / InstanceNorm affine
    return "params", f"{path}/{'scale' if leaf == 'weight' else 'bias'}", \
        "vec"


_PERMS = {"conv": (3, 2, 0, 1), "dense": (1, 0), "vec": None}


def _module_keys(module: nn.Module, rename):
    """(state-dict key, collection, flax path, kind) of every tensor of
    ``module`` but the BatchNorms' counters, in the module's order: each
    key's owner module path goes through ``rename`` to its flax path."""
    out = []
    for key in module.state_dict():
        owner, _, leaf = key.rpartition(".")
        if leaf != "num_batches_tracked":
            out.append((key, *_leaf_path(module.get_submodule(owner), leaf,
                                         rename(owner))))
    return out


def _from_module(module: nn.Module, tree: dict, rename) -> dict:
    """The state dict of ``module`` (any device, ``meta`` included) filled
    from the flax ``tree`` ({'params'[, 'batch_stats']}) along
    :func:`_module_keys`. Raises on a missing leaf, a shape mismatch or a
    leaf of the tree left over."""
    flat = {coll: _flat(tree.get(coll, {}))
            for coll in ("params", "batch_stats")}
    used = {coll: set() for coll in flat}
    paths = {key: rest for key, *rest in _module_keys(module, rename)}
    sd = {}
    for key, ref in module.state_dict().items():
        if key not in paths:
            sd[key] = torch.tensor(0)
            continue
        coll, path, kind = paths[key]
        arr = np.asarray(flat[coll][path], np.float32)
        if _PERMS[kind] is not None:
            arr = arr.transpose(_PERMS[kind])
        arr = arr.reshape(ref.shape) if arr.size == ref.numel() else arr
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: {arr.shape} from {path}, the module "
                             f"holds {tuple(ref.shape)}")
        sd[key] = torch.tensor(arr)
        used[coll].add(path)
    left = [f"{c}/{p}" for c in flat for p in flat[c] if p not in used[c]]
    if left:
        raise ValueError(f"tree leaves with no key in the module: {left[:8]}")
    return sd


def _template(cls, *args):
    """A module of ``cls`` with no storage, for its keys and shapes."""
    with torch.device("meta"):
        return cls(*args)


_ALEX_IDS = (0, 3, 6, 8, 10)


def _lpips_backbone_path(net: str, owner: str) -> str:
    """``net.features.{i}[.{sub}]`` -> the flax path under ``net``."""
    parts = owner.split(".")
    ti = int(parts[2])
    if net == "alex":
        return f"alex/conv{_ALEX_IDS.index(ti)}/conv"
    if net == "vgg":
        return f"vgg/conv{ti}/conv"
    if ti == 0:
        return "squeeze/conv0/conv"
    return f"squeeze/fire{ti}/{parts[3]}/conv"


def lpips_state_dict_from_jax(tree: dict, net: str = "alex") -> dict:
    """{'params': {'lin{i}': (C,)[, net: backbone]}} flax LPIPS tree ->
    this port's ``metrics.zoo.LPIPS(net)`` state dict: ``lin{i}.model.1.
    weight`` (1, C, 1, 1) and, when the tree holds the backbone, its
    ``net.features.*`` keys (a lin-heads-only tree gives the lin keys
    alone)."""
    from impersonator_tpu_torch.metrics.zoo import LPIPS
    template = _template(LPIPS, net)
    params = dict(tree["params"])
    sd = {}
    for i in range(template.n_lin):
        w = np.asarray(params.pop(f"lin{i}"), np.float32)
        sd[f"lin{i}.model.1.weight"] = torch.tensor(w.reshape(1, -1, 1, 1))
    backbone = params.pop(net, None)
    if params:
        raise ValueError(f"LPIPS tree leaves with no key: {sorted(params)}")
    if backbone is not None:
        sd.update(_prefixed("net", _from_module(
            template.net, {"params": {net: backbone}},
            lambda owner: _lpips_backbone_path(net, "net." + owner))))
    return sd


def inception_state_dict_from_jax(tree: dict) -> dict:
    """{'params', 'batch_stats'} flax InceptionV3 tree -> this port's
    ``metrics.zoo.InceptionV3`` state dict."""
    from impersonator_tpu_torch.metrics.zoo import InceptionV3
    return _from_module(_template(InceptionV3), tree, _inception_path)


def facenet_ir_state_dict_from_jax(tree: dict) -> dict:
    """{'params', 'batch_stats'} flax InceptionResnetV1 tree -> this
    port's ``metrics.zoo.InceptionResnetV1`` state dict (``repeat_1.{i}``
    is flax's ``repeat_1_{i}``, ``mixed_6a.branch0`` its
    ``mixed_6a_branch0``)."""
    from impersonator_tpu_torch.metrics.zoo import InceptionResnetV1
    return _from_module(_template(InceptionResnetV1), tree,
                        _facenet_ir_path)


def _inception_path(owner: str) -> str:
    return owner.replace(".", "/")


def _facenet_ir_path(owner: str) -> str:
    owner = re.sub(r"^(repeat_\d)\.(\d+)", r"\1_\2", owner)
    owner = re.sub(r"^(mixed_\da)\.", r"\1_", owner)
    return owner.replace(".", "/")


def _osnet_path(owner: str) -> str:
    owner = re.sub(r"^conv(\d)\.2\.0", r"conv\1_t", owner)
    owner = re.sub(r"^conv(\d)\.(\d)", r"conv\1_\2", owner)
    owner = re.sub(r"conv2([bcd])\.(\d)", r"conv2\1_\2", owner)
    owner = {"fc.0": "fc", "fc.1": "fc_bn"}.get(owner, owner)
    return owner.replace(".", "/")


def _pcb_path(owner: str) -> str:
    owner = owner[len("model."):]
    owner = re.sub(r"^(layer\d)\.(\d+)", r"\1_\2", owner)
    owner = owner.replace("downsample.0", "downsample_conv")
    owner = owner.replace("downsample.1", "downsample_bn")
    return owner.replace(".", "/")


def _mtcnn_path(owner: str) -> str:
    return owner + "/conv" if owner.startswith("conv") else owner


def osnet_state_dict_from_jax(tree: dict) -> dict:
    """{'params', 'batch_stats'} flax OSNet tree -> this port's
    ``metrics.reid.OSNet`` state dict (stage blocks ``conv2.{b}`` are
    flax's ``conv2_{b}``, transitions ``conv2.2.0`` its ``conv2_t``,
    Lite streams ``conv2b.{d}`` its ``conv2b_{d}``, the head ``fc.0`` /
    ``fc.1`` its ``fc`` / ``fc_bn``)."""
    from impersonator_tpu_torch.metrics.reid import OSNet
    return _from_module(_template(OSNet), tree, _osnet_path)


def pcb_state_dict_from_jax(tree: dict) -> dict:
    """{'params', 'batch_stats'} flax PCBReid tree -> this port's
    ``metrics.reid.PCBReid`` state dict (``model.layer1.0`` is flax's
    ``layer1_0``, its ``downsample.0`` / ``.1`` the ``downsample_conv`` /
    ``downsample_bn``)."""
    from impersonator_tpu_torch.metrics.reid import PCBReid
    return _from_module(_template(PCBReid), tree, _pcb_path)


def mtcnn_state_dicts_from_jax(tree: dict) -> dict:
    """{'pnet', 'rnet', 'onet'} flax MTCNN trees (each {'params'}) -> the
    state dicts of this port's ``metrics.mtcnn.PNet`` / ``RNet`` /
    ``ONet`` (flax's conv wrappers add a ``conv`` level)."""
    from impersonator_tpu_torch.metrics import mtcnn
    return {name: _from_module(_template(cls), tree[name], _mtcnn_path)
            for name, cls in (("pnet", mtcnn.PNet), ("rnet", mtcnn.RNet),
                              ("onet", mtcnn.ONet))}


def darknet_params_from_jax(params: dict) -> dict:
    """The JAX package's folded darknet params ({conv{i}: {kernel HWIO,
    bias}}) -> this port's ({conv{i}: {weight OIHW, bias}}) host arrays."""
    return {name: {"weight": np.ascontiguousarray(
                       np.asarray(p["kernel"], np.float32)
                       .transpose(3, 2, 0, 1)),
                   "bias": np.asarray(p["bias"], np.float32)}
            for name, p in params.items()}


# --------------------------------------------------------------------------
# the other way: reference state dicts -> the JAX package's trees
# --------------------------------------------------------------------------

# a key list's kind -> the transpose from the torch layout to flax's
# (the inverse of each *_from_jax permutation: conv OIHW -> HWIO,
# transposed conv IOHW -> HWIO with I on axis 2, Linear (out, in) -> (in,
# out))
_TO_FLAX = {"conv": (2, 3, 1, 0), "convt": (2, 3, 0, 1), "dense": (1, 0),
            "vec": None, "norm": None}


def strip_module(sd: dict) -> dict:
    """A state dict without ``DataParallel``'s ``module.`` prefixes."""
    return {(k[7:] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def _host(t) -> np.ndarray:
    if torch.is_tensor(t):
        t = t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, np.float32)


def _set(tree: dict, path: str, value) -> None:
    node = tree
    parts = path.split("/")
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = value


def _tree(sd: dict, keys, colls=("params", "batch_stats")) -> dict:
    """The flax tree of the (key, collection, flax path, kind) rows, each
    tensor of ``sd`` float32 and in flax's layout, the paths inserted in
    the rows' order (the converter's, so the file's bytes match)."""
    out = {c: {} for c in colls}
    for key, coll, path, kind in keys:
        arr = _host(sd[key])
        if _TO_FLAX[kind] is not None:
            arr = arr.transpose(_TO_FLAX[kind])
        _set(out[coll], path, arr)
    return out


def _count(sd: dict, pattern: str) -> int:
    return sum(re.fullmatch(pattern, k) is not None for k in sd)


def generator_to_jax(sd: dict) -> dict:
    """A reference generator state dict (ImpersonatorGenerator, or the
    baselines' stacks) -> ``convert_generator``'s {'params'} tree; the
    depth comes from the keys."""
    sd = strip_module(sd)
    unets = [p for p in ("src_model", "tsf_model")
             if f"{p}.img_reg.0.weight" in sd]
    n_down = _count(sd, r"tsf_model\.decoders\.\d+\.0\.weight")
    repeat = _count(sd, r"tsf_model\.resnets\.\d+\.main\.0\.weight")
    keys = [(k, "params", path, kind)
            for k, path, kind in _generator_keys(n_down, repeat, unets)]
    return _tree(sd, keys, ("params",))


def hmr_to_jax(sd: dict) -> dict:
    """hmr_tf2pt.pth's state dict -> ``convert_hmr``'s tree."""
    return _tree(strip_module(sd), _hmr_keys())


def bgnet_to_jax(sd: dict) -> dict:
    """The deepfillv2 state dict -> ``convert_bgnet``'s tree."""
    return _tree(strip_module(sd), _bgnet_keys())


def vgg19_to_jax(sd: dict) -> dict:
    """torchvision's vgg19 state dict -> ``convert_vgg19``'s tree (the 13
    convs the Vgg19 holds)."""
    return _tree(sd, _vgg19_keys(), ("params",))


def sphere_to_jax(sd: dict) -> dict:
    """sphere20a's state dict -> ``convert_sphere``'s tree (fc6 left
    out)."""
    return _tree(strip_module(sd), _sphere_keys(), ("params",))


def senet50_to_jax(sd: dict) -> dict:
    """SENet50's state dict -> ``convert_senet50``'s tree."""
    return _tree(strip_module(sd), _senet_keys())


def osnet_to_jax(sd: dict) -> dict:
    """osnet_ibn_x1_0's state dict -> ``convert_osnet``'s tree (the
    classifier left out)."""
    from impersonator_tpu_torch.metrics.reid import OSNet
    return _tree(strip_module(sd),
                 _module_keys(_template(OSNet), _osnet_path))


def pcb_to_jax(sd: dict) -> dict:
    """pcb_net_last.pth's state dict -> ``convert_pcb``'s tree (the
    backbone under ``model.``; the classifiers left out)."""
    from impersonator_tpu_torch.metrics.reid import PCBReid
    return _tree(strip_module(sd),
                 _module_keys(_template(PCBReid), _pcb_path))


def inception_to_jax(sd: dict) -> dict:
    """torchvision's inception_v3 state dict -> ``convert_inception``'s
    tree (AuxLogits left out)."""
    from impersonator_tpu_torch.metrics.zoo import InceptionV3
    return _tree(sd, _module_keys(_template(InceptionV3), _inception_path))


def facenet_ir_to_jax(sd: dict) -> dict:
    """InceptionResnetV1's state dict -> ``convert_facenet_ir``'s tree
    (the logits head left out)."""
    from impersonator_tpu_torch.metrics.zoo import InceptionResnetV1
    return _tree(strip_module(sd), _module_keys(
        _template(InceptionResnetV1), _facenet_ir_path))


# TO_JAX's backbone kinds -> LPIPS' name of the net
_BACKBONE_KINDS = {"alexnet": "alex", "vgg16_features": "vgg",
                   "squeeze_features": "squeeze"}


def _backbone_module(net: str) -> nn.Module:
    from impersonator_tpu_torch.metrics import zoo
    return {"alex": zoo.AlexFeatures, "vgg": zoo.VGG16Features,
            "squeeze": zoo.SqueezeFeatures}[net]()


def _backbone_path(net: str):
    """A backbone module's owner path -> its flax path (LPIPS' own, less
    the ``net`` level)."""
    return lambda owner: _lpips_backbone_path(net, "net." + owner) \
        .split("/", 1)[1]


def _backbone_to_jax(net: str, sd: dict) -> dict:
    with torch.device("meta"):
        module = _backbone_module(net)
    return _tree(sd, _module_keys(module, _backbone_path(net)), ("params",))


def alexnet_to_jax(sd: dict) -> dict:
    """torchvision's alexnet state dict -> ``convert_alexnet``'s tree."""
    return _backbone_to_jax("alex", sd)


def vgg16_features_to_jax(sd: dict) -> dict:
    """torchvision's vgg16 state dict -> ``convert_vgg16_features``'s
    tree."""
    return _backbone_to_jax("vgg", sd)


def squeeze_features_to_jax(sd: dict) -> dict:
    """torchvision's squeezenet1_1 state dict ->
    ``convert_squeeze_features``'s tree."""
    return _backbone_to_jax("squeeze", sd)


def lpips_to_jax(lin_sd: dict, backbone_sd: dict | None = None,
                 net: str = "alex") -> dict:
    """An LPIPS lin-head file (``lin{i}.model.1.weight``, 5 heads for alex
    / vgg, 7 for squeeze) and optionally its torchvision backbone ->
    ``convert_lpips``'s tree: the heads flattened to (C,), the backbone
    under ``net``."""
    lin_sd = strip_module(lin_sd)
    params = {}
    while f"lin{len(params)}.model.1.weight" in lin_sd:
        i = len(params)
        params[f"lin{i}"] = _host(lin_sd[f"lin{i}.model.1.weight"]) \
            .reshape(-1)
    if len(params) not in (5, 7):
        raise ValueError(f"unexpected lin head count {len(params)}")
    if backbone_sd is not None:
        params[net] = _backbone_to_jax(net, backbone_sd)["params"]
    return {"params": params}


def mtcnn_to_jax(sds: dict) -> dict:
    """{'pnet', 'rnet', 'onet'} state dicts -> ``convert_mtcnn``'s tree."""
    from impersonator_tpu_torch.metrics import mtcnn
    classes = {"pnet": mtcnn.PNet, "rnet": mtcnn.RNet, "onet": mtcnn.ONet}
    return {name: _tree(strip_module(sd),
                        _module_keys(_template(classes[name]), _mtcnn_path),
                        ("params",))
            for name, sd in sds.items()}


# ``tools/convert_weights``' kinds: (reference state dict -> flax tree)
TO_JAX = {
    "hmr": hmr_to_jax, "gen": generator_to_jax, "bgnet": bgnet_to_jax,
    "vgg19": vgg19_to_jax, "sphere": sphere_to_jax,
    "senet50": senet50_to_jax, "osnet": osnet_to_jax, "pcb": pcb_to_jax,
    "facenet_ir": facenet_ir_to_jax, "alexnet": alexnet_to_jax,
    "vgg16_features": vgg16_features_to_jax,
    "squeeze_features": squeeze_features_to_jax, "lpips": lpips_to_jax,
    "inception": inception_to_jax, "mtcnn": mtcnn_to_jax,
}


# --------------------------------------------------------------------------
# released files -> the port's modules
# --------------------------------------------------------------------------
#
# The port's modules carry the reference's keys, so a state dict holding
# exactly the tensors ``tools/convert_weights`` reads loads into them with
# ``load_state_dict(strict=True)``: HMR, the generator, DeepFill, SENet50
# (its pickle without the ``fc`` head, as the converter's loader reads
# it) and MTCNN's three nets. A released file with heads the converter
# leaves out (Sphere20a's fc6, torchvision's classifiers and features past
# the last conv the port holds, InceptionV3's AuxLogits, InceptionResnetV1's
# logits, OSNet's classifier, PCB's classifiers, an LPIPS file of lin
# heads alone) loads through its ``*_from_reference``, which maps the file
# to the JAX tree and that back onto the module's keys, so what it keeps
# is what the converter keeps.


def sphere20a_from_reference(sd: dict) -> dict:
    """sphere20a's state dict -> the port's Sphere20a (fc6 dropped)."""
    return sphere20a_state_dict_from_jax(sphere_to_jax(sd))


def vgg19_from_reference(sd: dict) -> dict:
    """torchvision's vgg19 state dict -> the port's Vgg19 (the first 13
    convs)."""
    return vgg19_state_dict_from_jax(vgg19_to_jax(sd))


def inception_from_reference(sd: dict) -> dict:
    """torchvision's inception_v3 state dict -> ``metrics.zoo.
    InceptionV3`` (AuxLogits dropped)."""
    return inception_state_dict_from_jax(inception_to_jax(sd))


def facenet_ir_from_reference(sd: dict) -> dict:
    """InceptionResnetV1's state dict -> ``metrics.zoo.InceptionResnetV1``
    (logits dropped)."""
    return facenet_ir_state_dict_from_jax(facenet_ir_to_jax(sd))


def osnet_from_reference(sd: dict) -> dict:
    """osnet_ibn_x1_0's state dict -> ``metrics.reid.OSNet`` (the
    classifier dropped)."""
    return osnet_state_dict_from_jax(osnet_to_jax(sd))


def pcb_from_reference(sd: dict) -> dict:
    """pcb_net_last.pth's state dict -> ``metrics.reid.PCBReid`` (the
    classifiers and the backbone's fc dropped)."""
    return pcb_state_dict_from_jax(pcb_to_jax(sd))


def backbone_from_reference(kind: str):
    """The loader of a torchvision backbone file (``alexnet``,
    ``vgg16_features``, ``squeeze_features``: the features the port's
    module holds, the classifier dropped)."""
    return lambda sd: FROM_JAX[kind](TO_JAX[kind](sd))


def lpips_from_reference(lin_sd: dict, backbone_sd: dict | None = None,
                         net: str = "alex") -> dict:
    """An LPIPS lin-head file and optionally its torchvision backbone ->
    ``metrics.zoo.LPIPS(net)``'s keys (the lin keys alone without a
    backbone, for ``cli.evaluate.load_lpips``' seeded one)."""
    return lpips_state_dict_from_jax(lpips_to_jax(lin_sd, backbone_sd, net),
                                     net)


def reference_state_dict(kind: str, sd):
    """A released file's state dict (``tools/convert_weights``' kinds;
    for ``mtcnn`` the {'pnet', 'rnet', 'onet'} dicts) -> the state dict
    that loads strictly into the port's module of that kind
    (:func:`reference_module`), ``module.`` prefixes stripped: the file
    as it is for the nets that hold every tensor of it, else what the
    ``FROM_REFERENCE`` loader gives (``FROM_JAX`` of ``TO_JAX``)."""
    if kind == "mtcnn":
        return {name: strip_module(s) for name, s in sd.items()}
    if kind in FROM_REFERENCE:
        return FROM_REFERENCE[kind](sd)
    return strip_module(sd)


def reference_module(kind: str, sd=None):
    """The port's module (CPU, default init) that a ``kind`` file loads
    into; the generator's and DeepFill's widths come from ``sd``. For
    ``mtcnn`` a {'pnet', 'rnet', 'onet'} dict of modules."""
    from impersonator_tpu_torch.metrics import mtcnn, reid, zoo
    from impersonator_tpu_torch.models import facenet, hmr, inpaintor, losses
    if kind == "gen":
        from impersonator_tpu_torch.models.generator import \
            ImpersonatorGenerator
        sd = strip_module(sd)
        return ImpersonatorGenerator(
            bg_dim=sd["bg_model.model.0.weight"].shape[1],
            src_dim=sd["src_model.encoders.0.0.weight"].shape[1],
            tsf_dim=sd["tsf_model.encoders.0.0.weight"].shape[1],
            conv_dim=sd["tsf_model.encoders.0.0.weight"].shape[0],
            repeat_num=_count(sd, r"tsf_model\.resnets\.\d+\.main\.0\.weight"),
            n_down=_count(sd, r"tsf_model\.decoders\.\d+\.0\.weight"))
    if kind == "bgnet":
        w = strip_module(sd)["coarse_net.0.conv2d.weight"]
        return inpaintor.InpaintSANet(c_dim=w.shape[1], cnum=w.shape[0])
    if kind == "mtcnn":
        return {"pnet": mtcnn.PNet(), "rnet": mtcnn.RNet(),
                "onet": mtcnn.ONet()}
    return {"hmr": hmr.HumanModelRecovery, "sphere": facenet.Sphere20a,
            "senet50": facenet.SENet50, "vgg19": losses.Vgg19,
            "inception": zoo.InceptionV3,
            "facenet_ir": zoo.InceptionResnetV1, "osnet": reid.OSNet,
            "pcb": reid.PCBReid, "alexnet": zoo.AlexFeatures,
            "vgg16_features": zoo.VGG16Features,
            "squeeze_features": zoo.SqueezeFeatures}[kind]()


def _backbone_from_jax(kind: str):
    return lambda tree: _from_module(reference_module(kind), tree,
                                     _backbone_path(_BACKBONE_KINDS[kind]))


# the inverse of each TO_JAX entry, onto the port module's keys
FROM_JAX = {
    "hmr": hmr_state_dict_from_jax, "gen": generator_state_dict_from_jax,
    "bgnet": inpaintor_state_dict_from_jax,
    "vgg19": vgg19_state_dict_from_jax,
    "sphere": sphere20a_state_dict_from_jax,
    "senet50": senet50_state_dict_from_jax,
    "osnet": osnet_state_dict_from_jax, "pcb": pcb_state_dict_from_jax,
    "facenet_ir": facenet_ir_state_dict_from_jax,
    "inception": inception_state_dict_from_jax,
    "mtcnn": mtcnn_state_dicts_from_jax, "lpips": lpips_state_dict_from_jax,
    **{kind: _backbone_from_jax(kind) for kind in _BACKBONE_KINDS},
}


# the kinds whose released files load through a named loader (the
# others load as they are, ``module.`` prefixes stripped)
FROM_REFERENCE = {
    "sphere": sphere20a_from_reference, "vgg19": vgg19_from_reference,
    "inception": inception_from_reference,
    "facenet_ir": facenet_ir_from_reference, "osnet": osnet_from_reference,
    "pcb": pcb_from_reference, "lpips": lpips_from_reference,
    **{kind: backbone_from_reference(kind) for kind in _BACKBONE_KINDS},
}
