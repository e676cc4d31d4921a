"""Weight bridge from the JAX package's params to this port.

Each function is the exact inverse of a ``tools/convert_weights``
converter: that maps a reference state dict onto the flax tree, this
maps the flax tree back onto the reference key layout the port's
modules use.

* :func:`generator_state_dict_from_jax` inverts ``convert_generator``
  (:class:`..models.generator.ImpersonatorGenerator`): conv kernels
  HWIO -> OIHW, transposed-conv kernels HWIO -> IOHW, instance-norm
  ``scale``/``bias`` -> ``weight``/``bias``;
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
  :class:`..models.losses.Vgg19`).
"""

from __future__ import annotations

import numpy as np
import torch


def _generator_keys(n_down: int, repeat: int):
    """(state-dict key, flax path, kind) of every generator parameter,
    kind in {conv, convt, norm}; follows convert_generator line by line."""
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

    for p in ("src_model", "tsf_model"):
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
    ImpersonatorGenerator state dict (float32 CPU tensors)."""
    params = tree["params"]
    bg = params["bg_model"]
    repeat = sum(k.startswith("res_") for k in bg)
    n_down = sum(k.startswith("down_") for k in bg)
    perm = {"conv": (3, 2, 0, 1), "convt": (2, 3, 0, 1), "norm": None}
    sd = {}
    for key, path, kind in _generator_keys(n_down, repeat):
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


def vgg19_state_dict_from_jax(tree: dict) -> dict:
    """{'params'} flax Vgg19 tree of numpy arrays -> this port's Vgg19
    state dict (float32 CPU tensors)."""
    keys = []
    for ours, idx in enumerate(_VGG_FEATURE_IDS):
        keys.append((f"features.{idx}.weight", "params",
                     f"conv_{ours}/kernel", "conv"))
        keys.append((f"features.{idx}.bias", "params", f"conv_{ours}/bias",
                     "vec"))
    return _state_dict(tree, keys, {"conv": (3, 2, 0, 1), "vec": None})
