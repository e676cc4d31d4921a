"""The port's metric nets against the JAX package's on the CPU at batch
1: LPIPS over each backbone with each of the six lin-head files in the
repository, and the embed functions over InceptionV3 (299²),
InceptionResnetV1 (head crops at 160²), SENet50 (224²), Sphere20a
(112×96), OSNet (256×128), PCB (384×192) and a VGG19 feature net. Seeded
weights in the reference's key layout (``tests/torch_ref.py``) load into
the port's modules as they are; the JAX package gets them through
``tools/convert_weights.py``, and the port's converters
(``utils/convert.py``) must give the same state dict back. Each output
within 1e-4 of the JAX output's largest magnitude."""

import os

import jax
import numpy as np
import pytest
import torch

from impersonator_tpu.metrics import reid as JR
from impersonator_tpu.metrics import unpaired as JU
from impersonator_tpu.metrics import zoo as JZ
from impersonator_tpu.models import losses as jL
from impersonator_tpu_torch.metrics import reid as TR
from impersonator_tpu_torch.metrics import unpaired as TU
from impersonator_tpu_torch.metrics import zoo as TZ
from impersonator_tpu_torch.models import facenet as tface
from impersonator_tpu_torch.models import losses as tL
from impersonator_tpu_torch.utils import convert
from impersonator_tpu_torch.utils.checkpoint import read_flax_msgpack
from tools import convert_weights as cw

import torch_ref
from torch_threads import one_torch_thread  # noqa: F401

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "impersonator_tpu",
                       "weights")


def _rel(a, b) -> float:
    """max |a - b| / max |b|."""
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _loaded(module, sd, back_fn, tree):
    """``module`` with the reference-layout ``sd`` (strict), after checking
    that the port's converter maps the JAX tree back onto the same
    state dict."""
    module.load_state_dict(sd, strict=True)
    back = back_fn(tree)
    want = module.state_dict()
    assert set(back) == set(want)
    for k, v in want.items():
        assert torch.equal(back[k].to(v.dtype), v), k
    return module.eval()


_BACKBONES = {"alex": (torch_ref.make_alexnet_sd, cw.convert_alexnet),
              "vgg": (torch_ref.make_vgg16_sd, cw.convert_vgg16_features),
              "squeeze": (torch_ref.make_squeeze_sd,
                          cw.convert_squeeze_features)}


@pytest.mark.parametrize("net", ["alex", "vgg", "squeeze"])
def test_lpips_with_the_repository_lin_heads_matches_jax(net):
    """LPIPS(net) with the v0.0 and the v0.1 lin heads of the repository
    (read by the port's msgpack reader, converted by
    ``lpips_state_dict_from_jax``) over a seeded backbone: distances of
    two pairs at 64² within 1e-4 relative; identical images at 0."""
    make_sd, conv_backbone = _BACKBONES[net]
    backbone = make_sd(np.random.default_rng(21))
    rng = np.random.default_rng(22)
    a = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    jnet = JZ.LPIPS(net=net)
    apply = jax.jit(jnet.apply)
    for version in ("v00", "v01"):
        tree = read_flax_msgpack(os.path.join(
            WEIGHTS, f"lpips_{version}_{net}_lin.msgpack"))
        lin_only = convert.lpips_state_dict_from_jax(tree, net)
        assert sorted(lin_only) == [f"lin{i}.model.1.weight"
                                    for i in range(len(tree["params"]))]
        tree["params"][net] = conv_backbone(backbone)["params"]
        sd = {**lin_only, **{f"net.{k}": v for k, v in backbone.items()}}
        model = _loaded(TZ.LPIPS(net), sd,
                        lambda t: convert.lpips_state_dict_from_jax(t, net),
                        tree)
        want = np.asarray(apply(tree, a, b))
        with torch.no_grad():
            got = model(torch.from_numpy(a).permute(0, 3, 1, 2),
                        torch.from_numpy(b).permute(0, 3, 1, 2))
            same = model(torch.from_numpy(a).permute(0, 3, 1, 2),
                         torch.from_numpy(a).permute(0, 3, 1, 2))
        assert got.shape == (2,)
        assert _rel(got, want) <= 1e-4, version
        assert float(same.abs().max()) == 0.0


def _embed_pair(name):
    """(port embed fn, JAX embed fn, takes bboxes) over one seeded set of
    weights."""
    rng = np.random.default_rng(23)
    if name == "inception":
        sd = torch_ref.make_inception_sd(rng)
        tree = cw.convert_inception(sd)
        m = _loaded(TZ.InceptionV3(), sd,
                    convert.inception_state_dict_from_jax, tree)
        return TU.inception_embed_fn(m), JU.inception_embed_fn(tree), False
    if name == "facenet_ir":
        sd = torch_ref.make_facenet_ir_sd(rng)
        tree = cw.convert_facenet_ir(sd)
        m = _loaded(TZ.InceptionResnetV1(), sd,
                    convert.facenet_ir_state_dict_from_jax, tree)
        return TU.facenet_ir_embed_fn(m), JU.facenet_ir_embed_fn(tree), True
    if name == "senet":
        sd = torch_ref.make_senet50_sd(rng)
        tree = cw.convert_senet50(sd)
        m = _loaded(tface.SENet50(), sd, convert.senet50_state_dict_from_jax,
                    tree)
        return TU.senet_face_embed_fn(m), JU.senet_face_embed_fn(tree), False
    if name == "sphere":
        m = tface.init_facenet(tface.Sphere20a(),
                               torch.Generator().manual_seed(24))
        tree = cw.convert_sphere(m.state_dict())
        m = _loaded(m, m.state_dict(), convert.sphere20a_state_dict_from_jax,
                    tree)
        return TU.sphere_face_embed_fn(m), JU.sphere_face_embed_fn(tree), False
    if name == "osnet":
        sd = torch_ref.make_osnet_sd(rng)
        tree = cw.convert_osnet(sd)
        m = _loaded(TR.OSNet(), sd, convert.osnet_state_dict_from_jax, tree)
        return TR.osnet_reid_embed_fn(m), JR.osnet_reid_embed_fn(tree), False
    if name == "pcb":
        sd = torch_ref.make_pcb_sd(rng)
        tree = cw.convert_pcb(sd)
        m = _loaded(TR.PCBReid(), sd, convert.pcb_state_dict_from_jax, tree)
        return TR.pcb_reid_embed_fn(m), JR.pcb_reid_embed_fn(tree), False
    assert name == "vgg"
    m = tL.Vgg19()
    g = torch.Generator().manual_seed(25)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    tree = cw.convert_vgg19(m.state_dict())
    m = _loaded(m, m.state_dict(), convert.vgg19_state_dict_from_jax, tree)
    return (TU.vgg_embed_fn(m), JU.vgg_embed_fn(jL.Vgg19(), tree), False)


@pytest.mark.parametrize("name", ["inception", "facenet_ir", "senet",
                                  "sphere", "osnet", "pcb", "vgg"])
def test_embed_fns_match_jax(name):
    """Each embed function on one 48×40 frame in [-1, 1] (resized, or for
    the face net cropped at a head box, to the net's input): every output
    within 1e-4 of the JAX one's largest magnitude; IS probabilities sum
    to 1."""
    port_fn, jax_fn, crops = _embed_pair(name)
    x = np.random.default_rng(26).uniform(-1, 1, (1, 48, 40, 3)) \
        .astype(np.float32)
    box = np.asarray([[0.2, 0.7, 0.1, 0.6]], np.float32)
    args_t = (torch.from_numpy(x),) + ((torch.from_numpy(box),) if crops
                                       else ())
    args_j = (x,) + ((box,) if crops else ())
    got, want = port_fn(*args_t), jax_fn(*args_j)
    if name == "inception":
        (pool_t, probs_t), (pool_j, probs_j) = got, want
        assert pool_t.shape == (1, 2048) and probs_t.shape == (1, 1000)
        assert _rel(pool_t, pool_j) <= 1e-4
        assert _rel(probs_t, probs_j) <= 1e-4
        assert abs(float(probs_t.sum()) - 1.0) <= 1e-5
    else:
        dim = {"facenet_ir": 512, "senet": 2048, "sphere": 512,
               "osnet": 512, "pcb": 12288, "vgg": 512}[name]
        assert got.shape == (1, dim)
        assert _rel(got, want) <= 1e-4
    if crops:
        whole_t = port_fn(torch.from_numpy(x))
        assert _rel(whole_t, jax_fn(x)) <= 1e-4


def test_pcb_parts_and_embed_match_jax():
    """PCB's six part features (B, 6, 2048) at 96×48 and pcb_embed's
    normalised flatten, against JAX's on the same features."""
    sd = torch_ref.make_pcb_sd(np.random.default_rng(27))
    tree = cw.convert_pcb(sd)
    m = _loaded(TR.PCBReid(), sd, convert.pcb_state_dict_from_jax, tree)
    x = np.random.default_rng(28).normal(size=(1, 96, 48, 3)) \
        .astype(np.float32)
    with torch.no_grad():
        parts_t = m(torch.from_numpy(x).permute(0, 3, 1, 2))
    parts_j = np.asarray(JR.PCBReid().apply(tree, x))
    assert parts_t.shape == (1, 6, 2048)
    assert _rel(parts_t, parts_j) <= 1e-4
    emb_t = TR.pcb_embed(torch.from_numpy(parts_j))
    emb_j = np.asarray(JR.pcb_embed(parts_j))
    assert _rel(emb_t, emb_j) <= 1e-6
