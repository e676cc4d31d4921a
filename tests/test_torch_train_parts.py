"""The trainer's parts against the JAX package on the CPU: PatchGAN, the
generator's training forward, body_recovery_flow, the synthetic dataset
and the loader's index stream, the flax msgpack reader and the Adam
state converter, and the port's own checkpoints and visualizer.

Shapes are small (64², conv_dim 8, batch 2); tolerances are stated at
each test. The port's raster runs the bucket kernels' plain twins, the
JAX package its brute path: fim is equal and T within 1e-3 (the
reference's CPU FMA contraction, ROADMAP.md)."""

import json
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from impersonator_tpu.data import loader as jloader
from impersonator_tpu.data.datasets import SyntheticPairDataset as JSynth
from impersonator_tpu.models.discriminator import \
    PatchDiscriminator as JDisc
from impersonator_tpu.models.generator import ImpersonatorGenerator as JGen
from impersonator_tpu.ops import smpl as jsmpl
from impersonator_tpu.tasks import trainer as JT
from impersonator_tpu.tasks.renderer import SMPLRenderer as JRenderer
from impersonator_tpu.utils import checkpoint as jckpt
from flax import serialization
from impersonator_tpu_torch import assets as tassets
from impersonator_tpu_torch.config import TrainConfig as TCfg
from impersonator_tpu_torch.data import datasets as tdata
from impersonator_tpu_torch.data import loader as tloader
from impersonator_tpu_torch.models.discriminator import \
    PatchDiscriminator as TDisc
from impersonator_tpu_torch.models.generator import \
    ImpersonatorGenerator as TGen
from impersonator_tpu_torch.ops import smpl as tsmpl
from impersonator_tpu_torch.tasks import trainer as TT
from impersonator_tpu_torch.tasks.renderer import SMPLRenderer as TRenderer
from impersonator_tpu_torch.utils import checkpoint as tckpt
from impersonator_tpu_torch.utils import convert
from impersonator_tpu_torch.utils.visualizer import Visualizer
from tools import convert_weights as cw

from train_ref import (CONV_DIM, REPEAT, S, gen_sd, nchw, np_tree,
                       port_inputs, rel)
from torch_threads import one_torch_thread  # noqa: F401


# -- networks -----------------------------------------------------------------

@pytest.mark.parametrize("norm", ["instance", "batch"])
@pytest.mark.parametrize("n_layers", [2, 4])
def test_discriminator_matches_jax(norm, n_layers):
    """PatchGAN at 64² from the JAX params (norm scales, biases and
    BatchNorm statistics perturbed off their init): the output within
    1e-5 of its largest magnitude, in train() and eval() alike (the JAX
    step applies BatchNorm with its running statistics)."""
    rng = np.random.default_rng(n_layers)
    jd = JDisc(ndf=64, n_layers=n_layers, norm_type=norm)
    params = np_tree(jax.jit(jd.init)(jax.random.PRNGKey(n_layers),
                                      jnp.zeros((1, S, S, 6))))

    def perturb(path, v):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if name in ("bias", "mean") and "conv" not in str(path):
            return rng.normal(0, 0.1, v.shape).astype(np.float32)
        return v
    params = jax.tree_util.tree_map_with_path(perturb, params)
    x = rng.uniform(-1, 1, (2, S, S, 6)).astype(np.float32)
    out_j = np.asarray(jax.jit(jd.apply)(params, jnp.asarray(x)))
    td = TDisc(6, 64, n_layers, norm)
    td.load_state_dict(convert.discriminator_state_dict_from_jax(params),
                       strict=True)
    with torch.no_grad():
        outs = [td.train(mode)(nchw(x)).permute(0, 2, 3, 1).numpy()
                for mode in (True, False)]
    assert outs[0].shape == out_j.shape == (2, *([S // 2 ** n_layers - 2]
                                                  * 2), 1)
    np.testing.assert_array_equal(outs[0], outs[1])
    assert rel(outs[0], out_j) <= 1e-5
    if norm == "batch":   # no conv bias before a BatchNorm
        assert td.model[2].bias is None and td.model[0].bias is not None


def test_generator_training_forward_matches_jax():
    """ImpersonatorGenerator.forward (run_bg + infer_front) and
    ResUnetGenerator.forward at 64², conv_dim 8, 2 residual blocks, from
    the same reference-layout weights: every output within 1e-4 of the
    JAX output's largest magnitude."""
    sd = gen_sd()
    rng = np.random.default_rng(3)
    bg = rng.uniform(-1, 1, (2, S, S, 4)).astype(np.float32)
    src = rng.uniform(-1, 1, (2, S, S, 6)).astype(np.float32)
    tsf = rng.uniform(-1, 1, (2, S, S, 6)).astype(np.float32)
    t = rng.uniform(-1.1, 1.1, (2, S, S, 2)).astype(np.float32)
    t[:, :8] = -2.0                                  # background rows
    jg = JGen(bg_dim=4, src_dim=6, tsf_dim=6, conv_dim=CONV_DIM,
              repeat_num=REPEAT)
    params = cw.convert_generator(sd, repeat=REPEAT)
    outs_j = jax.jit(jg.apply)(params, *map(jnp.asarray, (bg, src, tsf, t)))
    tg = TGen(conv_dim=CONV_DIM, repeat_num=REPEAT)
    tg.load_state_dict(sd, strict=True)
    with torch.no_grad():
        outs_t = tg(nchw(bg), nchw(src), nchw(tsf), torch.from_numpy(t))
        unet_t = tg.src_model(nchw(src))
    unet_j = jax.jit(lambda p, x: jg.apply(
        p, x, method=lambda m, y: m.src_model(y)))(params, jnp.asarray(src))
    assert len(outs_t) == len(outs_j) == 5
    for a, b in zip((*outs_t, *unet_t), (*outs_j, *unet_j)):
        a = a.permute(0, 2, 3, 1).numpy()
        assert a.shape == b.shape
        assert rel(a, b) <= 1e-4


# -- body_recovery_flow -------------------------------------------------------

@pytest.fixture(scope="module")
def renderers(assets):
    jr = JRenderer.create(assets, image_size=S)
    ta = tassets.synthetic_assets()
    tr = TRenderer.create(ta, "cpu", image_size=S)
    return (jr, jsmpl.SMPLParams.from_assets(assets),
            tr, tsmpl.SMPLParams.from_assets(ta, "cpu"), assets.parents)


@pytest.mark.parametrize("bg_both", [False, True])
def test_body_recovery_flow_matches_jax(renderers, bg_both):
    """The frozen preprocessing on synthetic pairs: the fim-derived maps
    (conditioning, crop and background masks) equal, T within 1e-3 (the
    raster bound), the boxes within 1e-5, the masked images within 1e-6,
    and the warped source within T's gap through a warp of per-pixel
    noise (1e-2, as tests/test_torch_slice.py bounds it)."""
    jr, jp, tr, tp, parents = renderers
    ds = JSynth(S)
    items = [ds[i] for i in range(2)]
    imgs = np.stack([it["images"] for it in items])
    smpls = np.stack([it["smpls"] for it in items])
    fn = jax.jit(lambda a, b, c, d: JT.body_recovery_flow(
        jr, jp, parents, a, b, c, d, bg_both=bg_both))
    out_j = fn(*map(jnp.asarray, (imgs[:, 0], imgs[:, 1], smpls[:, 0],
                                  smpls[:, 1])))
    out_j = port_inputs(out_j)
    out_t = TT.body_recovery_flow(
        tr, tp, parents, nchw(imgs[:, 0]), nchw(imgs[:, 1]),
        torch.from_numpy(smpls[:, 0]), torch.from_numpy(smpls[:, 1]),
        bg_both=bg_both)
    assert set(out_t) == set(out_j)
    assert (out_t["input_G_tsf_bg"] is None) == (not bg_both)
    for k, v in out_t.items():
        if v is None:
            continue
        assert tuple(v.shape) == tuple(out_j[k].shape), k
        assert not v.requires_grad
    assert float(out_t["src_crop_mask"].mean()) > 0.01
    exact = ["src_crop_mask", "tsf_crop_mask"]
    for k in exact:
        assert torch.equal(out_t[k], out_j[k]), k
    for k in ("input_G_src", "input_G_tsf"):
        assert torch.equal(out_t[k][:, 3:], out_j[k][:, 3:]), k
    bgs = ["input_G_bg"] + (["input_G_tsf_bg"] if bg_both else [])
    for k in bgs:
        assert torch.equal(out_t[k][:, 3:], out_j[k][:, 3:]), k
        np.testing.assert_allclose(out_t[k].numpy(), out_j[k].numpy(),
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(out_t["input_G_src"].numpy(),
                               out_j["input_G_src"].numpy(), atol=1e-6)
    np.testing.assert_allclose(out_t["T"].numpy(), out_j["T"].numpy(),
                               atol=1e-3)
    np.testing.assert_allclose(out_t["input_G_tsf"][:, :3].numpy(),
                               out_j["input_G_tsf"][:, :3].numpy(),
                               atol=1e-2)
    for k in ("head_bbox", "body_bbox"):
        np.testing.assert_allclose(out_t[k].numpy(), out_j[k].numpy(),
                                   atol=1e-5, err_msg=k)


# -- data ---------------------------------------------------------------------

def test_synthetic_dataset_matches_jax():
    """Every item bit for bit, with and without a background, for two
    seeds; the registry's synthetic entries, and the readers of data on
    disk doing what JAX's do where the configured folders do not exist:
    iPER raises for its split file, DeepFashion and Places2 are empty
    (tests/test_torch_datasets.py reads real trees)."""
    for seed in (0, 3):
        for with_bg in (False, True):
            jd = JSynth(32, length=5, seed=seed, with_bg=with_bg)
            td = tdata.SyntheticPairDataset(32, length=5, seed=seed,
                                            with_bg=with_bg)
            assert len(td) == len(jd) == 5
            for i in range(5):
                a, b = td[i], jd[i]
                assert set(a) == set(b)
                for k in a:
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])
    cfg = TCfg(image_size=16)
    assert tdata.dataset_by_name("synthetic_bg", cfg)[0]["bg"].shape == \
        (16, 16, 3)
    cfg = TCfg(image_size=16, data_dir="/nonexistent/iPER",
               fashion_dir="/nonexistent/fashion",
               place_dir="/nonexistent/places")
    with pytest.raises(FileNotFoundError, match="train.txt"):
        tdata.dataset_by_name("iPER", cfg, device="cpu")
    for name in ("fashion", "place"):
        assert len(tdata.dataset_by_name(name, cfg, device="cpu")) == 0
    with pytest.raises(ValueError):
        tdata.dataset_by_name("nope", cfg)


@pytest.mark.parametrize("shards", [(0, 1), (1, 2)])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_index_stream_matches_jax(shards, drop_last):
    """Two epochs of the host loader (device None) against the JAX
    loader on the same dataset, seed and shard: the same batches in the
    same order, bit for bit, and the same length."""
    ds = tdata.SyntheticPairDataset(4, length=11, seed=1)
    kw = dict(batch_size=3, seed=4, drop_last=drop_last,
              shard_index=shards[0], shard_count=shards[1], num_workers=3)
    tl = tloader.DataLoader(ds, **kw)
    jl = jloader.DataLoader(JSynth(4, length=11, seed=1), **kw)
    assert len(tl) == len(jl)
    for _ in range(2):
        bt, bj = list(tl), list(jl)
        assert len(bt) == len(bj) > 0
        for a, b in zip(bt, bj):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])


def test_loader_stages_nchw_on_the_device():
    """With a device, batches come as tensors there: images (B, 2, 3, S, S)
    and bg (B, 3, S, S) from the NHWC items, θs as they are."""
    ds = tdata.SyntheticPairDataset(8, length=4, with_bg=True)
    host = next(iter(tloader.DataLoader(ds, 2, shuffle=False)))
    dev = next(iter(tloader.DataLoader(ds, 2, shuffle=False, device="cpu")))
    assert dev["images"].shape == (2, 2, 3, 8, 8)
    assert dev["bg"].shape == (2, 3, 8, 8)
    np.testing.assert_array_equal(dev["images"].permute(0, 1, 3, 4, 2),
                                  host["images"])
    np.testing.assert_array_equal(dev["bg"].permute(0, 2, 3, 1), host["bg"])
    np.testing.assert_array_equal(dev["smpls"], host["smpls"])


class _Broken(tdata.SyntheticPairDataset):
    def __getitem__(self, idx):
        if idx == 5:
            raise OSError("unreadable item 5")
        return super().__getitem__(idx)


def test_loader_raises_a_worker_error():
    """An item that fails to load raises in the consumer, after the
    batches before it, instead of leaving the loop waiting."""
    loader = tloader.DataLoader(_Broken(4, length=8), 2, shuffle=False,
                                num_workers=2)
    got = []
    with pytest.raises(OSError, match="item 5"):
        for b in loader:
            got.append(b)
    assert len(got) == 2


# -- flax msgpack and the optimiser state ------------------------------------

def _assert_trees_equal(a, b):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b)
        for k in b:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (a, b)


def test_read_flax_msgpack_matches_flax(tmp_path):
    """A tree of every kind flax writes (arrays of several dtypes and
    ranks, numpy scalars, ints over every msgpack width, floats, bool,
    None, str, bytes, lists, empty and long maps) and the files of the
    JAX checkpoint module (a generator and its optax state): equal to
    flax.serialization.msgpack_restore, element for element. bfloat16
    arrays come back widened to float32."""
    rng = np.random.default_rng(0)
    tree = {
        "f32": rng.normal(size=(3, 4, 5)).astype(np.float32),
        "f64": rng.normal(size=(2,)), "i8": np.arange(-3, 3, dtype=np.int8),
        "u16": np.arange(5, dtype=np.uint16), "i64": np.int64(-7),
        "scalar0d": np.asarray(2.5, np.float32), "empty": np.zeros((0, 3)),
        "bool_arr": np.array([True, False]), "npf": np.float32(1.25),
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32,
                 -33, -128, -129, -32768, -32769, -2 ** 31 - 1],
        "float": 0.1, "true": True, "false": False, "none": None,
        "text": "ü" * 40, "blob": b"\x00\x01" * 200, "nested": {},
        "wide": {f"k{i}": i for i in range(20)},
        "long": list(range(20)),
    }
    path = tmp_path / "tree.msgpack"
    path.write_bytes(serialization.msgpack_serialize(tree))
    _assert_trees_equal(tckpt.read_flax_msgpack(str(path)),
                        serialization.msgpack_restore(path.read_bytes()))
    bf = jnp.asarray(rng.normal(size=(4, 3)), jnp.bfloat16)
    path.write_bytes(serialization.to_bytes({"w": bf}))
    np.testing.assert_array_equal(tckpt.read_flax_msgpack(str(path))["w"],
                                  np.asarray(bf.astype(jnp.float32)))

    params = cw.convert_generator(gen_sd(), repeat=REPEAT)
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=2e-4, b1=0.5)
    opt = tx.init(params)
    _, opt = tx.update(jax.tree_util.tree_map(jnp.ones_like, params), opt,
                       params)
    jckpt.save_network(params, str(tmp_path), "G", 3)
    jckpt.save_optimizer(opt, str(tmp_path), "G", 3)
    for kind in ("net", "opt"):
        p = tmp_path / f"{kind}_epoch_3_id_G.msgpack"
        _assert_trees_equal(tckpt.read_flax_msgpack(str(p)),
                            serialization.msgpack_restore(p.read_bytes()))


def test_jax_generator_file_runs_in_the_port(tmp_path):
    """A generator saved by the JAX package's save_network, read with
    read_flax_msgpack and converted: the port's training forward equals
    the JAX one within 1e-4 of its largest magnitude."""
    jg = JGen(bg_dim=4, src_dim=6, tsf_dim=6, conv_dim=CONV_DIM,
              repeat_num=REPEAT)
    rng = np.random.default_rng(9)
    xs = [rng.uniform(-1, 1, (1, S, S, c)).astype(np.float32)
          for c in (4, 6, 6)]
    t = rng.uniform(-1, 1, (1, S, S, 2)).astype(np.float32)
    params = jax.jit(jg.init)(jax.random.PRNGKey(2), *map(jnp.asarray,
                                                           (*xs, t)))
    jckpt.save_network(params, str(tmp_path), "G", 1)
    tree = tckpt.read_flax_msgpack(str(tmp_path / "net_epoch_1_id_G.msgpack"))
    tg = TGen(conv_dim=CONV_DIM, repeat_num=REPEAT)
    tg.load_state_dict(convert.generator_state_dict_from_jax(tree),
                       strict=True)
    outs_j = jax.jit(jg.apply)(params, *map(jnp.asarray, (*xs, t)))
    with torch.no_grad():
        outs_t = tg(*map(nchw, xs), torch.from_numpy(t))
    for a, b in zip(outs_t, outs_j):
        assert rel(a.permute(0, 2, 3, 1).numpy(), b) <= 1e-4


def test_adam_state_from_optax_continues_the_jax_trajectory():
    """Two optax inject_hyperparams(adam) updates (β 0.5 / 0.999, lr
    injected as 3e-4) of a PatchGAN's params, the state converted into
    torch.optim.Adam: a third update with the same gradient gives the
    same params within 1e-6 (relative to the update, 1e-3)."""
    jd = JDisc(ndf=8, n_layers=2, norm_type="instance")
    params = np_tree(jax.jit(jd.init)(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 32, 32, 6))))
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=2e-4, b1=0.5,
                                              b2=0.999)
    state = tx.init(params)
    state.hyperparams["learning_rate"] = jnp.asarray(3e-4, jnp.float32)
    rng = np.random.default_rng(1)
    grads = [jax.tree_util.tree_map(
        lambda v: rng.normal(0, 1e-2, v.shape).astype(np.float32), params)
        for _ in range(3)]
    for g in grads[:2]:
        upd, state = tx.update(g, state, params)
        params = np_tree(optax.apply_updates(params, upd))
    upd, _ = tx.update(grads[2], state, params)
    final = np_tree(optax.apply_updates(params, upd))

    td = TDisc(6, 8, 2, "instance")
    td.load_state_dict(convert.discriminator_state_dict_from_jax(params))
    opt = TT.adam(td.parameters(), 2e-4, 0.5, 0.999)
    sd = convert.adam_state_dict_from_optax(
        serialization.to_state_dict(np_tree(state)),
        convert.discriminator_state_dict_from_jax, td, opt)
    opt.load_state_dict(sd)
    assert opt.param_groups[0]["lr"] == pytest.approx(3e-4)
    g_t = convert.discriminator_state_dict_from_jax(grads[2])
    for n, p in td.named_parameters():
        p.grad = g_t[n]
    opt.step()
    want = convert.discriminator_state_dict_from_jax(final)
    before = convert.discriminator_state_dict_from_jax(params)
    for n, p in td.named_parameters():
        gap = float((p.detach() - want[n]).abs().max())
        assert gap <= 1e-6, n
        assert gap <= 1e-3 * float((want[n] - before[n]).abs().max()), n


# -- the port's checkpoints and logs ------------------------------------------

def _tiny_state(seed):
    cfg = TCfg(image_size=S, repeat_num=1, d_layers=2, use_vgg=False,
               use_face=False)
    tr = TT.build_trainer(cfg, tassets.synthetic_assets(), device="cpu")
    g = TGen(conv_dim=4, repeat_num=1)
    torch.manual_seed(seed)
    st = tr.init_state(g, TDisc(6, 4, 2), seed=seed)
    for opt, net in ((st.g_opt, st.generator), (st.d_opt, st.discriminator)):
        for p in net.parameters():
            p.grad = torch.randn_like(p)
        opt.step()
    return tr, st


def test_checkpoint_round_trip_and_async(tmp_path):
    """save_train_state / load_train_state restore every weight and Adam
    moment bit for bit, under the reference's names with the .pth
    suffix; AsyncCheckpointer writes a snapshot taken at submit (later
    in-place updates do not leak in), a second submit for the same epoch
    supersedes a queued one, and latest_epoch / resolve_load_epoch find
    the newest epoch."""
    tr, a = _tiny_state(0)
    _, b = _tiny_state(1)
    d = str(tmp_path / "exp")
    tckpt.save_train_state(a, d, 2)
    assert sorted(os.listdir(d)) == sorted(
        f"{k}_epoch_2_id_{l}.pth" for k in ("net", "opt") for l in "GD")
    tckpt.load_train_state(b, d, 2)
    for x, y in ((a.generator, b.generator),
                 (a.discriminator, b.discriminator)):
        for (n, p), (_, q) in zip(x.state_dict().items(),
                                  y.state_dict().items()):
            assert torch.equal(p, q), n
    for oa, ob in ((a.g_opt, b.g_opt), (a.d_opt, b.d_opt)):
        sa, sb = oa.state_dict()["state"], ob.state_dict()["state"]
        assert sa.keys() == sb.keys()
        for i in sa:
            for k in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(sa[i][k], sb[i][k])

    saver = tckpt.AsyncCheckpointer()
    snap = {k: v.clone() for k, v in a.generator.state_dict().items()}
    saver.submit(a, d, 5)
    with torch.no_grad():
        for p in a.generator.parameters():
            p.add_(1.0)
    saver.submit(a, d, "latest")
    saver.submit(a, d, "latest")
    saver.close()
    got = torch.load(os.path.join(d, "net_epoch_5_id_G.pth"))
    for k, v in snap.items():
        assert torch.equal(got[k], v), k
    assert tckpt.latest_epoch(d) == 5
    cfg = TCfg(checkpoints_dir=str(tmp_path), name="exp")
    assert cfg.resolve_load_epoch() == 5
    assert TCfg(checkpoints_dir=str(tmp_path), name="none"
                ).resolve_load_epoch() == 0
    with pytest.raises(FileNotFoundError):
        tckpt.load_train_state(b, d, 7)


def test_resume_skips_a_partial_epoch_and_tmp_files(tmp_path):
    """A crash during a save leaves a ``.pth.tmp`` and an epoch without
    all four files: latest_epoch and resolve_load_epoch (the CLI's
    --load_epoch -1) take the last complete epoch, which loads."""
    _, a = _tiny_state(0)
    _, b = _tiny_state(1)
    d = tmp_path / "exp"
    tckpt.save_train_state(a, str(d), 3)
    tckpt.save_network(a.generator, str(d), "G", 4)   # D, opts never written
    (d / "net_epoch_5_id_G.pth.tmp").write_bytes(b"truncated")
    for n in ("net_epoch_6_id_G.pth.tmp", "net_epoch_6_id_D.pth",
              "opt_epoch_6_id_G.pth", "opt_epoch_6_id_D.pth"):
        (d / n).write_bytes(b"")
    assert tckpt.latest_epoch(str(d)) == 3
    cfg = TCfg(checkpoints_dir=str(tmp_path), name="exp")
    assert cfg.resolve_load_epoch() == 3
    tckpt.load_train_state(b, str(d), cfg.resolve_load_epoch())
    for (n, p), (_, q) in zip(a.generator.state_dict().items(),
                              b.generator.state_dict().items()):
        assert torch.equal(p, q), n


def _read_png(path):
    """Decode this writer's PNGs (8-bit RGB, filter 0) with zlib."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            size = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = size
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


def test_visualizer_writes_png_and_jsonl(tmp_path, capsys):
    """save_images writes a batch as a horizontal strip of PNG pixels
    ((x + 1) / 2 · 255, clipped), a one-channel map as grey RGB, and
    cv2 reads the same pixels; log_scalars appends JSON lines;
    print_current_errors prints the losses; the timers count."""
    import cv2
    vis = Visualizer(str(tmp_path))
    rng = np.random.default_rng(0)
    img = rng.uniform(-1.2, 1.2, (2, 5, 7, 3)).astype(np.float32)
    mask = torch.from_numpy(rng.uniform(-1, 1, (4, 6, 1))
                            .astype(np.float32))
    paths = vis.save_images(12, {"a": img, "m": mask})
    want = ((np.concatenate(list(img), 1) + 1) / 2 * 255).clip(0, 255) \
        .astype(np.uint8)
    np.testing.assert_array_equal(_read_png(paths[0]), want)
    np.testing.assert_array_equal(cv2.imread(paths[0])[..., ::-1], want)
    grey = _read_png(paths[1])
    assert grey.shape == (4, 6, 3) and (grey == grey[..., :1]).all()
    assert os.path.basename(paths[0]) == "00000012_a.png"
    vis.log_scalars(3, 1, {"g_total": torch.tensor(1.5)})
    vis.log_scalars(4, 1, {"d_loss": 0.25}, phase="val")
    recs = [json.loads(l) for l in open(tmp_path / "loss_log.jsonl")]
    assert [r["phase"] for r in recs] == ["train", "val"]
    assert recs[0]["g_total"] == 1.5 and recs[1]["step"] == 4
    vis.print_current_errors(1, 3, {"g_total": 1.5}, 0.01)
    assert "g_total:1.5000" in capsys.readouterr().out
    with vis.timer("step"):
        pass
    assert vis.timer_summary()["step"]["count"] == 1
