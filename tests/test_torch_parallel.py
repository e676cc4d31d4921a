"""The port's ``parallel`` package against the JAX package's on the CPU:
the mesh helpers on the same shapes (the JAX side on the 8 virtual CPU
devices of tests/conftest.py, the port's on a mesh that names the CPU 8
times); ``Imitator(mesh=...)`` against JAX's ``Imitator(mesh=make_mesh())``
on a ragged frame count; a train step of two gloo processes
(subprocesses, each on 2 of 4 samples) against one process on all 4 and
against JAX's step on a 4-device data mesh; ``cli.train`` with
``--coordinator`` / ``--num_processes`` / ``--process_id`` in two
processes. 64², conv_dim 8, 2 residual blocks, float32."""

import dataclasses
import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from impersonator_tpu import config as jconfig
from impersonator_tpu.config import TrainConfig as JCfg
from impersonator_tpu.models import HumanModelRecovery as JHMR
from impersonator_tpu.models.discriminator import \
    PatchDiscriminator as JDisc
from impersonator_tpu.models.generator import ImpersonatorGenerator as JGen
from impersonator_tpu.parallel import distributed as jdist
from impersonator_tpu.parallel import mesh as jmesh
from impersonator_tpu.tasks import imitator as JI
from impersonator_tpu.tasks import trainer as JT
from impersonator_tpu_torch import assets as tassets
from impersonator_tpu_torch.config import TestConfig as TTestCfg
from impersonator_tpu_torch.models.generator import \
    ImpersonatorGenerator as TGen
from impersonator_tpu_torch.ops import cuda_raster as cr
from impersonator_tpu_torch.parallel import distributed as tdist
from impersonator_tpu_torch.parallel import mesh as tmesh
from impersonator_tpu_torch.tasks import imitator as TI
from impersonator_tpu_torch.utils import convert
from tools import convert_weights as cw

import torch_ref
from torch_threads import one_torch_thread  # noqa: F401
from train_ref import batch, np_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, CONV_DIM, REPEAT = 64, 8, 2
CPU8 = ["cpu"] * 8
# the imitator tests' bound on preds against JAX (each package rasterises
# for itself); against the port's one-device run at the batch of one
# piece, the mesh's preds are the same arithmetic
PRED_TOL, MESH_TOL = 1e-2, 1e-6
RANK_TIMEOUT = 240


@pytest.fixture(scope="module")
def gen_sd():
    rng = np.random.default_rng(43)
    return {**torch_ref.make_bg_sd(rng, 4, CONV_DIM, REPEAT),
            **torch_ref.make_resunet_sd(rng, "src_model", 6, CONV_DIM,
                                        REPEAT),
            **torch_ref.make_resunet_sd(rng, "tsf_model", 6, CONV_DIM,
                                        REPEAT)}


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _run_ranks(cmds, env=None):
    """Run one subprocess per command; every one must exit 0 within
    RANK_TIMEOUT (all are killed when one does not)."""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
           **(env or {})}
    procs = [subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out[-2000:] + err[-3000:]
    return [o for o, _ in outs]


# -- the mesh helpers ---------------------------------------------------------

def test_mesh_helpers_match_jax():
    """make_mesh (-1 absorbing the rest, 2-D), make_data_mesh for batches
    1-16, shard_batch over a 1-D and a 2-D mesh (each device's piece),
    replicate_tree (modules copied), process_local_slice, and the
    one-process global_shard_batch and all_reduce_mean_ (identities)."""
    assert len(jax.devices()) == 8
    for shape, axes in (((-1,), ("data",)), ((2, -1), ("data", "model")),
                        ((4,), ("data",))):
        jm = jmesh.make_mesh(shape, axes)
        tm = tmesh.make_mesh(shape, axes, CPU8)
        assert tm.shape == dict(jm.shape) and tm.size == jm.size
        assert tm.axis_names == tuple(jm.axis_names)
        x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
        jx = jmesh.shard_batch({"x": x}, jm)["x"]
        tx = tmesh.shard_batch({"x": torch.from_numpy(x)}, tm)
        assert len(tx) == tm.size
        for shard in jx.addressable_shards:
            pos = np.argwhere(jm.devices == shard.device)[0]
            flat = int(np.ravel_multi_index(tuple(pos), jm.devices.shape))
            np.testing.assert_array_equal(tx[flat]["x"].numpy(),
                                          np.asarray(shard.data))
    for b in range(1, 17):
        assert tmesh.make_data_mesh(b, CPU8).size == \
            jmesh.make_data_mesh(b).size, b

    net = torch.nn.Linear(3, 2)
    copies = tmesh.replicate_tree({"w": torch.ones(2), "net": net},
                                  tmesh.make_mesh(devices=["cpu"] * 2))
    assert len(copies) == 2 and copies[0]["net"] is not net
    assert all(torch.equal(c["net"].weight, net.weight) for c in copies)
    assert tdist.process_local_slice(8) == jdist.process_local_slice(8)
    assert tdist.global_mesh(device_type="cpu").size == 1
    b = {"x": torch.arange(4)}
    assert tdist.global_shard_batch(b, tmesh.make_mesh(devices=CPU8)) is b
    t = torch.arange(3.0)
    tdist.all_reduce_mean_([t])
    assert torch.equal(t, torch.arange(3.0))
    with pytest.raises(ValueError, match="equal pieces"):
        tmesh.shard_batch(torch.zeros(5), tm)


# -- the Imitator on a mesh ---------------------------------------------------

def _thetas(n, seed):
    rng = np.random.default_rng(seed)
    t = np.zeros((n, 85), np.float32)
    t[:, 0] = 0.9
    t[:, 3:75] = rng.normal(0, 0.05, (n, 72))
    return t


def _port_imitator(sd, hmr=None, mesh=None):
    gen = TGen(conv_dim=CONV_DIM, repeat_num=REPEAT)
    gen.load_state_dict(sd, strict=True)
    cfg = TTestCfg(image_size=S, repeat_num=REPEAT, compute_dtype="float32")
    return TI.Imitator(cfg, assets=tassets.synthetic_assets(),
                       nets=TI.ImitatorNets(gen, hmr, None), device="cpu",
                       mesh=mesh)


@pytest.mark.parametrize("shape,axes,piece", [
    ((-1,), ("data",), 1), ((2, 2), ("data", "model"), 2)])
def test_imitator_on_8_cpu_mesh_matches_jax(gen_sd, assets, monkeypatch,
                                            shape, axes, piece):
    """5 frames at batch 3: the batch rounds up to the mesh's size (8 on
    the 8-device mesh, 4 on a (2, 2) data x model mesh) and splits into
    one piece per data index (8 pieces of one frame; 2 of two, each run
    once and not again along ``model``), one flow launch per piece; the
    preds match JAX's Imitator on the same mesh over its virtual devices,
    and the port's one-device run at the batch of a piece."""
    cfg = jconfig.TestConfig(image_size=S, repeat_num=REPEAT,
                             compute_dtype="float32")
    jnets = JI.ImitatorNets(
        JGen(bg_dim=4, src_dim=6, tsf_dim=6, conv_dim=CONV_DIM,
             repeat_num=REPEAT),
        cw.convert_generator(gen_sd, repeat=REPEAT), JHMR(), None, None,
        None)
    ref = JI.Imitator(cfg, assets=assets, nets=jnets,
                      mesh=jmesh.make_mesh(shape, axes))
    solo = _port_imitator(gen_sd)
    dp = _port_imitator(gen_sd, mesh=tmesh.make_mesh(shape, axes, CPU8))
    rounded = ref._round_batch(3)
    assert dp._round_batch(3) == rounded == dp.mesh.size
    assert len(dp.replicas) == rounded // piece
    rng = np.random.default_rng(0)
    src = rng.uniform(-1, 1, (S, S, 3)).astype(np.float32)
    theta = _thetas(1, 1)[0]
    for imit in (ref, solo, dp):
        imit.personalize(src, src_smpl=theta)
    smpls = _thetas(5, 2)
    smpls[:, 1] += np.linspace(0, 0.1, 5, dtype=np.float32)  # cam drift

    calls = []
    flow = cr.zbuffer_bucket_flow
    monkeypatch.setattr(cr, "zbuffer_bucket_flow",
                        lambda *a: calls.append(a[0].shape[0]) or flow(*a))
    p_dp = dp.inference_by_smpls(smpls, batch=3)
    assert calls == [piece] * (-(-5 // rounded) * (rounded // piece))
    monkeypatch.setattr(cr, "zbuffer_bucket_flow", flow)
    p_j = np.asarray(ref.inference_by_smpls(smpls, batch=3))
    p_solo = solo.inference_by_smpls(smpls, batch=piece)
    assert p_dp.shape == (5, S, S, 3) and p_dp.device.type == "cpu"
    np.testing.assert_allclose(p_dp.numpy(), p_j, atol=PRED_TOL)
    np.testing.assert_allclose(p_dp.numpy(), p_solo.numpy(), atol=MESH_TOL)
    np.testing.assert_array_equal(dp.first_cam.numpy(), smpls[0:1, 0:3])


def test_imitator_mesh_hmr_and_stream_paths(gen_sd):
    """On a 2-device mesh, inference (HMR on each piece) and the streamed
    core with uint8 readback: 3 frames at batch 2 (pieces of 1), frame
    0's camera for every piece, equal to the one-device run at batch 1
    (the whole core, HMR's convs included, at the batch of a piece; uint8
    within one level); a replica's nets are
    copies of the master, and refresh_compute_nets copies it again."""
    hmr = TI.build_nets(TTestCfg(image_size=S, repeat_num=1),
                        tassets.synthetic_assets()).hmr
    solo = _port_imitator(gen_sd, hmr)
    dp = _port_imitator(gen_sd, hmr, tmesh.make_mesh(devices=["cpu"] * 2))
    rng = np.random.default_rng(3)
    src = rng.uniform(-1, 1, (S, S, 3)).astype(np.float32)
    for imit in (solo, dp):
        imit.personalize(src, src_smpl=_thetas(1, 4)[0])
    u8 = rng.integers(0, 256, (3, 224, 224, 3), dtype=np.uint8)
    imgs = u8.astype(np.float32) / 127.5 - 1.0

    want = solo.inference(imgs, batch=1)
    got = dp.inference(imgs, batch=2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=MESH_TOL)
    np.testing.assert_array_equal(dp.first_cam.numpy(),
                                  solo.first_cam.numpy())
    s_u8 = solo._stream_infer(iter(u8[:, None]), solo.regress_smpl_u8, 3,
                              "smooth", True, False)
    d_u8 = dp._stream_infer(iter([u8[:2], np.concatenate([u8[2:], u8[2:]])]),
                            dp.regress_smpl_u8, 3, "smooth", True, False)
    assert d_u8.dtype == np.uint8 and d_u8.shape == (3, S, S, 3)
    assert np.abs(d_u8.astype(int) - s_u8.astype(int)).max() <= 1

    rep = dp.replicas[1]
    assert rep.nets.generator is not dp.nets.generator
    with torch.no_grad():
        next(dp.nets.generator.parameters()).add_(1.0)
    dp.refresh_compute_nets()
    for a, b in zip(dp.replicas[1].compute_nets.generator.parameters(),
                    dp.nets.generator.parameters()):
        assert torch.equal(a, b)


# -- a train step of two gloo processes ---------------------------------------

# one process on 4 samples against two on 2 each: the per-sample
# arithmetic is the same, but the conv weight gradients sum 4 samples in
# another order than two sums of 2 (G measured 1.08e-5 over all tensors,
# D below it); a missing or misscaled all-reduce is off by O(1)
GRAD_RTOL = 3e-5
STEP_KW = dict(image_size=S, repeat_num=REPEAT, batch_size=4, d_layers=2,
               use_vgg=False, use_style=False, use_face=False)

_STEP_WORKER = textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)
    rank, port, wdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    from impersonator_tpu_torch.parallel.distributed import init_distributed
    assert init_distributed("127.0.0.1:" + port, 2, rank, device="cpu")
    blob = torch.load(wdir + "/init.pt")
    out = {}
    exec(blob["step_src"], out)
    metrics, grads, params = out["step"](blob, rank)
    torch.save({"metrics": metrics, "grads": grads, "params": params},
               wdir + f"/rank{rank}.pt")
""")

# the step each rank runs on its rows (and the single process on all):
# the port's trainer from the blob's weights, one G + D step
_STEP_SRC = textwrap.dedent("""
    import torch
    from impersonator_tpu_torch import assets as tassets
    from impersonator_tpu_torch.config import TrainConfig
    from impersonator_tpu_torch.models.discriminator import \\
        PatchDiscriminator
    from impersonator_tpu_torch.models.generator import \\
        ImpersonatorGenerator
    from impersonator_tpu_torch.tasks import trainer as TT

    def step(blob, rank=None):
        tr = TT.build_trainer(TrainConfig(**blob["cfg"]),
                              tassets.synthetic_assets(), device="cpu")
        gen = ImpersonatorGenerator(conv_dim=blob["conv_dim"],
                                    repeat_num=blob["repeat"])
        gen.load_state_dict(blob["G"])
        disc = PatchDiscriminator(6, 64, blob["cfg"]["d_layers"],
                                  "instance")
        disc.load_state_dict(blob["D"])
        st = tr.init_state(gen, disc)
        b = blob["batch"]
        if rank is not None:
            b = {k: v[2 * rank:2 * rank + 2] for k, v in b.items()}
        st, m = TT.make_train_step(tr, train_d=True)(st, b)
        named = [(n + "." + k, p) for n, net in (("G", st.generator),
                                                 ("D", st.discriminator))
                 for k, p in net.named_parameters()]
        return ({k: float(v) for k, v in m.items()},
                {k: p.grad.clone() for k, p in named},
                {k: p.detach().clone() for k, p in named})
""")


def _grad_gap(a, b):
    """|a - b| / |b| in L2 over all tensors of b."""
    ca = torch.cat([a[k].flatten() for k in b])
    cb = torch.cat([b[k].flatten() for k in b])
    return float((ca - cb).norm() / cb.norm())


def test_two_process_train_step_matches_one_process_and_jax(gen_sd, assets,
                                                            tmp_path):
    """Two gloo processes, each on 2 of the 4 samples: their all-reduced
    G and D gradients and averaged losses equal (1e-7 relative) the mean
    of one process's on each half; within GRAD_RTOL (L2 over all tensors)
    and 1e-6 relative of one process on all 4; both ranks end with the
    same parameters, bit for bit; the losses within 1e-4 relative of JAX's
    step on a 4-device data mesh (the bound of
    tests/test_torch_train_step.py: each package rasterises for
    itself)."""
    jtr = JT.build_trainer(JCfg(**STEP_KW), assets)
    jgen = JGen(bg_dim=4, src_dim=6, tsf_dim=6, conv_dim=CONV_DIM,
                repeat_num=REPEAT)
    jtr = dataclasses.replace(jtr, generator=jgen)
    d_params = np_tree(jax.jit(JDisc(ndf=64, n_layers=2,
                                     norm_type="instance").init)(
        jax.random.PRNGKey(5), np.zeros((1, S, S, 6), np.float32)))
    g_params = cw.convert_generator(gen_sd, repeat=REPEAT)
    jb, tb = batch((0, 1, 2, 3))
    blob = {"cfg": STEP_KW, "conv_dim": CONV_DIM, "repeat": REPEAT,
            "G": gen_sd, "D": convert.discriminator_state_dict_from_jax(
                d_params), "batch": tb, "step_src": _STEP_SRC}
    torch.save(blob, tmp_path / "init.pt")
    worker = tmp_path / "worker.py"
    worker.write_text(_STEP_WORKER)
    port = str(_free_port())
    _run_ranks([[sys.executable, str(worker), str(r), port, str(tmp_path)]
                for r in range(2)])
    r0, r1 = (torch.load(tmp_path / f"rank{r}.pt") for r in range(2))
    assert r0["metrics"] == r1["metrics"]
    assert all(torch.equal(r0["params"][k], r1["params"][k])
               for k in r0["params"])

    ns = {}
    exec(_STEP_SRC, ns)
    halves = [ns["step"](blob, r) for r in range(2)]
    m_one, g_one, _ = ns["step"](blob)
    for k, v in m_one.items():
        half = (halves[0][0][k] + halves[1][0][k]) / 2
        assert abs(r0["metrics"][k] - half) <= 1e-7 * max(abs(half), 1e-3)
        assert abs(r0["metrics"][k] - v) <= 1e-6 * max(abs(v), 1e-3), \
            (k, r0["metrics"][k], v)
    g_half = {k: (halves[0][1][k] + halves[1][1][k]) / 2 for k in g_one}
    for net in "GD":
        keys = [k for k in g_one if k[0] == net]
        got = {k: r0["grads"][k] for k in keys}
        assert _grad_gap(got, {k: g_half[k] for k in keys}) <= 1e-7
        gap = _grad_gap(got, {k: g_one[k] for k in keys})
        assert gap <= GRAD_RTOL, (net, gap)

    mesh = jmesh.make_data_mesh(4)
    assert mesh.size == 4
    jstate = jmesh.replicate_tree(JT.TrainState(
        g_params, d_params, jtr.g_tx.init(g_params),
        jtr.d_tx.init(d_params), np.zeros((), np.int32)), mesh)
    with mesh:
        _, mj = jax.jit(JT.make_train_step(jtr, train_d=True))(
            jstate, jmesh.shard_batch(jb, mesh))
    for k, v in mj.items():
        v = float(v)
        assert abs(r0["metrics"][k] - v) <= 1e-4 * max(abs(v), 1e-3), \
            (k, r0["metrics"][k], v)


# -- cli.train in two processes -----------------------------------------------

_CLI_WORKER = textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)
    rank, port, ckpt, out = sys.argv[1:5]
    from impersonator_tpu_torch.cli import train as cli
    real = cli.dataset_by_name

    def short(name, cfg, ids_file=None, **kw):   # 8 items: 2 steps/epoch
        ds = real(name, cfg, ids_file=ids_file, **kw)
        ds.length = 8
        return ds
    cli.dataset_by_name = short
    state = cli.main([
        "--dataset_mode", "synthetic", "--device", "cpu",
        "--image_size", "64", "--repeat_num", "1", "--d_layers", "2",
        "--batch_size", "4", "--no-use_vgg", "--no-use_face",
        "--n_threads", "1", "--print_freq_s", "0",
        "--display_freq_steps", "1", "--nepochs_no_decay", "1",
        "--nepochs_decay", "0", "--name", "run", "--checkpoints_dir", ckpt,
        "--coordinator", "127.0.0.1:" + port, "--num_processes", "2",
        "--process_id", rank])
    torch.save({k: v.clone() for k, v in state.generator.state_dict().items()},
               out)
""")


def test_cli_train_two_processes(tmp_path):
    """cli.train with --coordinator / --num_processes / --process_id on
    the CPU (gloo), batch 4 (2 a process), 2 steps: only process 0 writes
    (its checkpoint dir holds the epoch's files, the loss log with the
    validation pass; process 1's dir is never made), and both end with
    the same generator, which is the one process 0 saved."""
    worker = tmp_path / "cli_worker.py"
    worker.write_text(_CLI_WORKER)
    port = str(_free_port())
    outs = _run_ranks([
        [sys.executable, str(worker), str(r), port,
         str(tmp_path / f"ckpt{r}"), str(tmp_path / f"gen{r}.pt")]
        for r in range(2)])
    assert "saved epoch 1" in outs[0] and "training done." in outs[0]
    assert outs[1] == ""
    exp = tmp_path / "ckpt0" / "run"
    names = set(os.listdir(exp))
    assert {f"{k}_epoch_1_id_{n}.pth" for k in ("net", "opt")
            for n in "GD"} <= names
    log = open(exp / "loss_log.jsonl").read()
    assert '"phase": "val"' in log and log.count('"phase": "train"') == 2
    assert not (tmp_path / "ckpt1").exists()
    g0, g1 = (torch.load(tmp_path / f"gen{r}.pt") for r in range(2))
    saved = torch.load(exp / "net_epoch_1_id_G.pth")
    assert all(torch.equal(g0[k], g1[k]) and torch.equal(g0[k], saved[k])
               for k in g0)


def test_cli_train_spawns_one_process_per_device(tmp_path, monkeypatch):
    """Without the three flags, cli.train's local path on a mesh of two
    devices (here the CPU twice, the test seam of a two-card host):
    torch.multiprocessing.spawn starts one process per device over a
    local rendezvous, each on its data shard (32², batch 32, 16 a
    process: the synthetic set's 64 items in 2 steps), and only process
    0 writes the epoch's checkpoint."""
    from impersonator_tpu_torch.cli import train as cli
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ckpt = tmp_path / "ckpt"
    cli.spawn_local([
        "--dataset_mode", "synthetic", "--device", "cpu", "--image_size",
        "32", "--repeat_num", "1", "--d_layers", "2", "--batch_size", "32",
        "--no-use_vgg", "--no-use_face", "--n_threads", "1",
        "--display_freq_steps", "1", "--nepochs_no_decay", "1",
        "--nepochs_decay", "0", "--name", "run", "--checkpoints_dir",
        str(ckpt)], tmesh.make_mesh(devices=["cpu"] * 2))
    names = set(os.listdir(ckpt / "run"))
    assert {f"{k}_epoch_1_id_{n}.pth" for k in ("net", "opt")
            for n in "GD"} <= names
    log = open(ckpt / "run" / "loss_log.jsonl").read()
    assert '"phase": "val"' in log
