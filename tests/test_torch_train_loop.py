"""The trainer around the step, on the CPU: TrainConfig and the CLI
flags against the JAX package's, the per-epoch G and D learning rates,
the bf16 policy (against the port's float32 step and JAX's bf16 loss),
remat, the G-only loss falling on a repeated batch, and
``python -m impersonator_tpu_torch.cli.train`` training, checkpointing
and resuming. Tolerances are stated at each test."""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from impersonator_tpu import config as jconfig
from impersonator_tpu.tasks import trainer as JT
from impersonator_tpu_torch import assets as tassets
from impersonator_tpu_torch import config as tconfig
from impersonator_tpu_torch.cli import train as tcli
from impersonator_tpu_torch.models.generator import \
    ImpersonatorGenerator as TGen
from impersonator_tpu_torch.models.layers import init_weights
from impersonator_tpu_torch.tasks import trainer as TT

from train_ref import S, Pair, batch, port_inputs
from torch_threads import one_torch_thread  # noqa: F401

# -- config and flags ---------------------------------------------------------


def test_train_config_matches_jax(tmp_path):
    """TrainConfig field for field with the same defaults and types, and
    the same opt_train.txt audit file."""
    t, j = tconfig.TrainConfig(), jconfig.TrainConfig()
    ft = [(f.name, f.type) for f in dataclasses.fields(t)]
    fj = [(f.name, f.type) for f in dataclasses.fields(j)]
    assert ft == fj
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    kw = dict(checkpoints_dir=str(tmp_path), name="exp")
    pt = tconfig.TrainConfig(**kw).save("train")
    text = open(pt).read()
    pj = jconfig.TrainConfig(**kw).save("train")
    assert text == open(pj).read() and "lambda_face: 5.0" in text


ARGV = ["--image_size", "128", "--batch_size", "4", "--no-use_vgg",
        "--use_style", "--lambda_face", "2.5", "--train_dtype", "bfloat16",
        "--mesh_shape", "2,-1", "--mesh_axes", "data,model", "--name", "x",
        "--remat", "--d_layers", "3", "--device", "cpu"]


def test_cli_flags_round_trip_match_jax():
    """The same argparse flags, and the same config from an argv of
    ints, floats, bools both ways, strings and tuples (flags the config
    does not know, like --device, are left to the caller)."""
    pt = tconfig.to_argparse(tconfig.TrainConfig)
    pj = jconfig.to_argparse(jconfig.TrainConfig)
    assert sorted(a.dest for a in pt._actions) == \
        sorted(a.dest for a in pj._actions)
    t = tconfig.from_args(tconfig.TrainConfig, ARGV)
    j = jconfig.from_args(jconfig.TrainConfig, ARGV)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.mesh_shape == (2, -1) and not t.use_vgg and t.remat
    assert tconfig.from_args(tconfig.TrainConfig, []) == \
        tconfig.TrainConfig()


def test_epoch_lr_and_set_lr_match_jax():
    """epoch_lr over every epoch and one past the end, for G (lr_G) and
    D (lr_D) with their own bases, equal to the JAX trainer's; set_lr
    writes each optimiser's groups as JAX writes its injected rates."""
    kw = dict(nepochs_no_decay=3, nepochs_decay=4, lr_G=3e-4, lr_D=1e-4,
              final_lr=1e-6)
    jtr = types.SimpleNamespace(cfg=jconfig.TrainConfig(**kw))
    ttr = TT.Trainer(tconfig.TrainConfig(**kw), None, None, None,
                     torch.device("cpu"), None, None)
    for epoch in range(9):
        for base in (None, kw["lr_D"]):
            assert ttr.epoch_lr(epoch, base) == \
                JT.Trainer.epoch_lr(jtr, epoch, base), (epoch, base)
    assert ttr.epoch_lr(7) == pytest.approx(kw["final_lr"])
    params = {"w": jnp.zeros((2,))}
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=1.0)
    jstate = JT.TrainState(params, params, tx.init(params), tx.init(params),
                           jnp.zeros((), jnp.int32))
    w = [torch.zeros(2, requires_grad=True) for _ in range(2)]
    tstate = TT.TrainState(None, None, TT.adam([w[0]], 1.0, 0.5, 0.999),
                           TT.adam([w[1]], 1.0, 0.5, 0.999))
    for lr_g, lr_d in ((2e-4, 5e-5), (7e-5, None)):
        jstate = JT.Trainer.set_lr(jtr, jstate, lr_g, lr_d)
        tstate = ttr.set_lr(tstate, lr_g, lr_d)
        for to, jo in ((tstate.g_opt, jstate.g_opt),
                       (tstate.d_opt, jstate.d_opt)):
            assert to.param_groups[0]["lr"] == pytest.approx(
                float(jo.hyperparams["learning_rate"]), rel=1e-7)


# -- the precision policy and remat ------------------------------------------

def _small_state(ttr, conv_dim=16, seed=0):
    gen = TGen(conv_dim=conv_dim, repeat_num=ttr.cfg.repeat_num)
    init_weights(gen, torch.Generator().manual_seed(seed))
    return ttr.init_state(gen, seed=seed)


def _small_trainer(**kw):
    cfg = tconfig.TrainConfig(image_size=S, repeat_num=1, batch_size=2,
                              d_layers=2, use_vgg=False, use_face=False, **kw)
    return TT.build_trainer(cfg, tassets.synthetic_assets(), device="cpu")


def test_bf16_step_matches_float32():
    """tests/test_tasks.py's bf16 check on the port (64², conv_dim 16, 1
    residual block, batch 2, VGG and face off): one bfloat16 step agrees
    with the float32 step from the same weights within 5e-2 on every
    loss, |a - b| / max(|a|, 1); under bf16 the master weights, their
    gradients and Adam's moments stay float32."""
    tb = batch()[1]
    metrics = {}
    for dtype in ("float32", "bfloat16"):
        ttr = _small_trainer(train_dtype=dtype)
        st = _small_state(ttr)
        st, m = TT.make_train_step(ttr)(st, tb)
        metrics[dtype] = {k: float(v) for k, v in m.items()}
        for net, opt in ((st.generator, st.g_opt),
                         (st.discriminator, st.d_opt)):
            for p in net.parameters():
                assert p.dtype == torch.float32
                assert opt.state[p]["exp_avg"].dtype == torch.float32
    for k in ("g_total", "g_rec", "g_adv", "g_mask", "d_loss"):
        a, b = metrics["float32"][k], metrics["bfloat16"][k]
        assert abs(a - b) / max(abs(a), 1.0) < 5e-2, (k, a, b)


def test_bf16_losses_match_jax_bf16():
    """Both packages in bf16 (train_dtype bfloat16: the G, D and VGG on
    bf16 copies of float32 weights, T float32, the face net float32), on
    JAX's body_recovery_flow products, every term on: each loss within
    1e-2 relative of JAX's (measured ≤ 2.7e-3) and the fake target's mean
    gap within 1.5e-2 (measured 5.9e-3; a bf16 generator with these
    random weights is ~0.1 from its own float32 run at its worst pixel,
    as tests/test_torch_bf16.py finds); the gradient lands in the
    float32 master."""
    pair = Pair()
    jtr, ttr = pair.trainers(train_dtype="bfloat16", use_style=True,
                             lambda_style=2.0)
    js, ts = pair.states(jtr, ttr)
    jb, tb = batch()
    jin = jax.jit(lambda b: JT.body_recovery_flow(
        jtr.renderer, jtr.smpl_params, jtr.assets.parents,
        b["images"][:, 0], b["images"][:, 1], b["smpls"][:, 0],
        b["smpls"][:, 1]))(jb)
    g_fn, _ = JT.make_loss_fns(jtr)
    _, (mj, fake_j) = jax.jit(g_fn)(js.g_params, js.d_params, jin,
                                    jb["images"][:, 0], jb["images"][:, 1])
    g_fn_t, _ = TT.make_loss_fns(ttr)
    total, (mt, fake_t) = g_fn_t(ts.generator, ts.discriminator,
                                 port_inputs(jin), tb["images"][:, 0],
                                 tb["images"][:, 1])
    assert fake_t.dtype == torch.float32
    for k, ref in mj.items():
        ref = float(ref)
        assert abs(float(mt[k]) - ref) <= 1e-2 * max(abs(ref), 1e-6), k
    gap = np.abs(fake_t.detach().permute(0, 2, 3, 1).numpy()
                 - np.asarray(fake_j))
    assert gap.mean() <= 1.5e-2, gap.mean()
    total.backward()
    grads = [p.grad for p in ts.generator.parameters()]
    assert all(g is not None and g.dtype == torch.float32 for g in grads)


def test_remat_matches_no_remat():
    """--remat recomputes G's forward in the backward pass: one step with
    it and one without, from the same weights, give the same losses and
    the same updated weights (bit for bit: the recomputation repeats the
    same float32 arithmetic)."""
    tb = batch()[1]
    out = []
    for remat in (False, True):
        ttr = _small_trainer(remat=remat)
        st, m = TT.make_train_step(ttr)(_small_state(ttr), tb)
        out.append(({k: float(v) for k, v in m.items()},
                    {k: v.clone() for k, v in
                     st.generator.state_dict().items()}))
    assert out[0][0] == out[1][0]
    for k, v in out[0][1].items():
        assert torch.equal(v, out[1][1][k]), k


def test_g_only_loss_falls_on_a_repeated_batch():
    """tests/test_tasks.py's trend test on the port: the reconstruction
    objective alone (lambda_D_prob 0), G-only steps on one batch, g_rec
    lower after 8 steps than at the first."""
    ttr = _small_trainer(lambda_D_prob=0.0)
    st = _small_state(ttr)
    step = TT.make_train_step(ttr, train_d=False)
    tb = batch()[1]
    st, m0 = step(st, tb)
    for _ in range(8):
        st, m = step(st, tb)
    assert float(m["g_rec"]) < float(m0["g_rec"])


# -- the CLI -----------------------------------------------------------------

def _cli_args(tmp_path, *extra):
    return ["--dataset_mode", "synthetic", "--device", "cpu",
            "--image_size", str(S), "--repeat_num", "1", "--d_layers", "2",
            "--batch_size", "2", "--no-use_vgg", "--no-use_face",
            "--n_threads", "2",
            "--checkpoints_dir", str(tmp_path), "--name", "run",
            "--print_freq_s", "0", "--display_freq_s", "0",
            "--nepochs_no_decay", "1", *extra]


def _short_datasets(monkeypatch, n_items=4):
    """The CLI's datasets, cut to n_items (2 steps an epoch at batch 2)."""
    real = tcli.dataset_by_name

    def short(name, cfg, ids_file=None, **kw):
        ds = real(name, cfg, ids_file=ids_file, **kw)
        ds.length = n_items
        return ds
    monkeypatch.setattr(tcli, "dataset_by_name", short)


def test_cli_train_checkpoints_and_resumes(tmp_path, capsys, monkeypatch):
    """cli.train on the CPU (64², batch 2, the full-width generator, the
    synthetic dataset cut to 4 items: 2 steps an epoch): epoch 1 writes the four checkpoint files, the
    audit file, the loss log and the visuals; a second call with
    --load_epoch -1 and one more epoch resumes from epoch 1 (its weights
    before training are epoch 1's) and writes epoch 2. Without --device
    the trainer runs on CUDA and, with no card, fails."""
    _short_datasets(monkeypatch)
    tcli.main(_cli_args(tmp_path, "--nepochs_decay", "0"))
    exp = tmp_path / "run"
    names = set(os.listdir(exp))
    for kind in ("net", "opt"):
        for label in "GD":
            assert f"{kind}_epoch_1_id_{label}.pth" in names
    assert "opt_train.txt" in names and "loss_log.jsonl" in names
    phases = [line.split('"phase": "')[1].split('"')[0]
              for line in open(exp / "loss_log.jsonl")]
    assert phases.count("train") == 2 and "val" in phases
    assert any(n.endswith("_4_fake_tsf.png")
               for n in os.listdir(exp / "visuals"))
    out = capsys.readouterr().out
    assert "saved epoch 1" in out and "training done." in out
    ep1 = torch.load(exp / "net_epoch_1_id_G.pth")

    state = tcli.main(_cli_args(tmp_path, "--nepochs_decay", "1",
                                "--load_epoch", "-1"))
    out = capsys.readouterr().out
    assert "resumed from epoch 1" in out and "saved epoch 2" in out
    assert "net_epoch_2_id_D.pth" in os.listdir(exp)
    ep2 = torch.load(exp / "net_epoch_2_id_G.pth")
    now = state.generator.state_dict()
    assert all(torch.equal(ep2[k], now[k]) for k in now)
    assert any(not torch.equal(ep1[k], ep2[k]) for k in ep1)
    assert state.g_opt.param_groups[0]["lr"] == pytest.approx(2e-4)
    # Adam's step count went on from the two steps saved at epoch 1
    p = next(state.generator.parameters())
    assert int(state.g_opt.state[p]["step"]) == 4
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            tcli.main(["--dataset_mode", "synthetic", "--checkpoints_dir",
                       str(tmp_path), "--name", "gpu"])
