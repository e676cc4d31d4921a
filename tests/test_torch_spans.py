"""The port's spans (``utils.profiling.span``) on the CPU: off, a span
never enters torch's profiler and the frames are the same bits as under
one; recording, the profile holds the documented spans, nested and
counted as ``utils/profiling.py`` lists them, in the imitation path
(64², conv_dim 8, batch 2), in post-tune, and in the train step, alone
and in a process group (gloo, one process); post-tune's and the
all-reduce's counters move with them."""

import math
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch import nn
from torch.profiler import ProfilerActivity, profile

from impersonator_tpu_torch import assets as tassets
from impersonator_tpu_torch.config import TestConfig as TConfig
from impersonator_tpu_torch.config import TrainConfig
from impersonator_tpu_torch.data.datasets import SyntheticPairDataset
from impersonator_tpu_torch.data.loader import _collate, stage_batch
from impersonator_tpu_torch.models.generator import ImpersonatorGenerator
from impersonator_tpu_torch.parallel import distributed as PD
from impersonator_tpu_torch.tasks import imitator as TI
from impersonator_tpu_torch.tasks import post_tune as TP
from impersonator_tpu_torch.tasks import trainer as TT
from impersonator_tpu_torch.utils import profiling

from torch_threads import one_torch_thread  # noqa: F401

S, CONV_DIM, REPEAT, BATCH = 64, 8, 2, 2
SPANS = {"personalize", "hmr", "imitate.batch", "imitate.geometry", "warp",
         "imitate.generator", "imitate.composite", "train.step",
         "train.body_flow", "train.g_loss", "train.g_grad", "train.d",
         "train.allreduce", "train.adam", "posttune", "posttune.pairs",
         "posttune.step", "posttune.refresh"}
TRAIN = ["train.body_flow", "train.g_loss", "train.g_grad", "train.d",
         "train.adam"]


class ThetaNet(nn.Module):
    """A stand-in for HMR: (B, 224, 224, 3) -> (B, 85) θs near the rest
    pose that move with the image."""

    def forward(self, img):
        theta = torch.zeros(img.shape[0], 85)
        theta[:, 0] = 0.9
        theta[:, 3:75] = 0.1 * img.mean(dim=(1, 2, 3))[:, None]
        return theta


@pytest.fixture(scope="module")
def imitator():
    torch.manual_seed(0)
    gen = ImpersonatorGenerator(conv_dim=CONV_DIM, repeat_num=REPEAT)
    return TI.Imitator(TConfig(image_size=S, repeat_num=REPEAT,
                               compute_dtype="float32"),
                       assets=tassets.synthetic_assets(),
                       nets=TI.ImitatorNets(gen, ThetaNet()), device="cpu")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    src_img = rng.uniform(-1, 1, (S, S, 3)).astype(np.float32)
    theta = np.zeros(85, np.float32)
    theta[0] = 0.9
    tgt = np.tile(theta, (5, 1))
    tgt[:, 3:75] += rng.normal(0, 0.05, (5, 72)).astype(np.float32)
    crops = rng.uniform(-1, 1, (3, 224, 224, 3)).astype(np.float32)
    return src_img, theta, tgt, crops


def recorded(fn):
    """fn() under a CPU profiler -> (its result, the program's spans
    (name, start, end), outermost first)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation() and e.name() in SPANS]
    return out, sorted(ranges, key=lambda r: (r[1], -r[2]))


def inside(ranges, outer, name=None):
    """The spans (named ``name``) nested in ``outer``, in start order."""
    return [r for r in ranges if r is not outer and outer[1] <= r[1]
            and r[2] <= outer[2] and (name is None or r[0] == name)]


def named(ranges, name):
    return [r for r in ranges if r[0] == name]


def test_span_reads_the_profilers_flag():
    """The flag span reads is the one torch sets while a profiler
    records: a rename or a flag left unset fails here, not silently."""
    flag = torch.autograd.profiler
    assert flag._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert flag._is_profiler_enabled is True
        with profiling.span("imitate.batch"):
            torch.ones(4).sum()
    assert flag._is_profiler_enabled is False
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    assert names == ["imitate.batch"]


def test_spans_off_never_enter_the_profiler(imitator, inputs, monkeypatch):
    class Refused:
        def __init__(self, *a, **k):
            raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Refused)
    with profiling.span("warp"):
        pass
    src_img, theta, tgt, _ = inputs
    imitator.personalize(src_img, theta)
    preds = imitator.inference_by_smpls(tgt, batch=BATCH)
    assert preds.shape == (5, S, S, 3)


def test_frames_are_the_same_bits_under_a_profiler(imitator, inputs):
    src_img, theta, tgt, _ = inputs

    def job():
        imitator.personalize(src_img, theta)
        return imitator.inference_by_smpls(tgt, batch=BATCH)

    plain = job()
    traced, ranges = recorded(job)
    assert ranges
    assert torch.equal(plain, traced)


def test_imitation_spans_nest_and_count(imitator, inputs):
    src_img, theta, tgt, _ = inputs

    def job():
        imitator.personalize(src_img, theta)
        return imitator.inference_by_smpls(tgt, batch=BATCH)

    _, ranges = recorded(job)
    n_down = imitator.nets.generator.n_down
    assert len(named(ranges, "personalize")) == 1
    batches = named(ranges, "imitate.batch")
    assert len(batches) == math.ceil(len(tgt) / BATCH)
    for b in batches:
        for name in ("imitate.geometry", "imitate.generator",
                     "imitate.composite"):
            assert len(inside(ranges, b, name)) == 1, name
        assert len(inside(ranges, b, "warp")) == n_down + 2
        gen = inside(ranges, b, "imitate.generator")[0]
        # the encoder stages' and the residual blocks' warps; the image
        # warp comes before the generator
        assert len(inside(ranges, gen, "warp")) == n_down + 1
        assert not inside(ranges, b, "hmr")
    # every span lies in a top-level one
    top = named(ranges, "personalize") + batches
    assert all(r in top or any(r in inside(ranges, t) for t in top)
               for r in ranges)


def test_hmr_span_once_per_batch(imitator, inputs):
    src_img, _, _, crops = inputs

    def job():
        imitator.personalize(src_img)          # θ regressed: HMR once
        return imitator.inference(crops, batch=BATCH)

    preds, ranges = recorded(job)
    assert preds.shape == (len(crops), S, S, 3)
    (pers,) = named(ranges, "personalize")
    assert len(inside(ranges, pers, "hmr")) == 1
    batches = named(ranges, "imitate.batch")
    assert len(batches) == math.ceil(len(crops) / BATCH)
    assert [len(inside(ranges, b, "hmr")) for b in batches] == \
        [1] * len(batches)
    assert len(named(ranges, "hmr")) == 1 + len(batches)


def test_train_step_spans_in_order():
    cfg = TrainConfig(image_size=S, repeat_num=REPEAT, batch_size=BATCH,
                      d_layers=2)
    trainer = TT.build_trainer(cfg, tassets.synthetic_assets(), device="cpu")
    torch.manual_seed(1)
    state = trainer.init_state(generator=ImpersonatorGenerator(
        conv_dim=CONV_DIM, repeat_num=REPEAT))
    step = TT.make_train_step(trainer, train_d=True)
    ds = SyntheticPairDataset(S, seed=0)
    batch = stage_batch(_collate([ds[0], ds[1]]), "cpu")

    def two_steps():
        for _ in range(2):
            step(state, batch)

    _, ranges = recorded(two_steps)
    steps = named(ranges, "train.step")
    assert len(steps) == 2
    for s in steps:
        kids = [r[0] for r in inside(ranges, s) if r[0] in TRAIN]
        assert kids == TRAIN
    for name in TRAIN:
        assert len(named(ranges, name)) == 2
    assert state.step == 2


def test_posttune_spans_nest_and_count(inputs):
    torch.manual_seed(2)
    imit = TI.Imitator(TConfig(image_size=S, repeat_num=REPEAT,
                               compute_dtype="float32"),
                       assets=tassets.synthetic_assets(),
                       nets=TI.ImitatorNets(ImpersonatorGenerator(
                           conv_dim=CONV_DIM, repeat_num=REPEAT)),
                       device="cpu")
    src_img, theta, _, _ = inputs
    imit.personalize(src_img, theta)
    priors = TP.default_prior_poses(imit.src_info["theta"], n=3)
    steps0, pairs0 = TP.steps, TP.pairs
    out, ranges = recorded(lambda: TP.adaptive_personalize(
        imit, priors, epochs=2, batch_size=2))
    assert out["n_steps"] == 4                  # 2 epochs x ceil(3 / 2)
    assert (TP.steps - steps0, TP.pairs - pairs0) == (4, 3)
    (whole,) = named(ranges, "posttune")
    for name, n in (("posttune.pairs", 1), ("posttune.step", 4),
                    ("posttune.refresh", 1)):
        assert len(named(ranges, name)) == n, name
        assert len(inside(ranges, whole, name)) == n, name
    kids = [r[0] for r in inside(ranges, whole)
            if r[0].startswith("posttune.")]
    assert kids == (["posttune.pairs"] + ["posttune.step"] * 4
                    + ["posttune.refresh"])


def test_allreduce_span_and_counter_in_a_process_group():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        cfg = TrainConfig(image_size=S, repeat_num=REPEAT,
                          batch_size=BATCH, d_layers=2)
        trainer = TT.build_trainer(cfg, tassets.synthetic_assets(),
                                   device="cpu")
        torch.manual_seed(1)
        state = trainer.init_state(generator=ImpersonatorGenerator(
            conv_dim=CONV_DIM, repeat_num=REPEAT))
        step = TT.make_train_step(trainer, train_d=True)
        ds = SyntheticPairDataset(S, seed=0)
        batch = stage_batch(_collate([ds[0], ds[1]]), "cpu")
        before = PD.reduced_bytes

        def two_steps():
            for _ in range(2):
                step(state, batch)

        _, ranges = recorded(two_steps)
    finally:
        dist.destroy_process_group()
    order = TRAIN[:4] + ["train.allreduce"] + TRAIN[4:]
    steps = named(ranges, "train.step")
    assert len(steps) == 2
    for s in steps:
        assert [r[0] for r in inside(ranges, s) if r[0] in order] == order
    params = sum(p.numel() for net in (state.generator, state.discriminator)
                 for p in net.parameters())
    # one float32 bucket a step: every gradient, then the step's metrics
    metrics = (PD.reduced_bytes - before) / 2 / 4 - params
    assert metrics == int(metrics) and 1 <= metrics <= 64
