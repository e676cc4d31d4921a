"""The float32 convolution route (``ops/conv_route.py``).

On the CPU, with an injected clock and, where a case says so, an
injected "cuDNN" result: the routed Function's forward, input gradient
and weight gradient equal ``F.conv2d`` / ``F.conv_transpose2d`` under
autograd for the generator's conv kinds, with either backend picked; the
faster backend is picked and kept for each key and pass; a result off by
1e-3 is refused; the counters count; half-precision and CPU tensors and
calls outside the block pass through; the block restores
``cudnn.enabled`` and leaves the TF32 flags off. Marked ``cuda`` (skipped
without a card): every routed pass of a post-tune at 256², batch 4,
against the native pass and cuDNN's TF32 pass on the same tensors. This
file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_conv_route.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from impersonator_tpu_torch.models.layers import ResidualBlock
from impersonator_tpu_torch.ops import conv_route as R
from impersonator_tpu_torch.utils.precision import full_fp32
from torch_threads import one_torch_thread  # noqa: F401

# (name, transposed, cin, cout, kernel, stride, padding, output padding):
# the generator's conv kinds, narrowed
KINDS = [("7x7_6_64", False, 6, 64, 7, 1, 3, 0),
         ("7x7_64_4", False, 64, 4, 7, 1, 3, 0),
         ("3x3_s2", False, 16, 32, 3, 2, 1, 0),
         ("3x3_s1", False, 32, 16, 3, 1, 1, 0),
         ("3x3_transposed", True, 32, 16, 3, 2, 1, 1)]


@pytest.fixture
def route(monkeypatch):
    """The route with fresh picks and counters, CPU tensors routed, and a
    clock that reads ``ms[backend]`` (cuDNN faster by default); records
    each timed call's backend in ``timed``."""
    class State:
        ms = {True: 1.0, False: 2.0}
        timed = []
        perturb = 0.0

    st = State()

    def clock(use_cudnn, fn):
        st.timed.append(use_cudnn)
        return st.ms[use_cudnn], R._on(use_cudnn, fn)

    real_on = R._on

    def on(use_cudnn, fn):
        out = real_on(use_cudnn, fn)
        if use_cudnn and st.perturb:
            return _scaled(out, 1 + st.perturb)
        return out

    monkeypatch.setattr(R, "picks", {})
    for name in ("probes", "cudnn_passes", "native_passes"):
        monkeypatch.setattr(R, name, 0)
    monkeypatch.setattr(R, "_on", on)
    monkeypatch.setattr(R, "_time_ms", clock)
    monkeypatch.setattr(R, "_on_card", lambda x: True)
    return st


def _scaled(out, k):
    if isinstance(out, tuple):
        return tuple(None if t is None else t * k for t in out)
    return out * k


def _counts():
    return R.probes, R.cudnn_passes, R.native_passes


def _case(kind, bias, seed=0):
    _, transposed, cin, cout, k, s, p, op = kind
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, cin, 10, 10, generator=g)
    shape = (cin, cout, k, k) if transposed else (cout, cin, k, k)
    w = 0.1 * torch.randn(*shape, generator=g)
    b = 0.1 * torch.randn(cout, generator=g) if bias else None
    return x, w, b


def _plain(kind, x, w, b):
    _, transposed, _, _, _, s, p, op = kind
    if transposed:
        return F.conv_transpose2d(x, w, b, s, p, op)
    return F.conv2d(x, w, b, s, p)


def _grads(fn, x, w, b, seed=1):
    """fn(x, w, b) and the gradients of x, w (and b) under a fixed
    upstream gradient."""
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, w, b) if t is not None]
    y = fn(*leaves, *([None] if b is None else []))
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(seed))
    y.backward(g)
    return [y.detach()] + [t.grad for t in leaves]


@pytest.mark.parametrize("pick", ["native", "cudnn"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("kind", KINDS, ids=[k[0] for k in KINDS])
def test_routed_passes_equal_autograd(route, kind, bias, pick):
    """Forward, input gradient and weight (and bias) gradient of the
    routed Function equal F.conv2d / F.conv_transpose2d's under autograd,
    whichever backend the clock makes faster; three passes, each probed
    once."""
    route.ms = {True: 1.0, False: 2.0} if pick == "cudnn" else \
        {True: 3.0, False: 2.0}
    x, w, b = _case(kind, bias)
    _, transposed, _, _, _, s, p, op = kind

    def routed(x, w, b):
        return R.conv(x, w, b, s, p, 1, transposed, op)

    want = _grads(lambda *a: _plain(kind, *a), x, w, b)
    got = _grads(routed, x, w, b)
    assert len(got) == len(want)
    for g, t in zip(got, want):
        torch.testing.assert_close(g, t)
    assert _counts() == (3, 3 * (pick == "cudnn"), 3 * (pick == "native"))
    assert all(p.cudnn == (pick == "cudnn") for p in R.picks.values())
    passes = ("forward", "input", "weight")
    assert {p for k in R.picks for p in passes if p in k} == set(passes)


def test_pick_is_kept_per_key_and_pass(route):
    """The first call of a key probes each pass (a warm and two timed
    calls on each backend); later calls of it run the kept backend
    untimed; another shape is a key of its own."""
    kind = KINDS[2]
    x, w, b = _case(kind, True)
    for _ in range(3):
        _grads(lambda x, w, b: R.conv(x, w, b, 2, 1), x, w, b)
    assert R.probes == 3 and len(route.timed) == 3 * 6
    assert route.timed[:6] == [False] * 3 + [True] * 3
    assert _counts() == (3, 9, 0)
    _grads(lambda x, w, b: R.conv(x, w, b, 2, 1), x[:, :, :8, :8], w, b)
    assert R.probes == 6 and len(R.picks) == 6


def test_slower_cudnn_stops_early_and_native_is_kept(route):
    """cuDNN over twice the native median on its first timed call: one
    timed call, native kept."""
    route.ms = {True: 5.0, False: 2.0}
    x, w, _ = _case(KINDS[3], False)
    R.conv(x, w, None, 1, 1)
    (probe,) = R.picks.values()
    assert not probe.cudnn
    assert probe.native_ms == (2.0, 2.0) and probe.cudnn_ms == (5.0,)
    assert _counts() == (1, 0, 1)


@pytest.mark.parametrize("perturb,admitted", [(1e-3, False),
                                              (1e-4, False),
                                              (5e-6, True)])
def test_cudnn_admitted_only_within_tolerance(route, perturb, admitted):
    """A faster "cuDNN" whose result departs from the native one by more
    than 1e-5 of its largest magnitude is refused, and the result is the
    native one; within it, cuDNN is kept."""
    route.perturb = perturb
    kind = KINDS[1]
    x, w, b = _case(kind, True)
    want = _grads(lambda *a: _plain(kind, *a), x, w, b)
    got = _grads(lambda x, w, b: R.conv(x, w, b, 1, 3), x, w, b)
    assert all(p.cudnn == admitted for p in R.picks.values())
    for p in R.picks.values():
        assert p.gap == pytest.approx(perturb, rel=0.05)
    if not admitted:
        for g, t in zip(got, want):
            torch.testing.assert_close(g, t)
    assert R.probes == 3


def test_flag_set_for_each_pass_and_restored(route):
    """A pass runs with cuDNN on exactly where its pick says, and the
    previous flag comes back after it."""
    flags = torch.backends.cudnn
    seen = []

    def fn():
        seen.append(flags.enabled)
        return torch.ones(2)

    saved = flags.enabled
    try:
        flags.enabled = False
        R._run(("a",), fn)
        route.ms = {True: 3.0, False: 2.0}
        R._run(("b",), fn)
        seen.clear()
        R._run(("a",), fn)
        R._run(("b",), fn)
        assert seen == [True, False]
        assert flags.enabled is False
    finally:
        flags.enabled = saved


def _modules():
    torch.manual_seed(3)
    return nn.Sequential(
        nn.Conv2d(6, 8, 7, 1, 3, bias=False), nn.Conv2d(8, 8, 3, 2, 1),
        nn.ConvTranspose2d(8, 4, 3, 2, 1, output_padding=1, bias=False))


def test_block_catches_modules_and_functional(route):
    """Inside the block nn.Conv2d, nn.ConvTranspose2d and F.conv2d are
    routed (one forward pass each, three backward passes each but the
    first conv's input gradient); outside it nothing is."""
    m = _modules()
    x = torch.randn(2, 6, 12, 12)
    k = torch.randn(4, 4, 7, 7, requires_grad=True)
    with R.float32_convs():
        y = F.conv2d(m(x), k, padding=3)
        y.square().mean().backward()
    assert R.probes == 2 + 3 + 3 + 3
    assert R.cudnn_passes == R.probes and R.native_passes == 0
    before = _counts()
    F.conv2d(m(x), k, padding=3).square().mean().backward()
    assert _counts() == before


def test_half_cpu_and_outside_pass_through(route, monkeypatch):
    """bf16 tensors, CPU tensors (the real device test) and calls
    outside the block leave the counters and picks untouched."""
    m = _modules()
    x = torch.randn(1, 6, 8, 8)
    with R.float32_convs():
        m.to(torch.bfloat16)(x.to(torch.bfloat16))
        m.float()
        monkeypatch.setattr(R, "_on_card", lambda x: x.is_cuda)
        m(x).sum().backward()
    m(x)
    assert _counts() == (0, 0, 0) and R.picks == {}


@pytest.mark.parametrize("before", [True, False])
def test_block_restores_cudnn_and_keeps_tf32_off(route, before):
    """Inside full_fp32 and the block: cuDNN off outside the routed
    passes, both TF32 flags off also during a routed cuDNN pass; on exit
    cuDNN's flag is what it was."""
    flags, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = flags.enabled, flags.allow_tf32, matmul.allow_tf32
    seen = []

    def fn():
        seen.append((flags.enabled, flags.allow_tf32, matmul.allow_tf32))
        return torch.ones(1)

    try:
        flags.enabled, flags.allow_tf32, matmul.allow_tf32 = before, True, \
            True
        with full_fp32(), R.float32_convs():
            assert not flags.enabled
            R._run(("k",), fn)
            F.conv2d(torch.randn(1, 2, 5, 5), torch.randn(3, 2, 3, 3))
            assert (flags.enabled, flags.allow_tf32, matmul.allow_tf32) \
                == (False, False, False)
        assert seen[-1] == (True, False, False)
        assert flags.enabled is before
    finally:
        flags.enabled, flags.allow_tf32, matmul.allow_tf32 = saved


@pytest.mark.parametrize("pick", ["native", "cudnn"])
def test_generator_block_equal_under_the_route(route, pick):
    """A residual block and a transposed conv, forward and backward,
    routed against unrouted: equal outputs and parameter gradients."""
    route.ms = {True: 1.0, False: 2.0} if pick == "cudnn" else \
        {True: 3.0, False: 2.0}
    torch.manual_seed(4)
    net = nn.Sequential(ResidualBlock(8),
                        nn.ConvTranspose2d(8, 4, 3, 2, 1, output_padding=1))
    x = torch.randn(2, 8, 10, 10, requires_grad=True)

    def run():
        net.zero_grad()
        x.grad = None
        net(x).tanh().sum().backward()
        return [x.grad.clone()] + [p.grad.clone() for p in net.parameters()]

    want = run()
    with R.float32_convs():
        got = run()
    assert R.probes > 0
    for g, t in zip(got, want):
        torch.testing.assert_close(g, t)


@pytest.mark.cuda
def test_post_tune_passes_match_native_on_the_card(monkeypatch):
    """Every routed pass of a post-tune (the pair batch of 8 and two
    tune steps at batch 4, 256², published widths, the face loss on)
    against the native pass on the same tensors: each cuDNN pick was
    admitted within the route's tolerance; every forward and input
    gradient stays within it; a weight gradient, a sum over the batch and
    the image whose departure moves with the data, stays under a quarter
    of cuDNN's TF32 departure on the same tensors (the precision below);
    some pass runs on cuDNN."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from impersonator_tpu_torch.assets import bench_assets
    from impersonator_tpu_torch.config import TestConfig
    from impersonator_tpu_torch.models.facenet import Sphere20a
    from impersonator_tpu_torch.tasks import imitator as TI
    from impersonator_tpu_torch.tasks import post_tune as TP

    torch.manual_seed(0)
    imit = TI.Imitator(TestConfig(image_size=256, front_warp=True),
                       assets=bench_assets(), device="cuda")
    face = Sphere20a().cuda().eval().requires_grad_(False)
    rng = np.random.default_rng(0)
    theta = np.zeros(85, np.float32)
    theta[0] = 0.9
    theta[3:75] = rng.normal(0, 0.05, 72)
    imit.personalize(rng.uniform(-1, 1, (256, 256, 3)).astype(np.float32),
                     src_smpl=theta)
    rows = []
    run = R._run
    flags = torch.backends.cudnn

    def checked(key, fn):
        out = run(key, fn)
        want = R._on(False, fn)
        saved, flags.allow_tf32 = flags.allow_tf32, True
        try:
            lower = R._gap(R._on(True, fn), want)
        finally:
            flags.allow_tf32 = saved
        rows.append((key, R._gap(out, want), lower))
        return out

    monkeypatch.setattr(R, "_run", checked)
    before = R.cudnn_passes
    priors = TP.default_prior_poses(imit.src_info["theta"], 8)
    TP.adaptive_personalize(imit, priors, epochs=1, batch_size=4,
                            use_face=True, face=face)
    assert rows and R.cudnn_passes > before
    assert all(R.picks[k].gap <= R.TOLERANCE for k, _, _ in rows
               if R.picks[k].cudnn)
    for key, gap, lower in rows:
        if "weight" in key:
            assert gap <= lower / 4, (key, gap, lower)
        else:
            assert gap <= R.TOLERANCE, (key, gap)
