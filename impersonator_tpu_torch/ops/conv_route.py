"""Float32 convolutions routed by shape and pass between cuDNN and
PyTorch's own CUDA kernels.

In float32 without TF32, cuDNN 9 serves some convolutions far worse than
PyTorch's im2col + cuBLAS path (the generator's 256 -> 128 3×3 skip conv
at 128², batch 4, gets an FFT engine: ~380 ms a call against 1.4 ms on an
H100) and most of them better. Inside :func:`float32_convs` cuDNN is off
for everything but convolutions, and every float32 CUDA ``conv2d`` /
``conv_transpose2d`` (``nn.Conv2d``, ``nn.ConvTranspose2d``,
``F.conv2d``, however reached) runs through one autograd Function whose
three passes (forward, input gradient, weight gradient) each run with
cuDNN on or off, as chosen for the call's key: transposed or not, the
input's shape and strides, the weight's shape, stride, padding, output
padding, dilation, groups, bias, and the pass (for a gradient pass, the
incoming gradient's strides too).

The choice is observed: on a key's first call the pass runs on both
backends, one warm call and two timed by CUDA events each (cuDNN's stop
at the first over twice the native median), and the faster is kept for
the process. cuDNN is admissible only where its result departs from the
native one by at most :data:`TOLERANCE` of the result's largest
magnitude on that first call (float32 summation order; TF32 reads
~3e-4 to 9e-4). A weight gradient sums over the batch and the image, and
its departure moves with the data: on later calls of the generator's
admitted keys it read up to ~7e-5 on an H100, still a tenth of TF32's.
Neither TF32 flag is touched. Half-precision and CPU tensors, and calls outside the block,
pass through untouched.

Counters, over the process: :data:`probes` (keys timed),
:data:`cudnn_passes` and :data:`native_passes` (passes run on each
backend, a key's first included). :data:`picks` holds each key's
:class:`Probe`.
"""

from __future__ import annotations

import contextlib
import statistics
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable
from torch.overrides import TorchFunctionMode

# the largest departure from the native result, over the result's largest
# magnitude, that admits cuDNN for a pass
TOLERANCE = 1e-5

probes = 0
cudnn_passes = 0
native_passes = 0


class Probe(NamedTuple):
    """A key's timing: whether cuDNN runs it, each backend's timed ms
    (cuDNN's cut short where it lost by 2×), cuDNN's departure from the
    native result over the result's largest magnitude."""
    cudnn: bool
    native_ms: tuple
    cudnn_ms: tuple
    gap: float


picks: dict = {}


def _on(use_cudnn: bool, fn):
    """fn() with cuDNN on or off; the flag comes back after."""
    flags = torch.backends.cudnn
    saved = flags.enabled
    flags.enabled = use_cudnn
    try:
        return fn()
    finally:
        flags.enabled = saved


def _time_ms(use_cudnn: bool, fn):
    """(device ms, result) of one fn() on a backend, by CUDA events on
    the current stream."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = _on(use_cudnn, fn)
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def _timings(use_cudnn: bool, fn, give_up: float = float("inf")):
    """(ms of up to two timed calls after a warm one, stopping after a
    call over ``give_up``; the last result)."""
    _, out = _time_ms(use_cudnn, fn)
    times = []
    for _ in range(2):
        ms, out = _time_ms(use_cudnn, fn)
        times.append(ms)
        if ms > give_up:
            break
    return tuple(times), out


def _tensors(out):
    return [t for t in (out if isinstance(out, tuple) else (out,))
            if t is not None]


def _gap(got, want) -> float:
    """The largest |got - want| over the largest |want|, over every
    tensor of two results."""
    worst = 0.0
    for g, w in zip(_tensors(got), _tensors(want)):
        diff = float((g - w).abs().max())
        scale = float(w.abs().max())
        worst = max(worst, diff / scale if scale > 0
                    else (0.0 if diff == 0 else float("inf")))
    return worst


def _probe(fn):
    """A pass timed on both backends -> (its :class:`Probe`, the kept
    backend's result)."""
    global probes
    probes += 1
    native_ms, want = _timings(False, fn)
    ref = statistics.median(native_ms)
    cudnn_ms, got = _timings(True, fn, 2 * ref)
    gap = _gap(got, want)
    use = statistics.median(cudnn_ms) < ref and gap <= TOLERANCE
    return Probe(use, native_ms, cudnn_ms, gap), (got if use else want)


def _run(key: tuple, fn):
    """fn(), one pass, on the backend kept for ``key`` (probed on the
    key's first call)."""
    global cudnn_passes, native_passes
    probe = picks.get(key)
    if probe is None:
        probe, out = _probe(fn)
        picks[key] = probe
    else:
        out = _on(probe.cudnn, fn)
    if probe.cudnn:
        cudnn_passes += 1
    else:
        native_passes += 1
    return out


class _Conv(torch.autograd.Function):
    """A convolution (``aten.convolution``'s arguments) whose forward,
    input gradient and weight gradient are each routed by :func:`_run`:
    PyTorch picks a backward's backend from the global flag when autograd
    runs it, so the backward chooses for itself."""

    @staticmethod
    def forward(ctx, x, w, b, key, stride, padding, dilation, transposed,
                output_padding, groups):
        ctx.save_for_backward(x, w)
        ctx.key = key
        ctx.args = (stride, padding, dilation, transposed, output_padding,
                    groups)
        ctx.bias_sizes = None if b is None else [b.shape[0]]
        return _run(key + ("forward",), lambda: torch.ops.aten.convolution(
            x, w, b, stride, padding, dilation, transposed, output_padding,
            groups))

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        key = ctx.key + (g.stride(),)

        def grads(mask):
            return lambda: torch.ops.aten.convolution_backward(
                g, x, w, ctx.bias_sizes, *ctx.args, mask)

        gx = gw = gb = None
        if need_x:
            gx = _run(key + ("input",), grads([True, False, False]))[0]
        if need_w or need_b:
            _, gw, gb = _run(key + ("weight", need_w, need_b),
                             grads([False, need_w, need_b]))
        return gx, gw, gb, *(None,) * 7


def _pair(v) -> list:
    return [v, v] if isinstance(v, int) else list(v)


def conv(x, w, b=None, stride=1, padding=0, dilation=1, transposed=False,
         output_padding=0, groups=1):
    """``aten.convolution`` of a 4-D input through :class:`_Conv`."""
    stride, padding, dilation, output_padding = (
        _pair(stride), _pair(padding), _pair(dilation),
        _pair(output_padding))
    key = (transposed, tuple(x.shape), x.stride(), tuple(w.shape),
           tuple(stride), tuple(padding), tuple(output_padding),
           tuple(dilation), groups, b is not None)
    return _Conv.apply(x, w, b, key, stride, padding, dilation, transposed,
                       output_padding, groups)


# the parameters of F.conv2d and F.conv_transpose2d in order, and their
# defaults
_CONV2D = ("input", "weight", "bias", "stride", "padding", "dilation",
           "groups")
_CONV_T2D = ("input", "weight", "bias", "stride", "padding",
             "output_padding", "groups", "dilation")
_DEFAULTS = {"bias": None, "stride": 1, "padding": 0, "output_padding": 0,
             "dilation": 1, "groups": 1}


def _on_card(x) -> bool:
    return x.is_cuda


def _routable(a: dict) -> bool:
    """Whether a call's bound arguments are a float32 4-D CUDA
    convolution with numeric padding."""
    x, w, b = a["input"], a["weight"], a["bias"]
    return (_on_card(x) and x.dim() == 4
            and x.dtype == w.dtype == torch.float32
            and (b is None or b.dtype == torch.float32)
            and not isinstance(a["padding"], str))


class _Route(TorchFunctionMode):
    """Sends every routable ``F.conv2d`` / ``F.conv_transpose2d`` of the
    block to :func:`conv`; everything else runs as called."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        transposed = func is F.conv_transpose2d
        if transposed or func is F.conv2d:
            names = _CONV_T2D if transposed else _CONV2D
            a = {**_DEFAULTS, **dict(zip(names, args)), **kwargs}
            if _routable(a):
                return conv(a["input"], a["weight"], a["bias"], a["stride"],
                            a["padding"], a["dilation"], transposed,
                            a["output_padding"], a["groups"])
        return func(*args, **kwargs)


@contextlib.contextmanager
def float32_convs():
    """cuDNN off inside the block (norms, the sampler and the rest run
    PyTorch's own kernels), except for the float32 CUDA convolutions,
    each pass of which runs on the backend measured fastest for its key
    (see the module's docstring); the previous flag comes back on exit.
    Leaves the TF32 flags as they are."""
    flags = torch.backends.cudnn
    saved = flags.enabled
    flags.enabled = False
    try:
        with _Route():
            yield
    finally:
        flags.enabled = saved
