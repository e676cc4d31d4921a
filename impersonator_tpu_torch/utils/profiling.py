"""Profiling (torch port of ``impersonator_tpu/utils/profiling.py``).

* :class:`span` — a named stretch of the program's hot paths, seen on the
  profiler's timeline while a ``torch.profiler`` records, and one flag
  read otherwise;
* :func:`trace` — a context manager around ``torch.profiler`` that writes
  a TensorBoard / Chrome trace into a directory, the spans on the host
  timeline above the kernels they launched.

The spans, by name (dotted, stable): ``personalize``, ``hmr``,
``imitate.batch`` (holding ``imitate.geometry``, ``imitate.generator``,
``imitate.composite``), ``warp``; ``train.step`` (holding
``train.body_flow``, ``train.g_loss``, ``train.g_grad``, ``train.d``,
``train.allreduce`` under a process group, ``train.adam``);
``posttune`` (holding ``posttune.pairs``, ``posttune.step``,
``posttune.refresh``).
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler


class span:
    """``with span("imitate.generator"): ...`` names the block for the
    profiler. While a profiler records, the block runs inside a
    ``record_function`` range of that name, whose start and end lie on
    the profiler's clock with the device activity it launched; otherwise
    entering and leaving read one flag and do nothing else (no clock, no
    synchronise)."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self):
        # torch's own flag, set while any torch.profiler records
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """``with profiling.trace('/tmp/trace'): step(...)`` records the host
    (the spans among its ops) and, on a CUDA device, the card's kernels;
    yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof
