"""Profiling and timing (torch port of
``impersonator_tpu/utils/profiling.py``).

* :func:`trace` — a context manager around ``torch.profiler`` that writes
  a TensorBoard / Chrome trace into a directory;
* :class:`StepTimer` — per-phase wall-clock timers with p50 / p95
  summaries; a phase on a CUDA device synchronises it before each clock
  read, so the time covers the device's work, not its enqueue;
* :func:`device_memory_stats` — ``torch.cuda.memory_stats`` of every
  visible card.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """``with profiling.trace('/tmp/trace'): step(...)`` records the host
    and, on a CUDA device, the card's kernels; yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


def _sync(device):
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class StepTimer:
    def __init__(self):
        self.samples = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str, device=None):
        """Time the block; with a CUDA ``device`` the card is synchronised
        before the start and the end are read."""
        _sync(device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync(device)
            self.samples[name].append(time.perf_counter() - t0)

    def summary(self) -> dict:
        out = {}
        for name, xs in self.samples.items():
            arr = np.asarray(xs)
            out[name] = {
                "count": len(xs),
                "mean_s": float(arr.mean()),
                "p50_s": float(np.percentile(arr, 50)),
                "p95_s": float(np.percentile(arr, 95)),
            }
        return out


def device_memory_stats() -> dict:
    """{"cuda:i": memory stats} of every visible card ({} without one)."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": dict(torch.cuda.memory_stats(i))
            for i in range(torch.cuda.device_count())}
