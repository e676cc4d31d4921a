"""Reduction of a ``torch.profiler`` trace to the numbers the per-layer
metrics read, and the table of the card's published peaks.

Device time is the union of the intervals in which some operation ran
on the device (kernels, copies, sets), so kernels that overlap on side
streams count once."""

from __future__ import annotations

import bisect
import time

# NVIDIA H100 SXM data sheet, dense: bf16 989 TFLOP/s on the tensor
# cores, float32 67 TFLOP/s outside them, TF32 495, HBM3 3.35 TB/s; at
# the full 700 W power limit.
PEAK = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12,
        "bytes": 3.35e12}


def bound_s(ops: float, nbytes: float, dtype: str = "float32") -> float:
    """Least time the card could take for ``ops`` operations in ``dtype``
    and ``nbytes`` moved: the larger of the two over their peaks."""
    return max(ops / PEAK[dtype], nbytes / PEAK["bytes"])


def union_s(intervals) -> float:
    """Seconds covered by the union of (start, end) intervals in ns."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e9


def gaps(intervals, lo, hi):
    """The idle stretches (start, end) in ns between lo and hi that no
    interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def events(prof):
    """(device activities, host ops) of a finished profile, each a list
    of (name, start ns, end ns)."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        row = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        kind = str(e.device_type())
        if kind.endswith("CUDA"):
            # a record_function range is mirrored on the device's
            # timeline; it is no operation
            if not (e.is_user_annotation() or e.name().startswith(
                    "bench.")):
                dev.append(row)
        elif kind.endswith("CPU"):
            host.append(row)
    return dev, host


def host_at(host, starts, marks, t, reach: int = 4000):
    """What the host was doing at time t: the innermost op (latest start)
    running then, else the innermost ``bench.*`` range of the harness
    (the host in Python between ops), else 'host: idle'. ``host`` sorted
    by start without the ``bench.*`` ranges, ``starts`` its starts,
    ``marks`` those ranges."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - reach), -1):
        if host[j][2] > t:
            return host[j][0]
    inside = [m for m in marks if m[1] <= t < m[2]]
    if inside:
        return max(inside, key=lambda m: m[1])[0] + " (python)"
    return "host: idle"


def profile(fn, cuda: bool, host: bool):
    """Run ``fn`` under ``torch.profiler``: device activity only (the
    host's ops unrecorded, so the host runs at its own pace), or with
    ``host`` its ops too. -> (the profile, the stretch's seconds on the
    device's clock: CUDA events around it; on the host's without a
    card)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from torch.profiler import record_function

    import torch
    acts = ([ProfilerActivity.CUDA] if cuda else []) + (
        [ProfilerActivity.CPU] if host or not cuda else [])
    with torch_profile(activities=acts) as prof:
        with record_function("bench.window"):
            if cuda:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
            t = time.perf_counter()
            fn()
            if cuda:
                b.record()
                b.synchronize()
            wall = time.perf_counter() - t
    return prof, (a.elapsed_time(b) / 1e3 if cuda else wall)


def device_summary(prof, wall_s: float, top: int = 8,
                   name_len: int = 40) -> dict:
    """busy seconds (the union of the device's activity), the stretch's
    seconds, each device op's seconds and launches, and the ``top`` ops
    by time."""
    dev = events(prof)[0]
    by_name: dict = {}
    for n, a, b in dev:
        t, c = by_name.get(n, (0.0, 0))
        by_name[n] = (t + (b - a) / 1e9, c + 1)
    secs = {n: t for n, (t, _) in by_name.items()}
    return {"busy_s": union_s([(a, b) for _, a, b in dev]),
            "window_s": wall_s, "device_ops": secs,
            "launches": {n: c for n, (_, c) in by_name.items()},
            "top_ops": _top(secs, top, name_len)}


def idle_by_host(prof, top: int = 8, name_len: int = 40) -> list:
    """The ``top`` host ops by the device idle time that began while they
    ran, over the ``bench.window`` range of a profile with host ops."""
    dev, host = events(prof)
    lo, hi = next((a, b) for n, a, b in host if n == "bench.window")
    spans = [(max(a, lo), min(b, hi)) for _, a, b in dev
             if b > lo and a < hi]
    marks = [r for r in host if r[0].startswith("bench.")]
    host = sorted((r for r in host if not r[0].startswith("bench.")),
                  key=lambda r: r[1])
    starts = [r[1] for r in host]
    idle: dict = {}
    for a, b in gaps(spans, lo, hi):
        who = host_at(host, starts, marks, a)
        idle[who] = idle.get(who, 0.0) + (b - a) / 1e9
    return _top(idle, top, name_len)


def _top(seconds: dict, top: int, name_len: int) -> list:
    """The ``top`` entries of {name: seconds} by seconds, names cut to
    ``name_len`` characters and merged where the cut makes them equal."""
    cut: dict = {}
    for n, t in seconds.items():
        cut[n[:name_len]] = cut.get(n[:name_len], 0.0) + t
    return [[n, t] for n, t in sorted(cut.items(),
                                      key=lambda kv: -kv[1])[:top]]
