"""Reduction of a finished ``torch.profiler`` profile, recorded with the
host's ops and the device's activity, to one row per program span: the
``record_function`` ranges that the program's
``utils.profiling.span`` opens while a profiler records.

A device activity (kernel, copy, set) belongs to every span whose host
interval holds the runtime call that launched it, matched by the
profiler's correlation id whatever thread made the call (autograd
launches the backward from its own thread, inside the caller's
``train.g_grad``). A row:

* ``n``: the span's count;
* ``device_s``: the union of the device intervals that belong to it
  (its children's included), so overlapping kernels count once;
* ``self_s``: the same of those whose innermost span it is;
* ``host_s``: the union of its host intervals;
* ``idle_s``: the device-idle seconds of the gaps (``trace.gaps`` over
  the ``bench.window`` range) that began inside it;
* ``syncs``: the blocking runtime calls made inside it;
* ``under``: for each top-level span (``TOP``) that held it,
  ``device_s`` of the activities that also belong to that span.

:func:`metric` holds the per-layer values these rows give, each None
when the record has no span table or the span never ran."""

from __future__ import annotations

from lwg_bench import trace

# the program's spans, as impersonator_tpu_torch.utils.profiling lists
# them; the top-level ones hold the others
SPANS = ("personalize", "hmr", "imitate.batch", "imitate.geometry", "warp",
         "imitate.generator", "imitate.composite", "train.step",
         "train.body_flow", "train.g_loss", "train.g_grad", "train.d",
         "train.adam")
TOP = ("personalize", "imitate.batch", "train.step")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")


def blocking(name: str) -> bool:
    """A runtime call that waits for the device: a synchronise, or a
    ``cudaMemcpy*`` without ``Async``."""
    return name in SYNCS or (name.startswith("cudaMemcpy")
                             and "Async" not in name)


def events(prof):
    """(program spans (name, start, end), runtime calls (name, start,
    end, correlation id), device activities (name, start, end,
    correlation id), the ``bench.window`` range or None) of a finished
    profile, in ns. Device-side mirrors of ``record_function`` ranges
    are no activity (as in ``trace.events``)."""
    ranges, calls, dev, window = [], [], [], None
    for e in prof.profiler.kineto_results.events():
        name, a = e.name(), e.start_ns()
        b = a + e.duration_ns()
        kind = str(e.device_type())
        if kind.endswith("CUDA"):
            if not (e.is_user_annotation() or name.startswith("bench.")):
                dev.append((name, a, b, e.correlation_id()))
        elif not kind.endswith("CPU"):
            continue
        elif e.is_user_annotation():
            if name in SPANS:
                ranges.append((name, a, b))
            elif name == "bench.window":
                window = (a, b)
        elif name.startswith("cu") and "::" not in name:
            # a CUDA runtime (cuda*) or low-level API (cu*) call
            calls.append((name, a, b, e.correlation_id()))
    return ranges, calls, dev, window


class Attribution:
    """The spans each device activity, idle gap and blocking call of a
    stretch belongs to (see the module's docstring). ``ranges`` (name,
    start, end) the program spans, ``calls`` (name, start, end,
    correlation id) the runtime calls, ``dev`` (name, start, end,
    correlation id) the device activities, ``window`` (lo, hi) the
    stretch (by default from the first to the last event), all in
    ns."""

    def __init__(self, ranges, calls, dev, window=None):
        self.ranges = sorted(ranges, key=lambda r: (r[1], -r[2]))
        if window is None:
            ts = [t for r in self.ranges for t in r[1:3]] + \
                 [t for _, a, b, _ in dev for t in (a, b)]
            window = (min(ts), max(ts)) if ts else (0, 0)
        lo, hi = window
        gaps = trace.gaps([(max(a, lo), min(b, hi)) for _, a, b, _ in dev
                           if b > lo and a < hi], lo, hi)
        launch = {c[3]: c[1] for c in calls}
        held = self.holding([launch.get(d[3]) for d in dev]
                            + [c[1] for c in calls] + [a for a, _ in gaps]
                            + [r[1] for r in self.ranges])
        self.dev = [(a, b, h) for (_, a, b, _), h in zip(dev, held)]
        held = held[len(dev):]
        self.calls = [(c[0], h) for c, h in zip(calls, held)]
        held = held[len(calls):]
        self.gaps = [(a, b, h) for (a, b), h in zip(gaps, held)]
        # each span's own start lies in it and in those around it
        self.around = held[len(gaps):]

    def holding(self, times) -> list:
        """For each time of ``times`` (ns, or None), the indices of the
        spans whose interval holds it, outermost first (none for None):
        one sweep over the spans' starts and ends."""
        ends = sorted((r[2], j) for j, r in enumerate(self.ranges))
        out = [()] * len(times)
        active, si, ei = set(), 0, 0
        for t, k in sorted((t, k) for k, t in enumerate(times)
                           if t is not None):
            while si < len(self.ranges) and self.ranges[si][1] <= t:
                active.add(si)
                si += 1
            while ei < len(ends) and ends[ei][0] <= t:
                active.discard(ends[ei][1])
                ei += 1
            out[k] = tuple(sorted(active))
        return out

    def union_s(self, names) -> float:
        """Device seconds of the activities that belong to any span of
        ``names``."""
        names = set(names)
        return trace.union_s([(a, b) for a, b, held in self.dev
                              if any(self.ranges[j][0] in names
                                     for j in held)])

    def table(self) -> dict:
        """{span name: its row} for every span that ran."""
        rows, dev, own, under = {}, {}, {}, {}
        for (name, a, b), around in zip(self.ranges, self.around):
            r = rows.setdefault(name, {"n": 0, "host": []})
            r["n"] += 1
            r["host"].append((a, b))
            for j in around:
                if self.ranges[j][0] in TOP:
                    under.setdefault((name, self.ranges[j][0]), [])
        for a, b, held in self.dev:
            names = {self.ranges[j][0] for j in held}
            tops = names & set(TOP)
            for n in names:
                dev.setdefault(n, []).append((a, b))
                for top in tops:
                    under.setdefault((n, top), []).append((a, b))
            if held:
                own.setdefault(self.ranges[held[-1]][0], []).append((a, b))
        idle, syncs = {}, {}
        for a, b, held in self.gaps:
            for n in {self.ranges[j][0] for j in held}:
                idle[n] = idle.get(n, 0) + (b - a)
        for call, held in self.calls:
            if blocking(call):
                for n in {self.ranges[j][0] for j in held}:
                    syncs[n] = syncs.get(n, 0) + 1
        out = {}
        for n, r in rows.items():
            out[n] = {"n": r["n"],
                      "device_s": trace.union_s(dev.get(n, [])),
                      "self_s": trace.union_s(own.get(n, [])),
                      "host_s": trace.union_s(r["host"]),
                      "idle_s": idle.get(n, 0) / 1e9,
                      "syncs": syncs.get(n, 0),
                      "under": {top: trace.union_s(iv)
                                for (m, top), iv in under.items() if m == n}}
        return out


def table(prof) -> dict:
    """The span table of a finished profile recorded with host ops."""
    return Attribution(*events(prof)).table()


def rounded(rows: dict, digits: int = 4) -> dict:
    """The table with every float to ``digits`` significant figures."""
    def r(v):
        if isinstance(v, float):
            return float(f"{v:.{digits}g}")
        if isinstance(v, dict):
            return {k: r(x) for k, x in v.items()}
        return v
    return r(rows)


# per-layer metric -> (span, the span whose count divides it, the
# top-level span its activities must also belong to, or None)
METRICS = {
    "geometry_ms": ("imitate.geometry", "imitate.batch", None),
    "warp_ms": ("warp", "imitate.batch", "imitate.batch"),
    "generator_ms": ("imitate.generator", "imitate.batch", None),
    "composite_ms": ("imitate.composite", "imitate.batch", None),
    "personalize_device_ms": ("personalize", "personalize", None),
    "hmr_batch_ms": ("hmr", "imitate.batch", "imitate.batch"),
    "body_flow_step_ms": ("train.body_flow", "train.step", None),
    "g_loss_ms": ("train.g_loss", "train.step", None),
    "g_grad_ms": ("train.g_grad", "train.step", None),
    "d_ms": ("train.d", "train.step", None),
    "adam_ms": ("train.adam", "train.step", None),
}


def metric(rec: dict, name: str, digits: int = 4):
    """Per-layer metric ``name`` of ``METRICS`` from a record's span
    table (``rec["spans"]``): the span's device ms (inclusive; with a
    top-level span, only its activities that also belong to that span)
    over the count of the dividing span, to ``digits`` significant
    figures. None without a table, or where either span never ran."""
    rows = rec.get("spans")
    span, per, top = METRICS[name]
    if not rows or span not in rows or not rows.get(per, {}).get("n"):
        return None
    row = rows[span]
    if top is None:
        s = row["device_s"]
    elif top in row["under"]:
        s = row["under"][top]
    else:
        return None
    return float(f"{1e3 * s / rows[per]['n']:.{digits}g}")
