"""The program's spans in one cell of ``BENCHMARK.json``, on a card:

    python3 lwg_bench/span_split.py --workload NAME --seed N

From the root of a checkout. Builds the cell's program through
``lwg_bench/drivers/`` and warms it up as a run does, then:

* the host seconds of ``--units`` jobs (steps), with no profiler;
* one job (one step) under the profiler with device activity only, as a
  traced run's first stretch, with the spans on and then with
  ``utils.profiling.span`` stubbed out: the device operations' names and
  launches (``trace.device_summary``) of the two, and whether they are
  equal;
* ``--units`` jobs (steps) with the host's ops recorded too,
  within the harness's ``bench.*`` ranges: the span table
  (``lwg_bench/spans.py``), the per-layer values it gives, the share of
  the stretch's device time that the top-level spans and, in training,
  the five children of ``train.step`` hold, the share of device
  activities linked to their launch, and the idle gaps as
  ``trace.idle_by_host`` names them;
* the host's microseconds per span entered and left, with no profiler
  recording and with one recording host and device.

Prints one JSON line."""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
TRAIN_CHILDREN = ("train.body_flow", "train.g_loss", "train.g_grad",
                  "train.d", "train.adam")


def span_cost_us(recording: bool, n: int) -> float:
    """Host microseconds per ``with span(...)`` entered and left, over
    ``n`` in a row; with ``recording`` under a profiler of the host and,
    where there is a card, the device."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from impersonator_tpu_torch.utils.profiling import span

    def loop():
        t = time.perf_counter()
        for _ in range(n):
            with span("imitate.generator"):
                pass
        return 1e6 * (time.perf_counter() - t) / n

    if not recording:
        loop()
        return loop()
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts):
        return loop()


@contextlib.contextmanager
def stubbed():
    """``utils.profiling.span`` doing nothing, for the block."""
    from impersonator_tpu_torch.utils import profiling
    saved = profiling.span.__enter__, profiling.span.__exit__
    profiling.span.__enter__ = lambda self: None
    profiling.span.__exit__ = lambda self, *exc: None
    try:
        yield
    finally:
        profiling.span.__enter__, profiling.span.__exit__ = saved


def stretches(cfg: dict, mix: dict, seed: int, device):
    """The cell's program, warmed up -> (one unit of work: a job or a
    step, within the ranges a traced run opens; the unit's name; the
    host stretch's default number of units)."""
    from torch.profiler import record_function

    from lwg_bench.drivers import imitate, train
    if mix["driver"] == "train":
        cell = train.Cell(cfg, mix, seed, device)
        for _ in range(mix["check_steps"] + mix["warm_steps"]):
            cell.step(cell.state, cell.ring[cell.steps % len(cell.ring)])
            cell.steps += 1

        def unit(i):
            with record_function("bench.step"):
                cell.step(cell.state, cell.ring[cell.steps % len(cell.ring)])
            cell.steps += 1
        return unit, "steps", 3
    cell = imitate.Cell(cfg, mix, seed, device)
    cell.warm_up()

    def unit(i):
        job = cell.jobs[i % len(cell.jobs)]
        with record_function("bench.personalize"):
            cell.imitator.personalize(job.src_img, job.src_theta)
        with record_function("bench.imitate"):
            out = cell.imitate(job)
        with record_function("bench.readback"):
            cell.host[:job.length].copy_(out)
    return unit, "jobs", 2


def split(cfg: dict, mix: dict, seed: int, device, n: int | None = None,
          cost_n: int = 20000) -> dict:
    """Everything the module's docstring lists, for one cell."""
    import torch

    from lwg_bench import spans, trace
    device = torch.device(device)
    cuda = device.type == "cuda"
    unit, units, default = stretches(cfg, mix, seed, device)
    n = default if n is None else n

    def run(k):
        def go():
            for i in range(k):
                unit(i)
        return go

    t = time.perf_counter()
    run(n)()
    if cuda:
        torch.cuda.synchronize(device)
    unit_host_s = (time.perf_counter() - t) / n

    def device_ops():
        prof, wall = trace.profile(run(1), cuda, host=False)
        summary = trace.device_summary(prof, wall)
        return summary["launches"], summary["busy_s"]

    on = device_ops()
    with stubbed():
        off = device_ops()
    prof, wall = trace.profile(run(n), cuda, host=True)
    ranges, calls, dev, window = spans.events(prof)
    att = spans.Attribution(ranges, calls, dev, window)
    rows = att.table()
    busy = trace.union_s([(a, b) for a, b, _ in att.dev])
    linked = {c[3] for c in calls}
    out = {
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "torch": torch.__version__,
        units: n, "unit_host_s": unit_host_s,
        "same_device_ops": on[0] == off[0],
        "span_names_in_device_ops": sorted(
            k for k in on[0] if k in spans.SPANS or k.startswith("bench.")),
        "busy_s_spans_vs_stubbed": [on[1], off[1]],
        "host_stretch": {"busy_s": busy, "window_s": wall,
                         "activities": len(dev),
                         "launch_linked_share": sum(
                             1 for d in dev if d[3] in linked)
                         / max(1, len(dev)),
                         "top_share": att.union_s(spans.TOP) / busy
                         if busy else None},
        "metrics": {m: spans.metric({"spans": rows}, m)
                    for m in spans.METRICS},
        "spans": spans.rounded(rows),
        "idle_gaps": trace.idle_by_host(prof),
        "span_cost_us": {"off": span_cost_us(False, cost_n),
                         "recording": span_cost_us(True, cost_n // 10)},
    }
    if "train.step" in rows and rows["train.step"]["device_s"]:
        out["host_stretch"]["train_children_share"] = (
            att.union_s(TRAIN_CHILDREN) / rows["train.step"]["device_s"])
    if not out["same_device_ops"]:
        out["launch_diff"] = {k: [on[0].get(k), off[0].get(k)]
                              for k in set(on[0]) | set(off[0])
                              if on[0].get(k) != off[0].get(k)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--units", type=int, default=None,
                    help="jobs or steps of the host stretch")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from lwg_bench import run
    run.cache_env()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    _, cfg, mix = run.cell_of(run.spec(), args.workload)
    out = {"workload": args.workload, "seed": args.seed,
           **split(cfg, mix, args.seed, "cuda", args.units)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
