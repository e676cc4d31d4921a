"""Run one cell of ``BENCHMARK.json`` once and print its result.

    python3 lwg_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout. The cell names a configuration
(``lwg_bench/configs/<config>.json``) and a traffic mix
(``lwg_bench/traffic/<traffic>.json``, whose ``driver`` picks
``lwg_bench/drivers/<driver>.py``); each metric is read from the run's
record by ``lwg_bench/metrics/<metric>.py``. ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics. The last
line of standard output is the result's JSON; the numbers compared with
the plain reference, each with its limit, are the last lines of standard
error and the result's last key. Without a card, or with fewer cards
than the cell asks for, it exits 3 and prints no result; if JAX or the
JAX package was loaded, 4."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "impersonator_tpu")


def cache_env():
    """Every build and kernel cache at a fixed path inside the checkout;
    libraries that could load JAX by themselves are told not to."""
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"


def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_of(bench: dict, name: str):
    """(workload entry, configuration, traffic mix) of cell ``name``."""
    for w in bench["workloads"]:
        if w["name"] == name:
            conf = next(c for c in bench["configs"]
                        if c["name"] == w["config"])
            cfg = json.loads((ROOT / conf["file"]).read_text())
            mix = json.loads((BENCH / "traffic" /
                              f"{w['traffic']}.json").read_text())
            return w, cfg, mix
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: str, traced: bool) -> list:
    """The metric entries a cell reports: its end-to-end metrics, or with
    ``traced`` its per-layer ones (those listing it, or, without a
    ``workloads`` key, those whose ``moves`` metric it reports)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in names)]


def reader(name: str):
    """The ``read(record)`` function of ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    sp = importlib.util.spec_from_file_location(f"lwg_metric_{name}", path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def forbidden_loaded() -> list:
    """Top-level names of loaded modules that are JAX or the JAX
    package, compared whole."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def result(bench: dict, name: str, seed: int, seconds: float,
           traced: bool, device="cuda", t_start=None):
    """Run cell ``name`` once on ``device`` -> (the result's JSON object,
    the run's record): the metrics the cell reports, read from the
    record, and ``correct`` from each compared number against its
    limit."""
    import torch
    work, cfg, mix = cell_of(bench, name)
    driver = importlib.import_module(f"lwg_bench.drivers.{mix['driver']}")
    rec = driver.run(cfg, mix, seed, seconds, traced, device,
                     t_start=t_start)
    metrics = {}
    for m in metrics_of(bench, name, traced):
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    check = {k: {"value": rec["gaps"][k], "limit": v}
             for k, v in mix["limits"].items()}
    correct = all(c["value"] <= c["limit"] for c in check.values())
    kind = (torch.cuda.get_device_name(0) if torch.device(device).type
            == "cuda" else "cpu")
    dev = {"platform": "gpu", "kind": kind, "count": work["chips"],
           "memory_peak_bytes": rec["memory_peak_bytes"]}
    out = {"correct": correct, "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics, "device": dev}
    if traced and "profile" in rec:
        dev["busy_s"] = rec["profile"]["busy_s"]
        dev["window_s"] = rec["profile"]["window_s"]
        out["breakdown"] = rec["profile"]["breakdown"]
    out["check"] = check
    return out, rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    sys.path.insert(0, str(ROOT))
    bench = spec()
    work, cfg, mix = cell_of(bench, args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < work["chips"]:
        print(f"needs {work['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out, rec = result(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_START)
    bad = forbidden_loaded()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 4
    check = out["check"]
    print(json.dumps({"info": rec.get("info", {})}), flush=True)
    for k, c in check.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
