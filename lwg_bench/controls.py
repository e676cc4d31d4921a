"""The readings that the limits of ``correct`` are set from, on the card
at a cell's own size: the program's gaps to the reference on each of a
dozen seeds or more (a short window at the cell's load, its sampled
jobs compared as a run compares them), and the control's gaps on three
or more: the reference itself in the precision below the
configuration's (float8 convolutions, HMR and DeepFill in TF32), in the
program's place, and where HMR runs, HMR alone in TF32; for a training
cell also the program with half of each batch left out (its readings
need no window), on the control's seeds and on ``--fault-seeds``.

    python3 lwg_bench/controls.py --workload imitate-smpl \\
        --seeds 11,12,...  --control-seeds 11,12,13 --seconds 14

One JSON line per seed on standard output, and the lot in
``chiprun_out/controls_<workload>.jsonl``. The benchmark's own runs
never run this."""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from lwg_bench import run as bench_run

    _, cfg, mix = bench_run.cell_of(bench_run.spec(), args.workload)
    driver = importlib.import_module(f"lwg_bench.drivers.{mix['driver']}")
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    fault_seeds = {int(s) for s in args.fault_seeds.split(",") if s}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        row = {"workload": args.workload, "seed": seed}
        row.update(driver.readings(
            cfg, mix, seed, args.seconds, seed in control_seeds,
            args.device, fault=(seed in control_seeds | fault_seeds)))
        print(json.dumps(row), flush=True)
        lines.append(json.dumps(row))
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    (out_dir / f"controls_{args.workload}.jsonl").write_text(
        "\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
