#!/usr/bin/env python3
"""Times the whole of chip_smoke.py for this checkout and another one on
the same card, on one clock. Run from the repository root:

    python3 time_smoke.py --parent PATH [--rounds N]

PATH is a checkout of another commit (for example `git archive` of the
parent, unpacked into a gitignored directory such as _commit_check/).
Each round runs the parent's script, then this checkout's, then this
checkout's again and the parent's again (so that neither side always
runs first, when the machine's caches are cold), each in its own
process from its own root. Each run's output goes to
chiprun_out/time_smoke_{parent|change}_{k}.log. Prints every run's wall
seconds (the host clock around the process), the phase laps a run
printed, each side's median, the card's name and power limit, and a JSON
record as the last line. Exits 1 when a run fails.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import chip_smoke as smoke


def run(root: Path, log: Path) -> float:
    t0 = time.perf_counter()
    with open(log, "w") as f:
        rc = subprocess.call([sys.executable, "chip_smoke.py"], cwd=root,
                             stdout=f, stderr=subprocess.STDOUT)
    wall = time.perf_counter() - t0
    if rc != 0:
        print(f"{log}: exit {rc}", flush=True)
        sys.exit(1)
    return wall


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    sides = {"parent": Path(args.parent).resolve(),
             "change": Path(__file__).resolve().parent}
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    walls = {"parent": [], "change": []}
    for _ in range(args.rounds):
        for side in ("parent", "change", "change", "parent"):
            log = out / f"time_smoke_{side}_{len(walls[side])}.log"
            walls[side].append(run(sides[side], log))
            laps = [ln for ln in log.read_text().splitlines()
                    if "by phase" in ln]
            print(f"{side} run {len(walls[side]) - 1}: "
                  f"{walls[side][-1]:.3f} s of wall time"
                  + (f"; {laps[0]}" if laps else ""), flush=True)
    med = {k: statistics.median(v) for k, v in walls.items()}
    smi = smoke.gpu_line()
    print(f"median wall s: parent {med['parent']:.3f}, change "
          f"{med['change']:.3f} ({med['change'] - med['parent']:+.3f}) "
          f"[{smi}]")
    print(smi)
    print(json.dumps({"wall_s": walls, "median_wall_s": med}))


if __name__ == "__main__":
    main()
