"""A checkout of the benchmark with tiny cells added the way a later
change adds them, by new files and new entries only: a configuration at
64², conv_dim 8, one residual block, batch 4, and a tiny mix for each
imitation mix, jobs of 3-6 frames; and a runner of one cell on the CPU
in a fresh process (the look for a card skipped), with an optional
patch of the program run before it."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
TINY = dict(image_size=64, conv_dim=8, repeat_num=1, batch=4)
TINY_MIX = dict(lengths=[3, 6], length_step=1, cycles=1, pool=16,
                personalize_jobs=2, profile_jobs=2, idle_jobs=1,
                check_jobs=1, check_within=2)
TINY_TRAIN = dict(image_size=64, conv_dim=8, repeat_num=1, ndf=8,
                  batch_size=2)
TINY_TRAIN_MIX = dict(ring=4, warm_steps=1, profile_steps=1)


def checkout(root: Path, config_over=None, metric_files=None,
             train_over=None) -> Path:
    """Copy ``lwg_bench`` and ``BENCHMARK.json`` under ``root``, then add
    ``configs/tiny.json`` and ``configs/tiny-train.json`` (with
    ``config_over`` / ``train_over``), ``traffic/tiny-<mix>.json`` and
    cells ``tiny-<mix>`` for each mix of the benchmark; ``metric_files``
    {name: source} adds per-layer metrics listed for every tiny
    imitation cell."""
    shutil.copytree(BENCH, root / "lwg_bench", ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "lwgan-imitator-256.json")
                     .read_text())
    cfg.update(TINY, **(config_over or {}))
    (root / "lwg_bench/configs/tiny.json").write_text(json.dumps(cfg))
    tcfg = json.loads((BENCH / "configs" / "lwgan-train-256.json")
                      .read_text())
    tcfg.update(TINY_TRAIN, **(train_over or {}))
    (root / "lwg_bench/configs/tiny-train.json").write_text(json.dumps(tcfg))
    for name in ("tiny", "tiny-train"):
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"lwg_bench/configs/{name}.json",
                                 "reduced": [], "why": "test"})
    cells, tiny_of = [], {}
    for w in list(bench["workloads"]):
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        train = mix["driver"] == "train"
        mix.update(TINY_TRAIN_MIX if train else TINY_MIX)
        name = f"tiny-{w['traffic']}"
        (root / f"lwg_bench/traffic/{name}.json").write_text(json.dumps(mix))
        bench["workloads"].append({"name": name, "config": "tiny-train"
                                   if train else "tiny", "traffic": name,
                                   "chips": 1, "why": "test"})
        tiny_of[w["name"]] = name
        if not train:
            cells.append(name)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [tiny_of[c] for c in m["workloads"]
                               if c in tiny_of]
    for name, src in (metric_files or {}).items():
        (root / f"lwg_bench/metrics/{name}.py").write_text(src)
        bench["per_layer"].append({
            "name": name, "unit": "frames", "better": "higher",
            "source": "program_counter", "layer": "test",
            "moves": "frames_per_s", "workloads": cells})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_cell(root: Path, cell: str, traced: bool = False, patch: str = "",
             seed: int = 2 ** 31 + 7, seconds: float = 1.0) -> dict:
    """Run ``cell`` of the checkout at ``root`` once on the CPU in a new
    process -> {"out": the result object, "forbidden": what JAX-side
    modules were loaded}."""
    code = textwrap.dedent(f"""
        import json, sys
        sys.path[:0] = [{str(root)!r}, {str(REPO)!r}]
        import torch
        torch.set_num_threads(4)
        {textwrap.indent(textwrap.dedent(patch), '        ').strip()}
        from lwg_bench import run
        out, rec = run.result(run.spec(), {cell!r}, {seed}, {seconds},
                              {traced}, "cpu")
        print(json.dumps({{"out": out, "forbidden": run.forbidden_loaded()}}))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])
