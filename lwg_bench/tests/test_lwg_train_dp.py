"""The data-parallel training cell's rank logic and reference blocks on
the CPU: four ranks on gloo over CPU tensors run a tiny cell whole (the
first steps against the reference's blocks, no drift between ranks, the
window's step count agreed, the all-reduce span read, the window's
useful FLOPs counted over every rank); the reference's
mean over blocks is the whole batch's step; a rank that fails ends the
run at once, nonzero."""

import json
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import torch

from lwg_bench import trace
from lwg_bench.tests import tiny

BENCH = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 7


def tiny_cell():
    cfg = json.loads((BENCH / "configs/lwgan-train-256.json").read_text())
    cfg.update(tiny.TINY_TRAIN)
    mix = json.loads((BENCH / "traffic/train-dp4-b64.json").read_text())
    mix.update(tiny.TINY_TRAIN_MIX, probe_steps=2, span_steps=1)
    return cfg, mix


def test_four_ranks_on_gloo():
    from lwg_bench.drivers import train_dp as D
    cfg, mix = tiny_cell()
    torch.set_num_threads(2)
    rec = D.run(cfg, mix, SEED, 2.0, True, "cpu")
    gaps = rec["gaps"]
    assert all(gaps[k] <= v for k, v in mix["limits"].items()), gaps
    assert gaps["rank_drift"] == 0.0
    assert rec["batch"] == 4 * cfg["batch_size"] and rec["steps"] >= 1
    assert rec["info"]["reduced_bytes_per_step"] > 0
    assert rec["spans"]["train.allreduce"]["n"] == mix["span_steps"]
    # mfu.train's count: every rank's samples of the window, over the
    # peaks of every rank's card
    per = rec["info"]["flops_per_sample"]
    assert rec["useful_flops"]["bfloat16"] == \
        per["bfloat16"] * rec["steps"] * rec["batch"] > 0
    assert rec["peak"] == {k: 4 * v for k, v in trace.PEAK.items()}


def test_rings_differ_by_rank():
    from lwg_bench.drivers import train_dp as D
    seeds = {D.rank_seed(SEED, r) for r in range(4)}
    assert len(seeds) == 4


def test_blocks_mean_is_the_whole_batch():
    """Every loss term is a mean over samples, so the mean of two blocks'
    gradients is the gradient of the two blocks as one batch."""
    from lwg_bench.drivers import train as T
    from lwg_bench.drivers import train_dp as D
    from lwg_bench.reference import geometry as G
    from lwg_bench.reference import trainer as RT
    cfg, mix = tiny_cell()
    torch.set_num_threads(4)
    cell = T.Cell(cfg, mix, SEED, "cpu")
    cell.free_program()
    a, b = cell.ring[0], cell.ring[1]
    whole = {k: torch.cat([a[k], b[k]]) for k in a}
    with G.full_fp32():
        blocks = D.block_step(RT.Step(cfg, cell.body, cell.uv_table,
                                      cell.states, "cpu"), [a, b])
        one = RT.Step(cfg, cell.body, cell.uv_table, cell.states,
                      "cpu").step(whole)
    assert abs(blocks["g_total"] - one["g_total"]) < 1e-4 * one["g_total"]
    assert abs(blocks["d_loss"] - one["d_loss"]) < 1e-4 * one["d_loss"]
    for net in ("G", "D"):
        num = sum(float((x - y).double().square().sum()) for x, y in
                  zip(blocks["grads"][net], one["grads"][net]))
        den = sum(float(y.double().square().sum())
                  for y in one["grads"][net])
        assert num ** 0.5 < 1e-4 * den ** 0.5, net


def test_a_failed_rank_ends_the_run():
    code = textwrap.dedent(f"""
        import subprocess, sys, time
        sys.path.insert(0, {str(BENCH.parent)!r})
        from lwg_bench.drivers.train_dp import Guard
        child = subprocess.Popen([sys.executable, "-c",
                                  "import time; time.sleep(1); exit(3)"])
        Guard([child], time.perf_counter() + 600)
        time.sleep(120)
    """)
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 1
    assert "rank 1 exited with 3" in proc.stderr
    assert time.perf_counter() - t < 30
