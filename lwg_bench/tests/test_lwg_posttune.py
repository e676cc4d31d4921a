"""The post-tune cell on the CPU at a tiny size (64², conv_dim 8, one
residual block, 4 prior poses, 4 steps): a whole traced run reads its
spans, counters and FLOPs; a program whose tune runs with TF32 on ends
the run in set-up; the reference with the generator in bfloat16 in the
program's place fails the cell's limits. (The TF32 control needs a
card: on the CPU the flags change nothing.)"""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 7


def tiny_cell(compute_dtype="bfloat16"):
    cfg = json.loads((BENCH / "configs/lwgan-imitator-posttune-256.json")
                     .read_text())
    cfg.update(image_size=64, conv_dim=8, repeat_num=1, batch=4,
               compute_dtype=compute_dtype,
               body={"rings": 3, "segments": 6, "seed": 0})
    cfg["post_tune"].update(prior_poses=4, epochs=2, batch_size=2)
    mix = json.loads((BENCH / "traffic/imitate-posttune.json").read_text())
    mix.update(lengths=[3, 6], length_step=3, cycles=1, profile_jobs=1,
               check_within=2)
    return cfg, mix


def reader(name):
    spec = importlib.util.spec_from_file_location(
        name, BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_traced_run_reads_spans_counters_and_flops():
    from lwg_bench.drivers import posttune as D
    cfg, mix = tiny_cell()
    torch.set_num_threads(4)
    rec = D.run(cfg, mix, SEED, 1.0, True, "cpu")
    jobs = len(rec["jobs"])
    assert rec["info"]["tune_steps"] == 4 * jobs
    spans = rec["spans"]
    assert spans["posttune"]["n"] == 1
    assert spans["posttune.step"]["n"] == 4
    assert spans["posttune.pairs"]["n"] == spans["posttune.refresh"]["n"] == 1
    assert rec["posttune_ms"] is not None
    assert 0 < reader("mfu.posttune")(rec)
    assert len(rec["personalize_ms"]) == mix["personalize_jobs"]
    assert 0 < reader("personalize_ms")(rec)
    # each traced job: one flow launch a clip batch, one for its pairs
    assert rec["info"]["flow_launches_counted"] >= 2 * mix["profile_jobs"]
    assert rec["flow_least_s"] > 0
    assert all(rec["gaps"][k] <= v for k, v in mix["limits"].items()), \
        rec["gaps"]


def test_tune_in_tf32_ends_the_run_in_setup(monkeypatch):
    import contextlib

    from impersonator_tpu_torch.tasks import post_tune as TP
    from lwg_bench.drivers import posttune as D
    monkeypatch.setattr(TP, "full_fp32", contextlib.nullcontext)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    cfg, mix = tiny_cell()
    cell = D.Cell(cfg, mix, SEED, "cpu")
    with pytest.raises(SystemExit, match="TF32"):
        cell.warm_up()


def test_bf16_control_is_not_correct():
    from lwg_bench.drivers import posttune as D
    cfg, mix = tiny_cell()
    torch.set_num_threads(4)
    cell = D.Cell(cfg, mix, SEED, "cpu")
    cell.free_program()
    job = cell.jobs[0]
    ctl = D.control_record(D.reference(cell, control="bf16"), job,
                           cell.pt)
    gaps = D.gaps_of(D.reference(cell), job, ctl)
    assert any(gaps[k] > v for k, v in mix["limits"].items()), gaps
