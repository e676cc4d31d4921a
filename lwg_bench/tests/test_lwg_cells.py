"""Whole runs of tiny cells on the CPU, in fresh processes: cells,
configurations, mixes and metrics added as files are found; the
reference agrees with the program; the check fails the program with a
fault planted under the timed path, and fails the control; nothing of
JAX or the JAX package is loaded, compared by whole top-level names."""

import ast
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from lwg_bench.tests import tiny

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "impersonator_tpu"}

FRAMES_TOTAL = '''
def read(rec):
    return float(sum(r[1] for r in rec["jobs"]))
'''


def digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_added_files_are_found(tmp_path):
    root = tiny.checkout(tmp_path / "co",
                         metric_files={"frames_total": FRAMES_TOTAL})
    before = digest(BENCH)
    got = tiny.run_cell(root, "tiny-imitate-smpl", traced=True)
    out = got["out"]
    assert out["metrics"]["frames_total"]["value"] > 0
    assert out["metrics"]["frames_total"]["unit"] == "frames"
    assert "personalize_ms" in out["metrics"]
    assert got["forbidden"] == []
    # the benchmark's own files are unchanged: the cell, its configuration,
    # its mix and its metric came as new files and entries only
    after = {k: v for k, v in digest(root / "lwg_bench").items()
             if k in before}
    assert after == {k: v for k, v in before.items()
                     if not k.startswith("tests/")}


def test_reference_matches_program_in_float32(tmp_path):
    """The program in float32 and the reference agree to rounding: the
    z-buffers give the same faces, so the gap is the convolutions'
    order of operations (HMR in the video mix as well)."""
    root = tiny.checkout(tmp_path / "co",
                         config_over={"compute_dtype": "float32"})
    for cell in ("tiny-imitate-smpl", "tiny-imitate-video"):
        gaps = tiny.run_cell(root, cell)["out"]["check"]
        assert gaps["rms"]["value"] < 1e-4, (cell, gaps)
        assert gaps["worst_frame_rms"]["value"] < 1e-4, (cell, gaps)
    assert gaps["theta_max"]["value"] < 1e-4, gaps


def test_bf16_program_is_correct(tmp_path):
    root = tiny.checkout(tmp_path / "co")
    out = tiny.run_cell(root, "tiny-imitate-smpl")["out"]
    assert out["correct"], out["check"]
    assert list(out)[-1] == "check"


# faults planted where the program produces its frames
# (tasks.imitator.imitate_from_flow, one batch of frames a call)
FAULTS = {
    "frame_altered": """
        import impersonator_tpu_torch.tasks.imitator as m
        orig = m.imitate_from_flow
        def broken(*a, **k):
            out = orig(*a, **k).clone()
            out[0] = out[0].flip(1)
            return out
        m.imitate_from_flow = broken
    """,
    "half_batch_left_out": """
        import impersonator_tpu_torch.tasks.imitator as m
        orig = m.imitate_from_flow
        def broken(nets, renderer, src_state, fim, t, cond, *a, **k):
            n = fim.shape[0]
            h = max(1, n // 2)
            out = orig(nets, renderer, src_state, fim[:h], t[:h], cond[:h],
                       *a, **k)
            return out.repeat(2, 1, 1, 1)[:n]
        m.imitate_from_flow = broken
    """,
}


# faults planted where the program's HMR produces its θs
# (models.hmr.HumanModelRecovery.forward, one batch of images a call)
HMR_FAULTS = {
    "theta_altered": """
        import impersonator_tpu_torch.models.hmr as m
        orig = m.HumanModelRecovery.forward
        def broken(self, *a, **k):
            out = orig(self, *a, **k).clone()
            out[0, 3:75] += 0.02
            return out
        m.HumanModelRecovery.forward = broken
    """,
    "half_batch_left_out": """
        import impersonator_tpu_torch.models.hmr as m
        orig = m.HumanModelRecovery.forward
        def broken(self, x, *a, **k):
            h = max(1, x.shape[0] // 2)
            out = orig(self, x[:h], *a, **k)
            return out.repeat(2, 1)[:x.shape[0]]
        m.HumanModelRecovery.forward = broken
    """,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(tmp_path, fault):
    root = tiny.checkout(tmp_path / "co")
    out = tiny.run_cell(root, "tiny-imitate-smpl", patch=FAULTS[fault])["out"]
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("fault", sorted(HMR_FAULTS))
def test_hmr_fault_is_not_correct(tmp_path, fault):
    """A θ altered where HMR gives it (0.02 on the pose of each call's
    first θ, the source's among them) and half of each HMR batch left
    out fail the video mix's ``theta_max``."""
    root = tiny.checkout(tmp_path / "co")
    out = tiny.run_cell(root, "tiny-imitate-video",
                        patch=HMR_FAULTS[fault])["out"]
    assert not out["correct"], out["check"]
    theta = out["check"]["theta_max"]
    assert theta["value"] > theta["limit"], out["check"]


@pytest.mark.parametrize("mix", ["imitate-smpl", "imitate-video"])
def test_control_is_not_correct(tmp_path, mix):
    """The reference in the precision below the configuration's
    (generator on float8, HMR in TF32) put in the program's place fails
    the cell's limits: at the configuration's widths, on 64² frames."""
    import torch

    from lwg_bench.drivers import imitate as D
    cfg = json.loads((BENCH / "configs/lwgan-imitator-256.json")
                     .read_text())
    cfg.update(image_size=64, batch=4)
    mix_spec = json.loads((BENCH / f"traffic/{mix}.json").read_text())
    limits = dict(mix_spec["limits"])
    mix_spec.update(tiny.TINY_MIX)
    torch.set_num_threads(4)
    cell = D.Cell(cfg, mix_spec, 2 ** 31 + 11, "cpu")
    cell.free_program()
    jobs = {i: cell.jobs[i] for i in range(2)}
    by_theta = mix_spec["targets"] == "theta"
    ref = D.reference_frames(D.reference(cell), jobs, by_theta)
    ctl = D.reference_frames(D.reference(cell, control=True), jobs,
                             by_theta)
    gaps = D.gaps_of(ctl, ref)
    assert any(gaps[k] > v for k, v in limits.items()), (gaps, limits)


def imports_of(path: Path) -> set:
    """Top-level names of every module a source file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_and_a_reference_apart():
    for path in BENCH.rglob("*.py"):
        assert not imports_of(path) & FORBIDDEN, path
    for path in (BENCH / "reference").glob("*.py"):
        assert "impersonator_tpu_torch" not in imports_of(path), path


def test_forbidden_names_compare_whole(monkeypatch):
    from lwg_bench import run
    monkeypatch.setitem(sys.modules, "impersonator_tpu_torch_x", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert run.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "impersonator_tpu.assets", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_loaded() == ["impersonator_tpu", "jax"]


def test_no_result_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "lwg_bench/run.py", "--workload", "imitate-smpl",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=BENCH.parent, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
def test_cells_on_the_card(card):
    """Each cell of BENCHMARK.json for 3 seconds, untraced and traced."""
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        for traced in ("0", "1"):
            proc = subprocess.run(
                [sys.executable, "lwg_bench/run.py", "--workload",
                 w["name"], "--seed", str(2 ** 31 + 21), "--seconds", "3",
                 "--trace", traced], cwd=BENCH.parent, capture_output=True,
                text=True, timeout=600)
            assert proc.returncode == 0, proc.stderr[-4000:]
            out = json.loads(proc.stdout.strip().splitlines()[-1])
            assert out["correct"], out["check"]
