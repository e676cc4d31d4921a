"""The training cell's check on the CPU: the reference's step against
the program's in float32, the program with a fault planted in its step,
and the control, each against the cell's limits."""

import json
from pathlib import Path

import pytest

from lwg_bench.tests import tiny

BENCH = Path(__file__).resolve().parents[1]
CELL = "tiny-train-b16"


def test_train_reference_matches_program_in_float32(tmp_path):
    """In float32 the first step's losses and gradients agree to
    rounding (the later steps are not compared: see drivers/train.py)."""
    root = tiny.checkout(tmp_path / "co",
                         train_over={"train_dtype": "float32"})
    check = tiny.run_cell(root, CELL)["out"]["check"]
    assert check["loss1"]["value"] < 1e-5, check
    assert check["grad_leaf"]["value"] < 1e-3, check


# faults planted in the program's train step (tasks/trainer.py)
FAULTS = {
    "half_batch_left_out": """
        import impersonator_tpu_torch.tasks.trainer as T
        orig = T.make_train_step
        def broken(trainer, train_d=True, eval_only=False):
            step = orig(trainer, train_d, eval_only)
            def half(state, batch):
                n = batch["images"].shape[0] // 2
                return step(state, {k: v[:n] for k, v in batch.items()})
            return half
        T.make_train_step = broken
    """,
    "state_unchanged": """
        import impersonator_tpu_torch.tasks.trainer as T
        T._apply = lambda opt, params, grads: None
    """,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_train_fault_is_not_correct(tmp_path, fault):
    root = tiny.checkout(tmp_path / "co")
    out = tiny.run_cell(root, CELL, patch=FAULTS[fault])["out"]
    assert not out["correct"], out["check"]


def test_train_control_is_not_correct():
    """The reference on float8 convolutions in the program's place fails
    the cell's limits: the configuration's widths on 64² frames, batch
    2."""
    import torch

    from lwg_bench.drivers import train as D
    cfg = json.loads((BENCH / "configs/lwgan-train-256.json").read_text())
    cfg.update(image_size=64, batch_size=2)
    mix = json.loads((BENCH / "traffic/train-b16.json").read_text())
    limits = dict(mix["limits"])
    mix.update(tiny.TINY_TRAIN_MIX)
    torch.set_num_threads(4)
    cell = D.Cell(cfg, mix, 2 ** 31 + 13, "cpu")
    cell.free_program()
    ref = D.reference_steps(cell, mix["check_steps"])
    ctl = D.reference_steps(cell, mix["check_steps"], fp8=True)
    gaps = D.gaps_of(ctl, ref)
    assert any(gaps[k] > v for k, v in limits.items()), (gaps, limits)
