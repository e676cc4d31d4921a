"""The port's post-tune (``tasks/post_tune.adaptive_personalize`` on the
``Imitator``, as ``lwg_bench/drivers/posttune.py`` drives it) against
the benchmark's plain reference (``lwg_bench/reference/post_tune.py``)
on the CPU, in float32, at 64², conv_dim 8, one residual block, 4 prior
poses and 2 epochs of minibatches of 2 (4 steps) with the face loss, on
seeded weights: the pair batch, each step's loss, the gradients of the
steps after the first, Adam, and the frames after tuning agree to
rounding; a mask weight of 1 for 5, a tune without its cycle pass, Adam
at twice the learning rate, a tune that trains on the same pairs every
step, one whose mask targets are out of line with their pairs, and one
an epoch short each fail the cell's limits."""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from impersonator_tpu_torch.models import losses as L
from impersonator_tpu_torch.ops.sampler import grid_sample
from impersonator_tpu_torch.tasks import post_tune as TP
from lwg_bench.drivers import posttune as D

from torch_threads import one_torch_thread  # noqa: F401

BENCH = Path(__file__).resolve().parents[1] / "lwg_bench"
SEED = 2 ** 31 + 7
TIGHT = {"pairs_flow": 1e-5, "pairs_init": 1e-5, "pairs_mask": 0.0,
         "pairs_fim": 0.0, "pairs_inputs": 1e-5, "loss": 1e-5, "grad_leaf": 1e-4, "grad_diff": 1e-4, "adam": 1e-4,
         "rms": 1e-4, "worst_frame_rms": 1e-4}


def tiny():
    cfg = json.loads((BENCH / "configs/lwgan-imitator-posttune-256.json")
                     .read_text())
    cfg.update(image_size=64, conv_dim=8, repeat_num=1, batch=4,
               compute_dtype="float32",
               body={"rings": 3, "segments": 6, "seed": 0})
    cfg["post_tune"].update(prior_poses=4, epochs=2, batch_size=2)
    mix = json.loads((BENCH / "traffic/imitate-posttune.json").read_text())
    mix.update(lengths=[3, 6], length_step=3, cycles=1, check_within=2)
    return cfg, mix


@pytest.fixture(scope="module")
def cell():
    cfg, mix = tiny()
    return D.Cell(cfg, mix, SEED, "cpu")


@pytest.fixture(scope="module")
def ref(cell):
    return D.reference(cell)


def gaps(cell, ref):
    job = cell.jobs[0]
    return D.gaps_of(ref, job, cell.check_job(job))


@pytest.fixture(scope="module")
def clean(cell, ref):
    return gaps(cell, ref)


def test_capture_reads_every_step(cell):
    rec = cell.check_job(cell.jobs[1])
    assert len(rec["steps"]) == 4
    assert rec["pairs"]["T"].shape == (4, 64, 64, 2)
    assert rec["bg"].shape == (1, 64, 64, 3)
    for step in rec["steps"]:
        assert step["loss"].ndim == 0
        assert set(step["params"]) == set(step["grads"])
    # the background stream gets no gradient from the tune
    assert all(v is None for k, v in rec["steps"][0]["grads"].items()
               if k.startswith("bg_model."))


@pytest.mark.parametrize("key", ["pairs_flow", "pairs_init", "pairs_mask",
                                 "pairs_fim", "pairs_inputs"])
def test_pair_batch_matches_reference(clean, key):
    assert clean[key] <= TIGHT[key], clean


def test_each_step_loss_matches_reference(clean):
    assert len(clean["losses"]) == 4
    assert clean["step_count"] == 0, clean
    assert clean["loss"] <= TIGHT["loss"], clean


@pytest.mark.parametrize("key", ["grad_leaf", "grad_diff", "adam"])
def test_gradients_and_adam_match_reference(clean, key):
    assert clean[key] <= TIGHT[key], clean


def test_frames_after_tuning_match_reference(clean):
    assert clean["rms"] <= TIGHT["rms"], clean
    assert clean["worst_frame_rms"] <= TIGHT["worst_frame_rms"], clean


def test_tune_moves_the_generator(cell):
    rec = cell.check_job(cell.jobs[0])
    first = rec["steps"][0]["params"]
    moved = [float((rec["tuned"][k] - v).abs().max()) for k, v in
             first.items() if not k.startswith("bg_model.")]
    assert max(moved) > 1e-5


def mask_weight_one(tune_loss):
    def broken(*a, **k):
        total, parts = tune_loss(*a, **k)
        total = total - 4 * parts["msk"]
        return total, dict(parts, total=total)
    return broken


def no_cycle_pass(gen, renderer, batch, bg, face=None, front_warp=False,
                  use_face=True):
    """``tune_loss`` with the cycle pass left out: no backward
    imitation, so neither its L1 nor its face term."""
    src_in, tsf_in = batch["src_inputs"], batch["tsf_inputs"]
    outs = gen.infer_front(src_in.permute(0, 3, 1, 2),
                           tsf_in.permute(0, 3, 1, 2), batch["T"])
    s_color, s_mask, t_color, t_mask = (o.permute(0, 2, 3, 1) for o in outs)
    fake_src = s_mask * bg + (1 - s_mask) * s_color
    fake_tsf = t_mask * bg + (1 - t_mask) * t_color
    if front_warp:
        front = renderer.encode_front_fim(batch["tsf_fim"], front_fn=True)
        fake_tsf = ((1 - front) * fake_tsf
                    + tsf_in[..., 0:3] * front * (1 - t_mask))
    src = batch["images_src"]
    cyc_warp = grid_sample(fake_tsf, batch["T_cycle"])
    body = 1 - src_in[..., -1:]
    back = 1 - renderer.encode_front_fim(batch["tsf_fim"], front_fn=False)
    cyc = L.l1(src, fake_src)
    struct = (L.l1(batch["init_preds"], fake_tsf)
              + 2 * L.l1(src * body * back, cyc_warp * back))
    fid = torch.zeros(())
    if use_face and face is not None:
        fid = L.face_loss(face, batch["init_preds"], fake_tsf,
                          kps1=batch["j2d_tsf"], kps2=batch["j2d_tsf"])
    msk = L.bce(torch.cat([s_mask, t_mask], 0), batch["pseudo_masks"])
    total = 10 * cyc + 10 * struct + fid + 5 * msk
    return total, {"cyc": cyc, "str": struct, "fid": fid, "msk": msk,
                   "total": total}


def adam_lr_doubled(tune_optimizer):
    def broken(gen, lr):
        return tune_optimizer(gen, 2 * lr)
    return broken


def tune_epochs(step, batch, bg, epochs, batch_size, seed, verbose,
                fault):
    """``post_tune._tune_epochs`` with a fault in its minibatches:
    ``"same_pairs"`` trains on the first minibatch of each epoch's
    permutation at every step, ``"masks"`` takes the source's crop masks
    in place of the poses', ``"short"`` leaves the last epoch out. (The
    tiny tune's pairs split into whole minibatches, so no padding.)"""
    n = batch["T"].shape[0]
    bg = bg.expand(n, *bg.shape[1:])
    rng = np.random.default_rng(seed)
    n_steps = 0
    for _ in range(epochs - (fault == "short")):
        perm = rng.permutation(n)
        for k in range(n // batch_size):
            k = 0 if fault == "same_pairs" else k
            idx = torch.as_tensor(perm[k * batch_size:(k + 1) * batch_size])
            rows = torch.cat([idx, idx + (0 if fault == "masks" else n)])
            mb = {key: v[rows] if key == "pseudo_masks" else v[idx]
                  for key, v in batch.items()}
            metrics = step(mb, bg[idx])
            n_steps += 1
    return metrics, [], n_steps


def epochs_fault(fault):
    return lambda _: functools.partial(tune_epochs, fault=fault)


# each planted fault, and the gap that must exceed the cell's limit
FAULTS = {"mask_weight_one": ("tune_loss", mask_weight_one, "loss"),
          "no_cycle_pass": ("tune_loss", lambda _: no_cycle_pass, "loss"),
          "adam_lr_doubled": ("tune_optimizer", adam_lr_doubled, "adam"),
          "same_pairs_every_step": ("_tune_epochs",
                                    epochs_fault("same_pairs"), "loss"),
          "masks_out_of_line": ("_tune_epochs", epochs_fault("masks"),
                                "loss"),
          "an_epoch_short": ("_tune_epochs", epochs_fault("short"),
                             "step_count")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails_the_cells_limits(cell, ref, monkeypatch,
                                              fault):
    name, plant, key = FAULTS[fault]
    monkeypatch.setattr(TP, name, plant(getattr(TP, name)))
    got = gaps(cell, ref)
    assert got[key] > 100 * cell.mix["limits"][key], (got, key)
