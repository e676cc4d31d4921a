"""Record post-tune adaptation quality as a JSON artifact (the port's
counterpart of ``tools/posttune_artifact.py``: the same structured
source, priors, held-out pose, epochs and JSON fields, through the
port's ``tasks.post_tune`` and ``metrics``).

The reference's test-time personalisation only prints losses. This tool
records the per-epoch cycle-loss trajectory (the optimised objective:
it must fall), the self-imitation SSIM / LPIPS before and after the tune
(the source's own pose, scored against the source image), and the
held-out cycle SSIM / LPIPS (a pose outside the tuning set, imitated,
warped back to the source frame through T_cycle and scored against the
source inside the body). The source is the source pose's silhouette
rendered into coloured bands over a background ramp. LPIPS uses the
repository's released v0.1 alex lin heads over ``cli.evaluate``'s seeded
backbone: a relative metric, valid for before / after deltas (its
backbone is not the JAX tool's, so its lps values differ from the JAX
tool's).

    python -m impersonator_tpu_torch.tools.posttune_artifact \\
        [--out POSTTUNE.json] [--size 128] [--priors 6] [--epochs 5] \\
        [--repeat_num 2] [--smpl_model smpl.pkl --uv_mapping uv.obj] \\
        [--device cpu]

By default the body is the synthetic test body and the generator has 2
residual blocks, as in the JAX tool; ``--smpl_model`` / ``--uv_mapping``
and ``--repeat_num 6`` give a real body and the full generator.

On the card: personalise (one ``zbuffer_bucket_rows``), the tune (rows
and flow per pair batch) and each imitation (flow) launch the bucket
kernels.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from impersonator_tpu_torch.tools import add_device_arg, resolve_device


@torch.no_grad()
def structured_src_img(imit, theta, size: int) -> np.ndarray:
    """The source pose's silhouette rendered into coloured bands over a
    background ramp: a deterministic, structured stand-in for a photo."""
    from impersonator_tpu_torch.ops import smpl as smpl_ops
    th = torch.as_tensor(np.asarray(theta, np.float32).reshape(1, 85),
                         device=imit.device)
    info = smpl_ops.get_details(imit.smpl_params, th, imit.parents)
    _, fim, _ = imit.renderer.render_fim_wim(info["cam"], info["verts"])
    cond = imit.renderer.encode_fim(fim)
    sil = cond[..., -1:]
    yy, xx = np.meshgrid(np.linspace(-1, 1, size), np.linspace(-1, 1, size),
                         indexing="ij")
    bg = torch.from_numpy(np.stack([yy, xx, yy * xx], -1)
                          .astype(np.float32) * 0.5).to(imit.device)
    img = torch.where(sil > 0.5, bg[None], torch.tanh(cond * 2.0))
    return img[0].float().cpu().numpy()


def load_lpips_fn(device):
    """The repository's v0.1 alex lin heads over ``cli.evaluate``'s seeded
    backbone; None when the file is absent."""
    import os
    from impersonator_tpu_torch.cli import evaluate as ev
    if not os.path.exists(ev.REAL_LPIPS_LIN):
        print(f"# lpips weights absent at {ev.REAL_LPIPS_LIN}; lps fields "
              "skipped")
        return None
    return ev.lpips_apply_fn(ev.load_lpips(ev.REAL_LPIPS_LIN, device))


def _mean(x) -> float:
    return float(torch.as_tensor(x).float().mean())


def self_metrics(imit, lpips_fn):
    """Self-imitation (tsf θ = src θ, cam copied) scored against the
    source."""
    from impersonator_tpu_torch.metrics import ssim
    pred = imit.inference_by_smpls(imit.src_info["theta"],
                                   cam_strategy="copy", batch=1)
    img = imit.src_info["img"].float()
    out = {"self_ssim": float(ssim(pred.float(), img))}
    if lpips_fn is not None:
        out["self_lps"] = _mean(lpips_fn(pred, img))
    return out


@torch.no_grad()
def heldout_metrics(imit, heldout_theta, lpips_fn):
    """Imitate a held-out pose, warp the prediction back to the source
    frame through T_cycle, and compare with the source inside the body
    mask."""
    from impersonator_tpu_torch.metrics import ssim
    from impersonator_tpu_torch.ops import smpl as smpl_ops
    from impersonator_tpu_torch.ops.sampler import grid_sample
    from impersonator_tpu_torch.tasks import imitator as I
    src, renderer = imit.src_info, imit.renderer
    held = torch.as_tensor(heldout_theta, device=imit.device)
    tsf = I.swap_smpl(src["cam"], src["shape"], held, held[0:1, 0:3],
                      "smooth")
    info = smpl_ops.get_details(imit.smpl_params, tsf, imit.parents)
    f2v, _, _ = renderer.render_fim_wim(info["cam"], info["verts"])
    t_cycle = renderer.cal_bc_transform(renderer.f2pts_from_f2verts(f2v),
                                        src["fim"], src["wim"])
    # the float32 master on the cached source, as the JAX tool decodes
    pred = I.imitate_core(imit.nets, renderer, imit.smpl_params,
                          imit.parents, src, tsf).float()
    back = grid_sample(pred, t_cycle)
    mask = (src["cond"][..., -1:] < 0.5).float()
    img = src["img"].float()
    out = {"heldout_cycle_ssim": float(ssim(back * mask, img * mask))}
    if lpips_fn is not None:
        out["heldout_cycle_lps"] = _mean(lpips_fn(back * mask, img * mask))
    return out


def build(size: int, seed: int, device, compute_dtype: str, nets=None,
          repeat_num: int = 2, smpl_model: str = "", uv_mapping: str = ""):
    """(Imitator at ``size``², ``repeat_num`` residual blocks, the body of
    ``smpl_model`` / ``uv_mapping`` (the synthetic one when empty), seeded
    weights or ``nets``, personalised on the structured source; the
    source θ)."""
    from impersonator_tpu_torch.config import TestConfig
    from impersonator_tpu_torch.tasks.imitator import Imitator
    cfg = TestConfig(image_size=size, repeat_num=repeat_num,
                     compute_dtype=compute_dtype, smpl_model=smpl_model,
                     uv_mapping=uv_mapping)
    imit = Imitator(cfg, assets=cfg.assets(), nets=nets, device=device)
    rng = np.random.default_rng(seed)
    theta = np.zeros(85, np.float32)
    theta[0] = 0.9
    theta[3:75] = rng.normal(0, 0.05, 72)
    imit.personalize(structured_src_img(imit, theta, size), src_smpl=theta)
    return imit, theta


def run(size=128, priors=6, epochs=5, seed=0, use_lpips=True,
        device="cuda", out_path=None, repeat_num=2, smpl_model="",
        uv_mapping=""):
    from impersonator_tpu_torch.tasks import post_tune as PT
    device = torch.device(device)
    imit, _ = build(size, seed, device, "bfloat16", repeat_num=repeat_num,
                    smpl_model=smpl_model, uv_mapping=uv_mapping)
    lpips_fn = load_lpips_fn(device) if use_lpips else None
    prior = PT.default_prior_poses(imit.src_info["theta"], n=priors,
                                   scale=0.12, seed=seed)
    # held-out pose: the same distribution, another draw, not in the set
    heldout = PT.default_prior_poses(imit.src_info["theta"], n=1,
                                     scale=0.12, seed=seed + 1000)
    before = {**self_metrics(imit, lpips_fn),
              **heldout_metrics(imit, heldout, lpips_fn)}
    metrics = PT.adaptive_personalize(
        imit, prior, epochs=epochs, use_face=False,
        batch_size=min(4, priors), seed=seed, verbose=True)
    after = {**self_metrics(imit, lpips_fn),
             **heldout_metrics(imit, heldout, lpips_fn)}

    cyc = [float(c) for c in metrics["cyc_history"]]
    deltas = {f"{k}_delta": round(after[k] - before[k], 5) for k in before}
    result = {
        "what": "test-time personalization quality, before vs after the "
                "reference post-tune budget (5 epochs Adam 2e-4, "
                "imitator.py:415-433) on a structured synthetic source; "
                "weights are random-init (no pretrained ckpt ships "
                "here), so ABSOLUTE numbers are low — the DELTAS and "
                "the falling cycle trajectory are the signal",
        "metric_semantics": {
            "self_ssim/self_lps": "imitate the source's own pose, score "
                                  "vs the source image (ssim higher "
                                  "better, lps lower better)",
            "heldout_cycle_ssim/lps": "imitate a pose OUTSIDE the tuning "
                                      "set, warp back via T_cycle, score "
                                      "vs source inside the body mask",
            "lps": "released v0.1 alex lin heads over a fixed-seed "
                   "backbone - deterministic RELATIVE perceptual metric",
        },
        "config": {"size": size, "priors": priors, "epochs": epochs,
                   "budget_steps": int(metrics["n_steps"]),
                   "lr": 2e-4, "adam_betas": [0.5, 0.999],
                   "losses": "cycle L1 + mask BCE (face off: no real "
                             "face net weights at this size)",
                   "seed": seed},
        "cycle_loss_per_epoch": [round(c, 6) for c in cyc],
        "cycle_improvement": round(cyc[0] / max(cyc[-1], 1e-12), 3),
        "before": {k: round(v, 5) for k, v in before.items()},
        "after": {k: round(v, 5) for k, v in after.items()},
        **deltas,
    }
    # adaptation must adapt: the optimised objective falls every epoch,
    # and quality moves up on at least one axis (ssim up or lps down)
    assert all(b < a for a, b in zip(cyc, cyc[1:])), \
        f"cycle loss not monotone: {cyc}"
    heldout_better = result["heldout_cycle_ssim_delta"] > 0 or (
        "heldout_cycle_lps_delta" in result
        and result["heldout_cycle_lps_delta"] < 0)
    self_better = result["self_ssim_delta"] > 0 or (
        "self_lps_delta" in result and result["self_lps_delta"] < 0)
    assert heldout_better or self_better, result
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="POSTTUNE.json")
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--priors", type=int, default=6)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no_lpips", action="store_true")
    ap.add_argument("--repeat_num", type=int, default=2)
    ap.add_argument("--smpl_model", default="")
    ap.add_argument("--uv_mapping", default="")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    return run(size=args.size, priors=args.priors, epochs=args.epochs,
               seed=args.seed, use_lpips=not args.no_lpips,
               device=resolve_device(args.device), out_path=args.out,
               repeat_num=args.repeat_num, smpl_model=args.smpl_model,
               uv_mapping=args.uv_mapping)


if __name__ == "__main__":
    main()
