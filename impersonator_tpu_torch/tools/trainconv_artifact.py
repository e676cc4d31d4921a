"""Training-convergence artifact (the port's counterpart of
``tools/trainconv_artifact.py``: the same learnable synthetic set, the
reference's 5 + 25 epoch learning-rate schedule and the same per-epoch
JSON fields, through the port's ``tasks.trainer``).

It runs real train steps (two Adams, every configured loss, D updates)
on pose -> image pairs whose images are each θ's silhouette rendered
into a coloured image, so the reconstruction and perceptual losses can
actually fall, and records each epoch's mean losses and the SSIM of a
held-out batch's transfer:

    python -m impersonator_tpu_torch.tools.trainconv_artifact \\
        --out TRAINCONV.json [--image_size 64] [--batch_size 4] \\
        [--nepochs_no_decay 5] [--nepochs_decay 25] [--repeat_num 2] \\
        [--d_layers 2] [--smpl_model smpl.pkl --uv_mapping uv.obj] \\
        [--device cpu]

By default the body is the synthetic test body, G has 2 residual blocks
and D 2 layers, as in the JAX tool; ``--smpl_model`` / ``--uv_mapping``,
``--repeat_num 6`` and ``--d_layers 4`` give a real body and the full
nets.

On the card every step launches ``zbuffer_bucket_rows`` and
``zbuffer_bucket_flow`` once (``body_recovery_flow``), as does the
set's rendering (rows, once per call).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from impersonator_tpu_torch.tools import add_device_arg, resolve_device


@torch.no_grad()
def make_learnable_batchset(trainer, n_items: int, seed: int = 0):
    """Deterministic pose -> image pairs: the θ's silhouette (its cond
    encoding) colourised over a fixed background ramp. Host arrays
    {'images': (N, 2, S, S, 3), 'smpls': (N, 2, 85)}."""
    from impersonator_tpu_torch.ops import smpl as smpl_ops
    rng = np.random.default_rng(seed)
    s = trainer.cfg.image_size
    smpls = np.zeros((n_items, 2, 85), np.float32)
    smpls[..., 0] = 0.9
    # per item a pose pair: one base pose, two jitters
    base = rng.normal(0, 0.08, (n_items, 1, 72)).astype(np.float32)
    smpls[..., 3:75] = base + rng.normal(0, 0.03, (n_items, 2, 72))
    yy, xx = np.meshgrid(np.linspace(-1, 1, s), np.linspace(-1, 1, s),
                         indexing="ij")
    bg = torch.from_numpy(np.stack([yy, xx, yy * xx], -1)
                          .astype(np.float32) * 0.5).to(trainer.device)
    flat = torch.from_numpy(smpls.reshape(-1, 85)).to(trainer.device)
    info = smpl_ops.get_details(trainer.smpl_params, flat,
                                trainer.assets.parents)
    _, fim, _ = trainer.renderer.render_fim_wim(info["cam"], info["verts"])
    cond = trainer.renderer.encode_fim(fim)
    imgs = torch.where(cond[..., -1:] > 0.5, bg, torch.tanh(cond * 2.0))
    return {"images": imgs.float().cpu().numpy().reshape(n_items, 2, s, s,
                                                         3),
            "smpls": smpls}


KEYS = ("g_total", "g_rec", "g_tsf", "g_mask", "g_adv", "d_loss", "d_real",
        "d_fake")


def run(image_size=64, batch_size=4, n_items=64, nepochs_no_decay=5,
        nepochs_decay=25, repeat_num=2, d_layers=2, use_vgg=True, seed=0,
        out_path=None, device="cuda", smpl_model="", uv_mapping=""):
    from impersonator_tpu_torch.config import TrainConfig
    from impersonator_tpu_torch.data.loader import stage_batch
    from impersonator_tpu_torch.metrics import ssim
    from impersonator_tpu_torch.tasks import trainer as trainer_mod

    cfg = TrainConfig(
        image_size=image_size, batch_size=batch_size,
        repeat_num=repeat_num, d_layers=d_layers,
        use_vgg=use_vgg, use_style=False, use_face=False,
        nepochs_no_decay=nepochs_no_decay, nepochs_decay=nepochs_decay,
        train_dtype="bfloat16", seed=seed, smpl_model=smpl_model,
        uv_mapping=uv_mapping)
    tr = trainer_mod.build_trainer(cfg, device=device)
    state = tr.init_state()
    step = trainer_mod.make_train_step(tr, train_d=True)
    visuals = trainer_mod.make_visuals_fn(tr)

    data = make_learnable_batchset(tr, n_items, seed=seed)
    # a fixed held-out eval batch (pairs the train set never holds)
    eval_batch = stage_batch(make_learnable_batchset(tr, batch_size,
                                                     seed=seed + 991),
                             tr.device)

    n_epochs = nepochs_no_decay + nepochs_decay
    steps_per_epoch = n_items // batch_size
    rng = np.random.default_rng(seed + 1)
    per_epoch = []
    t0 = time.perf_counter()
    for epoch in range(n_epochs):
        lr_g = tr.epoch_lr(epoch)
        state = tr.set_lr(state, lr_g, tr.epoch_lr(epoch, base=cfg.lr_D))
        perm = rng.permutation(n_items)
        acc = {k: [] for k in KEYS}
        for k_step in range(steps_per_epoch):
            idx = perm[k_step * batch_size:(k_step + 1) * batch_size]
            batch = stage_batch({k: v[idx] for k, v in data.items()},
                                tr.device)
            state, m = step(state, batch)
            for k in KEYS:
                acc[k].append(float(m[k]))
        vis = visuals(state, eval_batch)
        real_tsf = eval_batch["images"][:, 1].permute(0, 2, 3, 1)
        eval_ssim = float(ssim(vis["4_fake_tsf"], real_tsf))
        rec = {"epoch": epoch, "lr_g": lr_g,
               **{k: round(float(np.mean(acc[k])), 5) for k in KEYS},
               "eval_ssim": round(eval_ssim, 5)}
        per_epoch.append(rec)
        print(json.dumps(rec))

    def mean_of(key, rows):
        return float(np.mean([r[key] for r in rows]))

    q = max(1, n_epochs // 4)
    head, tail = per_epoch[:q], per_epoch[-q:]
    trend = {
        "g_rec_first_quarter": round(mean_of("g_rec", head), 5),
        "g_rec_last_quarter": round(mean_of("g_rec", tail), 5),
        "g_tsf_first_quarter": round(mean_of("g_tsf", head), 5),
        "g_tsf_last_quarter": round(mean_of("g_tsf", tail), 5),
        "eval_ssim_first": per_epoch[0]["eval_ssim"],
        "eval_ssim_last": per_epoch[-1]["eval_ssim"],
        # D health: LSGAN d_real / d_fake separate toward 1 / -1
        "d_real_last": per_epoch[-1]["d_real"],
        "d_fake_last": per_epoch[-1]["d_fake"],
        "lr_decay_kicked_in": per_epoch[-1]["lr_g"] < per_epoch[0]["lr_g"],
        "n_steps": n_epochs * steps_per_epoch,
        "wall_s": round(time.perf_counter() - t0, 1),
    }
    artifact = {
        "what": "G/D loss trajectories over the reference 5+25-epoch LR "
                "schedule on a learnable pose->image synthetic set "
                "(impersonator_tpu_torch/tools/trainconv_artifact.py)",
        "config": {"image_size": image_size, "batch_size": batch_size,
                   "n_items": n_items, "repeat_num": repeat_num,
                   "d_layers": d_layers, "use_vgg": use_vgg,
                   "nepochs_no_decay": nepochs_no_decay,
                   "nepochs_decay": nepochs_decay,
                   "train_dtype": cfg.train_dtype,
                   "losses": "rec+vgg+mask+lsgan (reference weights)"},
        "per_epoch": per_epoch,
        "trend": trend,
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(artifact, f, indent=1)
        print(f"# wrote {out_path}")
    return artifact


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="TRAINCONV.json")
    ap.add_argument("--image_size", type=int, default=64)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--n_items", type=int, default=64)
    ap.add_argument("--nepochs_no_decay", type=int, default=5)
    ap.add_argument("--nepochs_decay", type=int, default=25)
    ap.add_argument("--repeat_num", type=int, default=2)
    ap.add_argument("--d_layers", type=int, default=2)
    ap.add_argument("--no_vgg", action="store_true")
    ap.add_argument("--smpl_model", default="")
    ap.add_argument("--uv_mapping", default="")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    return run(image_size=args.image_size, batch_size=args.batch_size,
               n_items=args.n_items,
               nepochs_no_decay=args.nepochs_no_decay,
               nepochs_decay=args.nepochs_decay,
               repeat_num=args.repeat_num, d_layers=args.d_layers,
               use_vgg=not args.no_vgg, out_path=args.out,
               device=resolve_device(args.device),
               smpl_model=args.smpl_model, uv_mapping=args.uv_mapping)


if __name__ == "__main__":
    main()
