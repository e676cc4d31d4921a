"""Test-time adaptive personalisation, "post-tune" (torch port of
``impersonator_tpu/tasks/post_tune.py``).

The task renders prior poses of the personalised source with the current
generator, builds the (source, prior pose) pair batch on the device
(:func:`build_meta_pairs`), then tunes the generator's float32 master
weights with Adam (β 0.5 / 0.999) on

    10·cycle L1 + 10·structure + face + 5·mask BCE

(:func:`tune_loss`, one :func:`make_tune_step` per minibatch). Afterwards
the task's compute-dtype copy is rebuilt from the tuned master and the
source is personalised again.

All of it runs in full float32, TF32 off whatever the process's flags
(``utils.precision.full_fp32``): the published PyTorch code predates
TF32, and the JAX tune step applies the float32 params. In the pair
batch and the tune steps cuDNN is off but for the convolutions, each
pass of which runs on cuDNN or on PyTorch's own kernels, whichever was
measured faster for its shape (``ops.conv_route.float32_convs``): cuDNN's
float32 engine for one of the generator's shapes is ~300× slower than
PyTorch's, and most others are faster on cuDNN. The pair batch
is built once, without gradients; the backward pass goes through the
generator, the warps and the losses only. The face loss detaches its
second image's features, and its first images are the source and the
untuned preds, so (as in the JAX package) it adds to the loss but sends
no gradient to the generator.

Spans (``utils.profiling.span``): ``posttune`` holds a whole
:func:`adaptive_personalize`, ``posttune.pairs`` its
:func:`build_meta_pairs`, ``posttune.step`` each tune step (the
minibatch, forward, backward, Adam and the loss read back),
``posttune.refresh`` the compute copy's rebuild and the second
personalise. Counters, over every task's tune: :data:`steps` (Adam
updates) and :data:`pairs` (pairs built).
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from impersonator_tpu_torch.models import losses as L
from impersonator_tpu_torch.ops import morphology
from impersonator_tpu_torch.ops import smpl as smpl_ops
from impersonator_tpu_torch.ops.conv_route import float32_convs
from impersonator_tpu_torch.ops.sampler import grid_sample
from impersonator_tpu_torch.tasks import imitator as imitator_mod
from impersonator_tpu_torch.utils.precision import full_fp32
from impersonator_tpu_torch.utils.profiling import span

# tune steps taken and pairs built since the process started
steps = 0
pairs = 0


def load_prior_poses(path: str) -> torch.Tensor:
    """Prior-pose θs (N, 85) float32 from a pickle: a plain (N, 85) array
    or a dict of ``cams`` / ``pose`` / ``shape`` arrays (the reference's
    assets/samples/A_priors). Unpickle only files this project wrote."""
    with open(path, "rb") as f:
        d = pickle.load(f)
    if isinstance(d, dict):
        arr = np.concatenate([np.asarray(d["cams"], np.float32),
                              np.asarray(d["pose"], np.float32),
                              np.asarray(d["shape"], np.float32)], axis=1)
    else:
        arr = np.asarray(d, np.float32)
    return torch.from_numpy(arr.reshape(-1, 85))


def default_prior_poses(src_theta, n: int = 8, scale: float = 0.15,
                        seed: int = 0) -> torch.Tensor:
    """Stand-in for the prior-pose file: n copies of the source θ (1, 85)
    with N(0, scale) added to the pose, from numpy's generator of
    ``seed`` (the JAX package's draws). On the CPU."""
    rng = np.random.default_rng(seed)
    base = np.asarray(torch.as_tensor(src_theta).detach().cpu(),
                      np.float32).reshape(1, 85)
    priors = np.repeat(base, n, axis=0)
    priors[:, 3:75] += rng.normal(0, scale, (n, 72)).astype(np.float32)
    return torch.from_numpy(priors)


@torch.no_grad()
def build_meta_pairs(imit, prior_smpls, src_info=None) -> dict:
    """The pair batch of the source ``src_info`` (``imit.src_info`` by
    default) and prior_smpls (N, 85): each prior pose is rendered with the
    source's cam and shape (``zbuffer_bucket_rows``), the flows T (source
    -> pose) and T_cycle (pose -> source) come from the raster products,
    and ``init_preds``, the untuned generator's imitation in float32 with
    the master (``zbuffer_bucket_flow``), anchors the structure loss."""
    global pairs
    src = imit.src_info if src_info is None else src_info
    renderer = imit.renderer
    prior_smpls = torch.as_tensor(prior_smpls, dtype=torch.float32,
                                  device=src["img"].device)
    n = prior_smpls.shape[0]
    pairs += n

    def rep(x):
        return x.expand(n, *x.shape[1:])

    tsf = imitator_mod.swap_smpl(src["cam"], src["shape"], prior_smpls,
                                 prior_smpls[0:1, 0:3], "smooth")
    info = smpl_ops.get_details(imit.smpl_params, tsf, imit.parents)
    tsf_f2verts, tsf_fim, tsf_wim = renderer.render_fim_wim(info["cam"],
                                                            info["verts"])
    tsf_p2verts = renderer.f2pts_from_f2verts(tsf_f2verts)
    tsf_cond = renderer.encode_fim(tsf_fim)
    t = renderer.cal_bc_transform(rep(src["p2verts"]), tsf_fim, tsf_wim)
    src_fim = rep(src["fim"])
    t_cycle = renderer.cal_bc_transform(tsf_p2verts, src_fim,
                                        rep(src["wim"]))
    src_img = rep(src["img"])
    tsf_inputs = torch.cat([grid_sample(src_img, t), tsf_cond], dim=-1)
    src_cond = rep(src["cond"])
    src_crop_mask = morphology.morph(src_cond[..., -1:], ks=3, mode="erode")
    src_inputs = torch.cat([src_img * (1 - src_crop_mask), src_cond], -1)
    tsf_crop_mask = morphology.morph(tsf_cond[..., -1:], ks=3, mode="erode")
    init_preds = imitator_mod.imitate_core(
        imit.nets, renderer, imit.smpl_params, imit.parents, src, tsf)
    return {
        "src_inputs": src_inputs,
        "tsf_inputs": tsf_inputs,
        "T": t,
        "T_cycle": t_cycle,
        "src_fim": src_fim,
        "tsf_fim": tsf_fim,
        "init_preds": init_preds,
        "pseudo_masks": torch.cat([src_crop_mask, tsf_crop_mask], 0),
        "images_src": src_img,
        "j2d_src": rep(src["j2d"]),
        "j2d_tsf": info["j2d"],
    }


def tune_loss(gen, renderer, batch: dict, bg, face=None,
              front_warp: bool = False, use_face: bool = True):
    """(total, {"cyc", "str", "fid", "msk", "total"}) of one pair
    minibatch under the float32 generator ``gen``: its ``infer_front``
    imitates each pair forwards and, from the result warped back by
    T_cycle, backwards (the cycle pass)."""
    src_in, tsf_in = batch["src_inputs"], batch["tsf_inputs"]
    t, t_cycle = batch["T"], batch["T_cycle"]

    def infer(si, ti, flow):
        outs = gen.infer_front(si.permute(0, 3, 1, 2),
                               ti.permute(0, 3, 1, 2), flow)
        s_color, s_mask, t_color, t_mask = (o.permute(0, 2, 3, 1)
                                            for o in outs)
        fake_s = s_mask * bg + (1 - s_mask) * s_color
        fake_t = t_mask * bg + (1 - t_mask) * t_color
        return fake_s, fake_t, s_mask, t_mask

    fake_src, fake_tsf, fs_mask, ft_mask = infer(src_in, tsf_in, t)
    if front_warp:
        front = renderer.encode_front_fim(batch["tsf_fim"], front_fn=True)
        fake_tsf = ((1 - front) * fake_tsf
                    + tsf_in[..., 0:3] * front * (1 - ft_mask))

    cyc_src_in = torch.cat([fake_tsf * tsf_in[..., -1:], tsf_in[..., 3:]],
                           dim=-1)
    cyc_warp = grid_sample(fake_tsf, t_cycle)
    cyc_tsf_in = torch.cat([cyc_warp, src_in[..., 3:]], dim=-1)
    _, cycle_tsf, _, _ = infer(cyc_src_in, cyc_tsf_in, t_cycle)

    src_imgs = batch["images_src"]
    cycle_loss = L.l1(src_imgs, fake_src) + L.l1(src_imgs, cycle_tsf)
    body_mask = 1 - src_in[..., -1:]
    back_head = 1 - renderer.encode_front_fim(batch["tsf_fim"],
                                              front_fn=False)
    struct_loss = (L.l1(batch["init_preds"], fake_tsf)
                   + 2 * L.l1(src_imgs * body_mask * back_head,
                              cyc_warp * back_head))
    fid_loss = torch.zeros((), device=src_imgs.device)
    if use_face and face is not None:
        fid_loss = (L.face_loss(face, src_imgs, cycle_tsf,
                                kps1=batch["j2d_src"], kps2=batch["j2d_src"])
                    + L.face_loss(face, batch["init_preds"], fake_tsf,
                                  kps1=batch["j2d_tsf"],
                                  kps2=batch["j2d_tsf"]))
    mask_loss = L.bce(torch.cat([fs_mask, ft_mask], 0),
                      batch["pseudo_masks"])
    total = 10 * cycle_loss + 10 * struct_loss + fid_loss + 5 * mask_loss
    return total, {"cyc": cycle_loss, "str": struct_loss, "fid": fid_loss,
                   "msk": mask_loss, "total": total}


def make_tune_step(imit, optimizer, face=None, front_warp: bool = False,
                   use_face: bool = True):
    """step(batch, bg) -> the minibatch's losses (detached): one Adam
    update of the float32 master generator ``imit.nets.generator`` by
    ``optimizer`` on :func:`tune_loss`."""
    gen = imit.nets.generator

    def step(batch, bg):
        global steps
        steps += 1
        optimizer.zero_grad(set_to_none=True)
        total, metrics = tune_loss(gen, imit.renderer, batch, bg, face,
                                   front_warp, use_face)
        total.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step


def tune_optimizer(gen, lr: float):
    """Adam over the generator's parameters with optax.adam's update
    rule as the JAX package sets it: β 0.5 / 0.999, eps 1e-8."""
    return torch.optim.Adam(gen.parameters(), lr=lr, betas=(0.5, 0.999),
                            eps=1e-8)


def post_tune_steps(n_pairs: int, epochs: int, batch_size: int) -> int:
    """The reference's step budget: epochs × ceil(n_pairs / batch)."""
    return epochs * -(-n_pairs // max(batch_size, 1))


def _finish(task):
    """After the master changed: drop its gradients and rebuild the
    task's compute-dtype copy."""
    task.nets.generator.zero_grad(set_to_none=True)
    task.refresh_compute_nets()


def _tune_epochs(step, batch: dict, bg, epochs: int, batch_size: int,
                 seed: int, verbose: bool):
    """``epochs`` × ceil(n / batch) tune steps over a fresh numpy
    permutation of the n pairs each epoch, the last minibatch
    wrap-padded from the permutation's start -> (the last step's
    losses, each epoch's mean cycle loss, the steps taken)."""
    n = batch["T"].shape[0]
    bg = bg.expand(n, *bg.shape[1:])
    bs = min(batch_size, n)
    rng = np.random.default_rng(seed)
    cyc_history, n_steps = [], 0
    for epoch in range(epochs):
        perm = rng.permutation(n)
        epoch_cyc = []
        for k in range(-(-n // bs)):
            with span("posttune.step"):
                idx = perm[k * bs:(k + 1) * bs]
                if len(idx) < bs:
                    idx = np.concatenate([idx, perm[:bs - len(idx)]])
                idx = torch.as_tensor(idx, device=bg.device)
                # pseudo_masks stacks the source rows, then the pose rows
                mb = {key: (v[torch.cat([idx, idx + n])]
                            if key == "pseudo_masks" else v[idx])
                      for key, v in batch.items()}
                metrics = step(mb, bg[idx])
                epoch_cyc.append(float(metrics["cyc"]))
            n_steps += 1
        cyc_history.append(float(np.mean(epoch_cyc)))
        if verbose:
            print(f"post_tune epoch {epoch}: " + " ".join(
                f"{k}={float(v):.4f}" for k, v in metrics.items()))
    return metrics, cyc_history, n_steps


def adaptive_personalize(imit, prior_smpls=None, prior_poses_path=None,
                         epochs: int = 5, lr: float = 2e-4,
                         batch_size: int = 4, use_face: bool | None = None,
                         face=None, verbose: bool = False, seed: int = 0):
    """Post-tune of a personalised task (Imitator, or a subclass): the
    pair batch of its source and the prior poses, then epochs ×
    ceil(n / batch) Adam minibatch steps over a fresh numpy permutation
    of the pairs each epoch (the last minibatch wrap-padded from the
    permutation's start), updating the float32 master in place; then the
    compute copy is rebuilt and the source personalised again.

    Prior poses: ``prior_smpls`` (N, 85), else the pickle at
    ``prior_poses_path``, else :func:`default_prior_poses`. The face loss
    runs when a face net (a Sphere20a or SENet50 on the task's device) is
    given, unless ``use_face`` says otherwise. Returns the last step's
    losses (floats), ``cyc_history`` (each epoch's mean cycle loss) and
    ``n_steps``."""
    if imit.src_info is None:
        raise RuntimeError("call personalize() first")
    if use_face is None:
        use_face = face is not None
    if prior_smpls is None and prior_poses_path:
        prior_smpls = load_prior_poses(prior_poses_path)
    if prior_smpls is None:
        prior_smpls = default_prior_poses(imit.src_info["theta"])
    with span("posttune"), full_fp32():
        with float32_convs():
            with span("posttune.pairs"):
                batch = build_meta_pairs(imit, prior_smpls)
            opt = tune_optimizer(imit.nets.generator, lr)
            step = make_tune_step(imit, opt, face,
                                  front_warp=imit.cfg.front_warp,
                                  use_face=use_face)
            metrics, cyc_history, n_steps = _tune_epochs(
                step, batch, imit.src_info["bg"], epochs, batch_size, seed,
                verbose)
        with span("posttune.refresh"):
            _finish(imit)
            # the detector's mask of the first personalisation, if there
            # was one
            imit.src_info = imit._source_state(imit.src_info["img"][0],
                                               imit.src_info["theta"][0],
                                               imit._src_body_mask)
    out = {k: float(v) for k, v in metrics.items()}
    out["cyc_history"] = cyc_history
    out["n_steps"] = n_steps
    return out


def swapper_tune_lr(i: int, init_lr: float = 2e-4, final_lr: float = 1e-5,
                    fix_iters: int = 25, total_iters: int = 50) -> float:
    """The reference's swapper post-tune schedule: ``init_lr`` for
    ``fix_iters`` iterations, then a linear decay reaching ``final_lr`` at
    ``total_iters``."""
    if i < fix_iters:
        return init_lr
    decay = (init_lr - final_lr) / max(total_iters - fix_iters, 1)
    return max(init_lr - decay * (i - fix_iters + 1), final_lr)


def merge_pair_batches(batch_a: dict, batch_b: dict) -> dict:
    """Two pair batches along the batch axis. ``pseudo_masks`` keeps its
    kinds grouped, [src A, src B, pose A, pose B], as the mask loss
    compares it with [source masks, pose masks]."""
    out = {}
    for k, a in batch_a.items():
        b = batch_b[k]
        if k == "pseudo_masks":
            na, nb = a.shape[0] // 2, b.shape[0] // 2
            out[k] = torch.cat([a[:na], b[:nb], a[na:], b[nb:]], 0)
        else:
            out[k] = torch.cat([a, b], 0)
    return out


def post_tune_swapper(swapper, iters: int = 50, lr: float = 2e-4,
                      verbose: bool = False):
    """Two-image cycle tune of a Swapper after ``swap_setup``: each image
    imitates the other's pose (one pair each way), ``iters`` Adam steps
    on both pairs at once, the learning rate set on the parameter group
    each iteration by :func:`swapper_tune_lr`; then the compute copy is
    rebuilt and both images personalised again. Returns the last step's
    losses (floats)."""
    if swapper.src_info is None or swapper.tsf_info is None:
        raise RuntimeError("call swap_setup() first")
    src, tgt = swapper.src_info, swapper.tsf_info
    with full_fp32(), float32_convs():
        batch = merge_pair_batches(
            build_meta_pairs(swapper, tgt["theta"], src),
            build_meta_pairs(swapper, src["theta"], tgt))
        bg = torch.cat([src["bg"], tgt["bg"]], 0)
        opt = tune_optimizer(swapper.nets.generator, lr)
        step = make_tune_step(swapper, opt, use_face=False,
                              front_warp=swapper.cfg.front_warp)
        for i in range(iters):
            for group in opt.param_groups:
                group["lr"] = swapper_tune_lr(i, init_lr=lr,
                                              total_iters=iters)
            metrics = step(batch, bg)
            if verbose and i % 10 == 0:
                print(f"swap post_tune {i}: "
                      f"total={float(metrics['total']):.4f}")
    _finish(swapper)
    swapper.src_info = swapper.personalize(src["img"][0], src["theta"][0])
    swapper.tsf_info = swapper.personalize(tgt["img"][0], tgt["theta"][0])
    return {k: float(v) for k, v in metrics.items()}
