"""Plain float32 post-tune of the Liquid Warping GAN's generator, the
reference of the ``imitate-posttune`` cell (svip-lab/impersonator,
``scripts/motion_imitation/runner.sh --post_tune``): the pair batch of a
personalised source and its prior poses (each pose rendered with the
source's camera and shape, the flows T and T_cycle, the untuned
generator's imitation ``init_preds``, the crop masks), the tune loss

    10·cycle L1 + 10·structure + face + 5·mask BCE

with its cycle pass (each pair imitated forwards, then from the result
warped back by T_cycle backwards), the front-warp blend, Adam on the
float32 master, and the refresh: :class:`~imitator.Reference` with the
tuned weights personalises the source again and imitates the clip.

It imports nothing of the program, and sets both TF32 flags to False
itself (``geometry.full_fp32``) around everything it computes, with
cuDNN off (:meth:`PostTune.precision`): its convolutions are then
PyTorch's own, im2col and a float32 GEMM, where cuDNN's float32 engine
for the U-net's 256 -> 128 skip convolution at 128² takes ~380 ms a
call on an H100 against ~1.4 ms.
Departures from the published description, where the program departs
too: the prior poses are the source's θ with N(0, 0.15) on its pose
from numpy's generator of seed 0 (the published ``A_priors`` file is
not in the repository); the minibatches are a fresh numpy permutation
of the pairs each epoch from one generator of seed 0, the last one
wrap-padded from its start (the published loader shuffles with its own
generator); ``init_preds`` carry no front-warp paste; the face loss
detaches its second images' features, so it adds to the loss and sends
no gradient. ``control`` puts the reference in the program's place in
a lower precision: ``"tf32"`` runs every convolution and matmul of the
tune and the clip in TF32, ``"bf16"`` runs the generator's convolutions
in bfloat16 (autocast)."""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from lwg_bench.reference import geometry as G
from lwg_bench.reference import trainer as RT
from lwg_bench.reference.imitator import Reference, nchw, nhwc


def prior_poses(theta, n: int, std: float, seed: int = 0):
    """n prior θs (n, 85): the source θ (1, 85) with N(0, std) added to
    its 72 pose values, drawn by numpy's generator of ``seed``."""
    rng = np.random.default_rng(seed)
    base = theta.detach().float().cpu().numpy().reshape(1, 85)
    priors = np.repeat(base, n, axis=0)
    priors[:, 3:75] += rng.normal(0, std, (n, 72)).astype(np.float32)
    return torch.from_numpy(priors).to(theta.device)


def minibatches(n: int, batch_size: int, epochs: int, seed: int = 0):
    """The pair indices of each tune step: per epoch a fresh permutation
    of the n pairs, cut into ceil(n / batch) minibatches, the last
    wrap-padded from the permutation's start."""
    rng = np.random.default_rng(seed)
    bs = min(batch_size, n)
    out = []
    for _ in range(epochs):
        perm = rng.permutation(n)
        for k in range(-(-n // bs)):
            idx = perm[k * bs:(k + 1) * bs]
            if len(idx) < bs:
                idx = np.concatenate([idx, perm[:bs - len(idx)]])
            out.append(idx)
    return out


def take(batch: dict, idx) -> dict:
    """Rows ``idx`` of a pair batch; ``pseudo_masks`` holds the source
    rows, then the pose rows."""
    n = batch["T"].shape[0]
    idx = torch.as_tensor(np.asarray(idx), device=batch["T"].device)
    return {k: v[torch.cat([idx, idx + n])] if k == "pseudo_masks"
            else v[idx] for k, v in batch.items()}


def l1(a, b):
    return (a - b).abs().mean()


def bce(p, target, eps: float = 1e-7):
    p = p.clamp(eps, 1 - eps)
    return -(target * torch.log(p) + (1 - target) * torch.log(1 - p)).mean()


class PostTune:
    """The reference's post-tune of one configuration on one device:
    the generator (``gen_state``), DeepFill v2 (``bgnet_state``) and
    Sphere20a (``face_state``) as state dicts, ``cfg["post_tune"]``'s
    epochs, batch, learning rate, Adam βs and face loss."""

    def __init__(self, cfg: dict, body_arrays: dict, uv_table, gen_state,
                 face_state, bgnet_state=None, device="cuda",
                 control=None):
        self.cfg, self.pt, self.control = cfg, cfg["post_tune"], control
        self.s = cfg["image_size"]
        self.imitator = Reference(cfg, body_arrays, uv_table, gen_state,
                                  None, device, bgnet_state=bgnet_state)
        self.gen = self.imitator.gen
        self.body, self.table = self.imitator.body, self.imitator.table
        self.front_table = self.imitator.front_table
        back = torch.zeros_like(self.front_table)
        back[torch.as_tensor(body_arrays["head_faces"], device=device)
             .long()] = 1.0
        self.back_table = back * (1 - self.front_table)
        self.face = None
        if self.pt["use_face"]:
            self.face = RT.Sphere20a().to(device)
            self.face.load_state_dict(face_state)
            self.face.eval().requires_grad_(False)
        self.gen_state = gen_state
        self.names = [n for n, _ in self.gen.named_parameters()]
        self.params = [p for _, p in self.gen.named_parameters()]

    def reset(self):
        """The generator back to the weights it was built with."""
        self.gen.load_state_dict(self.gen_state)

    @contextlib.contextmanager
    def precision(self):
        """Full float32 with cuDNN off, or the control's precision (cuDNN
        on: TF32, or float32 flags with the generator in bfloat16)."""
        cudnn = torch.backends.cudnn
        saved = cudnn.enabled
        with G.full_fp32():
            cudnn.enabled = self.control is not None
            if self.control == "tf32":
                torch.backends.cuda.matmul.allow_tf32 = True
                cudnn.allow_tf32 = True
            try:
                yield
            finally:
                cudnn.enabled = saved

    def gen_context(self, device):
        """Where the generator computes: bfloat16 under the ``"bf16"``
        control, else as it is."""
        if self.control == "bf16":
            return torch.autocast(torch.device(device).type,
                                  dtype=torch.bfloat16)
        return contextlib.nullcontext()

    @torch.no_grad()
    def source(self, img, theta) -> dict:
        """The personalised source: img (S, S, 3) in [-1, 1], θ (1, 85)
        -> the imitator's source state with the source's 2-D joints,
        fim, wim and conditioning."""
        state = self.imitator.personalize(img, theta)
        verts, j2d, cam = G.smpl(self.body, theta)
        fim, wim = G.zbuffer(G.face_verts(self.body, verts, cam), self.s)
        return dict(state, j2d=j2d, fim=fim, wim=wim,
                    cond=G.encode(fim, self.table))

    @torch.no_grad()
    def pairs(self, src: dict, priors) -> dict:
        """The pair batch of the source and the prior θs (n, 85), under
        the program's names."""
        n = priors.shape[0]
        theta = G.swap_smpl(src["theta"][:, :3], src["theta"][:, 75:],
                            priors, priors[0:1, :3])
        verts, j2d, cam = G.smpl(self.body, theta)
        fv = G.face_verts(self.body, verts, cam)
        fim, wim = G.zbuffer(fv, self.s)
        cond = G.encode(fim, self.table)
        t = G.flow(src["pts"], fim, wim)
        t_cycle = G.flow(G.f2pts(fv), src["fim"].expand(n, -1, -1),
                         src["wim"].expand(n, -1, -1, -1))
        img = src["img"].expand(n, -1, -1, -1)
        warped = nhwc(F.grid_sample(nchw(img), t, mode="bilinear",
                                    padding_mode="zeros",
                                    align_corners=True))
        src_cond = src["cond"].expand(n, -1, -1, -1)
        src_crop = G.erode(src_cond[..., -1:], 3)
        with self.gen_context(img.device):
            color, mask = self.gen.decode(
                src["enc"], src["res"],
                torch.cat([nchw(warped), nchw(cond)], 1), t)
        color, mask = nhwc(color.float()), nhwc(mask.float())
        return {
            "src_inputs": torch.cat([img * (1 - src_crop), src_cond], -1),
            "tsf_inputs": torch.cat([warped, cond], -1),
            "T": t, "T_cycle": t_cycle,
            "src_fim": src["fim"].expand(n, -1, -1), "tsf_fim": fim,
            "init_preds": mask * src["bg"] + (1 - mask) * color,
            "pseudo_masks": torch.cat([src_crop,
                                       G.erode(cond[..., -1:], 3)], 0),
            "images_src": img,
            "j2d_src": src["j2d"].expand(n, -1, -1), "j2d_tsf": j2d}

    def _infer(self, src_in, tsf_in, t, bg):
        """Both live streams of one pass -> (fake source, fake transfer,
        their masks), NHWC, composited over the background."""
        gen = self.gen
        with self.gen_context(src_in.device):
            enc, res = gen.src_model.inference(nchw(src_in))
            tc, tm = gen.decode(enc, res, nchw(tsf_in), t)
            sc, sm = gen.src_model.decode(res[-1], enc)
        sc, sm, tc, tm = (nhwc(x.float()) for x in (sc, sm, tc, tm))
        return sm * bg + (1 - sm) * sc, tm * bg + (1 - tm) * tc, sm, tm

    def _face(self, imgs1, imgs2, kps):
        """Σ L1 over Sphere20a's five outputs of the head crops (112×96,
        the head box of ``kps``), the second images' detached."""
        box = RT.head_bbox(kps)
        f1 = self.face(RT.crop(nchw(imgs1), box, 112, 96))
        f2 = self.face(RT.crop(nchw(imgs2), box, 112, 96))
        return sum(l1(a, b.detach()) for a, b in zip(f1, f2))

    def loss(self, batch: dict, bg):
        """(total, {"cyc", "str", "fid", "msk"}) of one minibatch with the
        generator's current parameters."""
        src_in, tsf_in = batch["src_inputs"], batch["tsf_inputs"]
        fake_src, fake_tsf, fs_mask, ft_mask = self._infer(
            src_in, tsf_in, batch["T"], bg)
        if self.cfg["front_warp"]:
            front = G.encode(batch["tsf_fim"].long(), self.front_table)
            fake_tsf = ((1 - front) * fake_tsf
                        + tsf_in[..., :3] * front * (1 - ft_mask))
        cyc_src_in = torch.cat([fake_tsf * tsf_in[..., -1:],
                                tsf_in[..., 3:]], -1)
        cyc_warp = nhwc(F.grid_sample(nchw(fake_tsf), batch["T_cycle"],
                                      mode="bilinear", padding_mode="zeros",
                                      align_corners=True))
        cyc_tsf_in = torch.cat([cyc_warp, src_in[..., 3:]], -1)
        _, cycle_tsf, _, _ = self._infer(cyc_src_in, cyc_tsf_in,
                                         batch["T_cycle"], bg)
        src = batch["images_src"]
        cyc = l1(src, fake_src) + l1(src, cycle_tsf)
        body = 1 - src_in[..., -1:]
        back_head = 1 - G.encode(batch["tsf_fim"].long(),
                                 self.back_table)
        struct = (l1(batch["init_preds"], fake_tsf)
                  + 2 * l1(src * body * back_head, cyc_warp * back_head))
        fid = torch.zeros((), device=src.device)
        if self.face is not None:
            fid = (self._face(src, cycle_tsf, batch["j2d_src"])
                   + self._face(batch["init_preds"], fake_tsf,
                                batch["j2d_tsf"]))
        msk = bce(torch.cat([fs_mask, ft_mask], 0), batch["pseudo_masks"])
        total = 10 * cyc + 10 * struct + fid + 5 * msk
        return total, {"cyc": cyc, "str": struct, "fid": fid, "msk": msk}

    def set_params(self, values: dict):
        """Load {name: tensor} into the generator's parameters."""
        with torch.no_grad():
            for n, p in zip(self.names, self.params):
                p.copy_(values[n])

    def loss_and_grads(self, batch: dict, bg):
        """(total, {name: gradient}) at the generator's current
        parameters; a parameter the loss does not reach gets zeros."""
        total, _ = self.loss(batch, bg)
        grads = torch.autograd.grad(total, self.params, allow_unused=True,
                                    materialize_grads=True)
        return total.detach(), dict(zip(self.names, grads))

    def adam(self, state: dict, grads: dict):
        """One Adam update of the generator in place (torch.optim.Adam's
        rule, eps 1e-8); ``state`` {"t", "m", "v"} starts empty. A
        parameter whose gradient is None is left alone, as the
        optimiser leaves it."""
        lr, (b1, b2) = self.pt["lr"], self.pt["betas"]
        state["t"] = t = state.get("t", 0) + 1
        m, v = state.setdefault("m", {}), state.setdefault("v", {})
        with torch.no_grad():
            for n, p in zip(self.names, self.params):
                g = grads.get(n)
                if g is None:
                    continue
                if n not in m:
                    m[n], v[n] = torch.zeros_like(p), torch.zeros_like(p)
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = v[n].sqrt() / (1 - b2 ** t) ** 0.5 + 1e-8
                p.sub_(lr / (1 - b1 ** t) * m[n] / denom)

    def tune(self, src: dict, priors) -> dict:
        """The whole tune of one source from the generator as it stands
        -> a record as the program's capture gives it: {"pairs", "bg":
        the source's background, "steps": [{"loss", "params",
        "grads"}], "tuned": the tuned state}; the generator is
        left tuned."""
        with self.precision():
            pairs = self.pairs(src, priors)
            n = priors.shape[0]
            bg = src["bg"].expand(n, -1, -1, -1)
            state, steps = {}, []
            for idx in minibatches(n, self.pt["batch_size"],
                                   self.pt["epochs"]):
                params = {k: p.detach().clone()
                          for k, p in zip(self.names, self.params)}
                total, grads = self.loss_and_grads(
                    take(pairs, idx),
                    bg[torch.as_tensor(idx, device=bg.device)])
                steps.append({"loss": total, "params": params,
                              "grads": grads})
                self.adam(state, grads)
        tuned = {k: v.detach().clone()
                 for k, v in self.gen.state_dict().items()}
        return {"pairs": pairs, "bg": src["bg"], "steps": steps,
                "tuned": tuned}

    def frames(self, img, theta, targets, tuned: dict):
        """The clip after the refresh: the imitator with the tuned
        generator personalises the source again and imitates the target
        θs (L, 85) -> frames (L, S, S, 3)."""
        saved = {k: v.detach().clone()
                 for k, v in self.gen.state_dict().items()}
        self.gen.load_state_dict(tuned)
        try:
            with self.precision(), self.gen_context(img.device):
                frames, _ = self.imitator.job(img, theta, targets, True)
        finally:
            self.gen.load_state_dict(saved)
        return frames.float()
