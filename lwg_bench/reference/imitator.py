"""Plain float32 motion imitation, the reference of the ``imitate-*``
cells: personalise a source image (SMPL, z-buffer, conditioning,
morphology masks, the background by DeepFill v2, or by the generator's
own stream with ``bg_model`` ORIGINAL, and the source stream), then
per target θ the smooth-camera swap, SMPL, z-buffer, flow T, the warp
of the source image, the transfer stream's decode against the source
features, the composite over the background and, with ``front_warp``,
the warped source pasted over the face (svip-lab/impersonator,
``models/imitator.py``, every face visible). HMR regresses θ where no
θ is given.

It imports nothing of the program. Run it under ``geometry.full_fp32``.
``Reference(..., control=True)`` is the correctness control: the
generator in float8, HMR and DeepFill in TF32, the precisions below the
configuration's bfloat16 and float32; ``control="hmr"`` puts HMR alone
in TF32."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lwg_bench.reference import geometry as G
from lwg_bench.reference import nets as N


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


class Reference:
    """The reference imitator of one configuration on one device, from
    the benchmark's body arrays and state dicts."""

    def __init__(self, cfg: dict, body_arrays: dict, uv_table, gen_state,
                 hmr_state=None, device="cuda", control=False,
                 bgnet_state=None):
        self.cfg = cfg
        self.s = cfg["image_size"]
        self.body = G.Body(body_arrays, device)
        self.table = torch.as_tensor(uv_table, device=device)
        front = torch.zeros(self.body.faces.shape[0] + 1, 1, device=device)
        front[torch.as_tensor(body_arrays["front_faces"], device=device)
              .long()] = 1.0
        self.front_table = front
        gen = N.Generator(4, 6, 6, cfg["conv_dim"], cfg["repeat_num"],
                          cfg["n_down"]).to(device)
        gen.load_state_dict(gen_state)
        self.gen = (N.fp8_copy(gen) if control is True else gen).eval()
        self.hmr = None
        if hmr_state is not None:
            self.hmr = N.HMR().to(device)
            self.hmr.load_state_dict(hmr_state)
            self.hmr.eval()
        self.bgnet = None
        if bgnet_state is not None:
            self.bgnet = N.DeepFill().to(device)
            self.bgnet.load_state_dict(bgnet_state)
            self.bgnet.eval()
        self.control = control

    def tf32(self, fn, *args, on: bool):
        """fn(*args), with TF32 on where ``on``."""
        if not on:
            return fn(*args)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            return fn(*args)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    def regress(self, img224):
        """HMR θ (B, 85); in TF32 for either control."""
        return self.tf32(self.hmr, img224, on=bool(self.control))

    def source_theta(self, img):
        """The θ HMR gives a source image (S, S, 3) in [-1, 1]: the image
        resized to 224² (bilinear, half-pixel centres) and mapped once
        more by ``* 2 - 1``, as the reference's ``cv_utils.transform_img``
        does to an image it takes for [0, 1]."""
        x = F.interpolate(nchw(img[None].float()), size=(224, 224),
                          mode="bilinear", align_corners=False,
                          antialias=False)
        return self.regress(nhwc(x) * 2.0 - 1.0)

    @torch.no_grad()
    def personalize(self, img, theta):
        """img (S, S, 3) in [-1, 1], θ (1, 85) -> the source state."""
        cfg, gen = self.cfg, self.gen
        img = img[None].float()
        verts, _, cam = G.smpl(self.body, theta)
        fv = G.face_verts(self.body, verts, cam)
        fim, _ = G.zbuffer(fv, self.s)
        cond = G.encode(fim, self.table)
        sil = cond[..., -1:]
        bg_mask = G.erode(sil, cfg["bg_ks"])
        if self.bgnet is not None:
            bg = nhwc(self.tf32(self.bgnet, nchw(img), nchw(1.0 - bg_mask),
                                on=self.control is True))
        else:
            bg = nhwc(gen.bg_model(nchw(torch.cat([img * bg_mask, bg_mask],
                                                  -1))))
        ft_mask = 1.0 - G.erode(sil, cfg["ft_ks"])
        enc, res = gen.src_model.inference(
            nchw(torch.cat([img * ft_mask, cond], -1)))
        return {"img": img, "theta": theta, "pts": G.f2pts(fv), "bg": bg,
                "enc": enc, "res": res}

    @torch.no_grad()
    def imitate(self, src, tgt, first_cam):
        """Target θs (N, 85) -> frames (N, S, S, 3) in [-1, 1]."""
        theta = G.swap_smpl(src["theta"][:, :3], src["theta"][:, 75:], tgt,
                            first_cam)
        verts, _, cam = G.smpl(self.body, theta)
        fim, wim = G.zbuffer(G.face_verts(self.body, verts, cam), self.s)
        t = G.flow(src["pts"], fim, wim)
        cond = G.encode(fim, self.table)
        warped = F.grid_sample(nchw(src["img"]).expand(t.shape[0], -1, -1,
                                                       -1),
                               t, mode="bilinear", padding_mode="zeros",
                               align_corners=True)
        if self.gen.quant is not None:
            warped = self.gen.quant(warped)
        color, mask = self.gen.decode(src["enc"], src["res"],
                                      torch.cat([warped, nchw(cond)], 1), t)
        color, mask = nhwc(color), nhwc(mask)
        out = mask * src["bg"] + (1.0 - mask) * color
        if self.cfg["front_warp"]:
            front = G.encode(fim, self.front_table)
            out = (1 - front) * out + nhwc(warped) * front * (1 - mask)
        return out

    @torch.no_grad()
    def job(self, src_img, src_theta, targets, by_theta: bool,
            block: int = 16):
        """One job -> (its frames, in blocks of ``block`` frames; the θs
        HMR gave, the source's first, or None where none was
        regressed): ``targets`` are θs (``by_theta``) or 224² crops that
        HMR turns into θs; a ``src_theta`` of None is regressed by
        HMR."""
        regressed = []
        if src_theta is None:
            src_theta = self.source_theta(src_img)
            regressed.append(src_theta)
        src = self.personalize(src_img, src_theta.reshape(1, 85).float())
        outs, first_cam = [], None
        for i in range(0, targets.shape[0], block):
            part = targets[i:i + block].float()
            theta = part if by_theta else self.regress(part)
            if not by_theta:
                regressed.append(theta)
            if first_cam is None:
                first_cam = theta[0:1, :3]
            outs.append(self.imitate(src, theta, first_cam))
        return torch.cat(outs), (torch.cat(regressed) if regressed
                                 else None)
