"""Plain float32 training step of the Liquid Warping GAN, the reference
of the ``train-*`` cells (svip-lab/impersonator,
``models/impersonator_trainer.py`` with ``scripts/train_iPER.sh``'s
loss weights): the frozen body-recovery flow (SMPL of both θs, the
source's z-buffer, the target's z-buffer and flow T, the conditioning,
morphology masks and the head box), the generator's three streams, the
LSGAN PatchGAN, every loss term (adversarial, reconstruction L1, VGG19
perceptual, Sphere20a face, mask BCE, mask total variation), G's and
D's gradients and Adam on each.

It imports nothing of the program. Run it under
``geometry.full_fp32``. ``fp8=True`` is the correctness control: the
generator, the discriminator and VGG compute as fp8 training would
where the program computes in bfloat16 (weights, each layer's inputs and
outputs in e4m3, their gradients in e5m2), the precision below the
configuration's bfloat16."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize

from lwg_bench.reference import geometry as G
from lwg_bench.reference import nets as N

NECK = 12                     # cocoplus index of the neck
VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
           512, 512, 512, 512, "M", 512]
VGG_TAPS = (1, 3, 5, 9)       # ReLUs of conv1_2, conv2_2, conv3_2, conv4_2
VGG_W = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)
SPHERE = ((1, 64, [(2, 3)]), (2, 128, [(2, 3), (4, 5)]),
          (3, 256, [(2, 3), (4, 5), (6, 7), (8, 9)]), (4, 512, [(2, 3)]))


class Vgg19(nn.Module):
    """torchvision's vgg19.features[:30]; returns the tapped ReLUs."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for item in VGG_CFG:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, item, 3, 1, 1), nn.ReLU()]
                cin = item
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        feats, n = [], 0
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.ReLU):
                if n in VGG_TAPS:
                    feats.append(x)
                    if len(feats) == len(VGG_TAPS):
                        break
                n += 1
        return feats


class PReLU(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.full((c,), 0.25))

    def forward(self, x):
        a = self.weight.reshape(-1, *([1] * (x.ndim - 2)))
        return torch.where(x >= 0, x, a * x)


class Sphere20a(nn.Module):
    """SphereFace-20a: four stage features and the fc5 embedding."""

    def __init__(self):
        super().__init__()
        cin = 3
        for stage, width, pairs in SPHERE:
            self._unit(f"{stage}_1", cin, width, 2)
            for a, b in pairs:
                self._unit(f"{stage}_{a}", width, width, 1)
                self._unit(f"{stage}_{b}", width, width, 1)
            cin = width
        self.fc5 = nn.Linear(512 * 7 * 6, 512)

    def _unit(self, name, cin, cout, stride):
        setattr(self, f"conv{name}", nn.Conv2d(cin, cout, 3, stride, 1))
        setattr(self, f"relu{name}", PReLU(cout))

    def _run(self, name, x):
        return getattr(self, f"relu{name}")(getattr(self, f"conv{name}")(x))

    def forward(self, x):
        feats = []
        for stage, _, pairs in SPHERE:
            x = self._run(f"{stage}_1", x)
            for a, b in pairs:
                x = x + self._run(f"{stage}_{b}", self._run(f"{stage}_{a}",
                                                            x))
            feats.append(x)
        feats.append(self.fc5(x.flatten(1)))
        return feats


class PatchD(nn.Module):
    """The PatchGAN: 4×4 convs (stride 2, then 1), instance norms,
    LeakyReLU 0.2, a one-channel LSGAN head."""

    def __init__(self, input_nc=6, ndf=64, n_layers=4):
        super().__init__()
        layers = [nn.Conv2d(input_nc, ndf, 4, 2, 1), nn.LeakyReLU(0.2)]
        nf = ndf
        for n in range(1, n_layers + 1):
            nxt = ndf * min(2 ** n, 8)
            layers += [nn.Conv2d(nf, nxt, 4, 2 if n < n_layers else 1, 1),
                       N.InstanceNorm(nxt), nn.LeakyReLU(0.2)]
            nf = nxt
        layers.append(nn.Conv2d(nf, 1, 4, 1, 1))
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)


class _RoundFp8(torch.autograd.Function):
    """float8 e4m3 rounding forward, the identity backward."""

    @staticmethod
    def forward(ctx, x):
        return N.fp8(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Both(torch.autograd.Function):
    """float8 e4m3 rounding forward; the gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return N.fp8(x)

    @staticmethod
    def backward(ctx, g):
        return N.fp8_e5m2(g)


class _Fp8Weight(nn.Module):
    def forward(self, w):
        return _RoundFp8.apply(w)


def fp8_net(net: nn.Module) -> nn.Module:
    """``net`` computing as fp8 training would where the program computes
    in bfloat16: every convolution's weights rounded to e4m3 (straight
    through), and every layer's input and output to e4m3 with their
    gradients to e5m2 (a :class:`~nets.Generator`'s warped features
    too); in place. Parameter names gain
    ``parametrizations.weight.original`` (see :func:`leaves`)."""
    for m in list(net.modules()):
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            parametrize.register_parametrization(m, "weight", _Fp8Weight())
        if not list(m.children()) and not isinstance(m, _Fp8Weight):
            m.register_forward_pre_hook(
                lambda mod, args: (_Fp8Both.apply(args[0]), *args[1:]))
            m.register_forward_hook(
                lambda mod, args, out: _Fp8Both.apply(out))
    if isinstance(net, N.Generator):
        net.quant = _Fp8Both.apply
    return net


def leaves(net: nn.Module) -> list:
    """(name, parameter) of ``net`` under the plain names."""
    return [(n.replace(".parametrizations.weight.original", ".weight"), p)
            for n, p in net.named_parameters()]


def head_bbox(kps):
    """cocoplus keypoints (B, 19, 2) in [-1, 1] -> fractional head boxes
    [min_x, max_x, min_y, max_y]."""
    k = (kps + 1.0) / 2.0
    head = k[:, NECK:]
    return torch.stack([(head[..., 0].amin(1) - 0.05).clamp(0, 1),
                        (head[..., 0].amax(1) + 0.05).clamp(0, 1),
                        (head[..., 1].amin(1) - 0.05).clamp(0, 1),
                        head[..., 1].amax(1).clamp(0, 1)], 1)


def crop(imgs, box, h, w):
    """Bilinear crops (B, 3, h, w) of NCHW images at fractional boxes."""
    b = imgs.shape[0]
    x0, x1, y0, y1 = box.unbind(1)

    def axis(a0, a1, n):
        t = torch.arange(n, dtype=torch.float32, device=imgs.device) \
            / max(n - 1, 1)
        return (a0[:, None] + t[None] * (a1 - a0)[:, None]) * 2.0 - 1.0

    gx, gy = axis(x0, x1, w), axis(y0, y1, h)
    grid = torch.stack([gx[:, None, :].expand(b, h, w),
                        gy[:, :, None].expand(b, h, w)], -1)
    return F.grid_sample(imgs, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=True)


@torch.no_grad()
def body_flow(body: G.Body, table, src_img, ref_img, src_smpl, ref_smpl,
              s: int) -> dict:
    """The generator's inputs (NCHW), T, the crop masks and the head
    boxes of a batch of (source, reference) pairs."""
    def nchw(x):
        return x.permute(0, 3, 1, 2)

    sv, _, scam = G.smpl(body, src_smpl)
    rv, rj2d, rcam = G.smpl(body, ref_smpl)
    sfv = G.face_verts(body, sv, scam)
    sfim, _ = G.zbuffer(sfv, s)
    scond = G.encode(sfim, table)
    rfim, rwim = G.zbuffer(G.face_verts(body, rv, rcam), s)
    t = G.flow(G.f2pts(sfv), rfim, rwim)
    rcond = G.encode(rfim, table)
    syn = F.grid_sample(src_img, t, mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    src_crop = nchw(G.erode(scond[..., -1:], 3))
    bg_mask = nchw(G.erode(scond[..., -1:], 15))
    return {"bg": torch.cat([src_img * bg_mask, bg_mask], 1),
            "src": torch.cat([src_img * (1 - src_crop), nchw(scond)], 1),
            "tsf": torch.cat([syn, nchw(rcond)], 1), "T": t,
            "src_crop": src_crop,
            "tsf_crop": nchw(G.erode(rcond[..., -1:], 3)),
            "head": head_bbox(rj2d)}


class Step:
    """The reference's train step on float32 master weights: G's loss and
    gradient with D as it stands, D's on the detached fake, then Adam
    on both (torch.optim.Adam's rule, eps 1e-8)."""

    def __init__(self, cfg: dict, body_arrays: dict, uv_table, states: dict,
                 device, fp8: bool = False):
        self.cfg, self.s = cfg, cfg["image_size"]
        self.body = G.Body(body_arrays, device)
        self.table = torch.as_tensor(uv_table, device=device)
        self.gen = N.Generator(4, 6, 6, cfg["conv_dim"], cfg["repeat_num"],
                               cfg["n_down"]).to(device)
        self.disc = PatchD(6, cfg["ndf"], cfg["d_layers"]).to(device)
        self.vgg = Vgg19().to(device).eval().requires_grad_(False)
        self.face = Sphere20a().to(device).eval().requires_grad_(False)
        for net, key in ((self.gen, "G"), (self.disc, "D"),
                         (self.vgg, "vgg"), (self.face, "face")):
            net.load_state_dict(states[key])
        if fp8:
            for net in (self.gen, self.disc, self.vgg):
                fp8_net(net)
        self.params = {"G": leaves(self.gen), "D": leaves(self.disc)}
        self.opt = {k: {"m": [torch.zeros_like(p) for _, p in v],
                        "v": [torch.zeros_like(p) for _, p in v]}
                    for k, v in self.params.items()}
        self.t = 0

    def losses(self, batch):
        """-> (G's total, D's loss as a function, the fake)."""
        cfg = self.cfg
        img, smpl = batch["images"], batch["smpls"]
        src_img, tsf_img = img[:, 0], img[:, 1]
        inp = body_flow(self.body, self.table, src_img, tsf_img,
                        smpl[:, 0], smpl[:, 1], self.s)
        bg, sc, sm, tc, tm = self.gen(inp["bg"], inp["src"], inp["tsf"],
                                      inp["T"])
        fake_src = sm * bg + (1 - sm) * sc
        fake_tsf = tm * bg + (1 - tm) * tc
        cond = inp["tsf"][:, 3:]
        adv = ((self.disc(torch.cat([fake_tsf, cond], 1))) ** 2).mean()
        rec = (fake_src - src_img).abs().mean()
        fx, fy = self.vgg(fake_tsf), self.vgg(tsf_img)
        perc = sum(w * (a - b.detach()).abs().mean()
                   for w, a, b in zip(VGG_W, fx, fy))
        f1 = self.face(crop(fake_tsf, inp["head"], 112, 96))
        f2 = self.face(crop(tsf_img, inp["head"], 112, 96))
        face = sum((a - b.detach()).abs().mean() for a, b in zip(f1, f2))
        masks = torch.cat([sm, tm], 0)
        target = torch.cat([inp["src_crop"], inp["tsf_crop"]], 0)
        p = masks.clamp(1e-7, 1 - 1e-7)
        mask = -(target * torch.log(p)
                 + (1 - target) * torch.log(1 - p)).mean()
        mh = masks.permute(0, 2, 3, 1)
        tv = ((mh[:, :, :-1] - mh[:, :, 1:]).abs().mean()
              + (mh[:, :-1] - mh[:, 1:]).abs().mean())
        total = (adv * cfg["lambda_D_prob"] + rec * cfg["lambda_rec"]
                 + perc * cfg["lambda_tsf"] + face * cfg["lambda_face"]
                 + mask * cfg["lambda_mask"]
                 + tv * cfg["lambda_mask_smooth"])

        def d_loss():
            real = self.disc(torch.cat([tsf_img, cond], 1))
            fake = self.disc(torch.cat([fake_tsf.detach(), cond], 1))
            return (((real - 1.0) ** 2).mean()
                    + ((fake + 1.0) ** 2).mean()) * cfg["lambda_D_prob"]
        return total, d_loss, fake_tsf

    def _adam(self, key, params, grads, lr, b1, b2):
        st = self.opt[key]
        with torch.no_grad():
            for p, g, m, v in zip(params, grads, st["m"], st["v"]):
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                mhat = m / (1 - b1 ** self.t)
                vhat = v / (1 - b2 ** self.t)
                p.sub_(lr * mhat / (vhat.sqrt() + 1e-8))

    def step(self, batch) -> dict:
        """One G + D update -> {"g_total", "d_loss", "grads": {"G": [...],
        "D": [...]}} (the gradients as the optimiser gets them, in the
        order of :attr:`params`)."""
        cfg = self.cfg
        gp = [p for _, p in self.params["G"]]
        dp = [p for _, p in self.params["D"]]
        total, d_loss_fn, _ = self.losses(batch)
        g_grads = torch.autograd.grad(total, gp, materialize_grads=True)
        d_loss = d_loss_fn()
        d_grads = torch.autograd.grad(d_loss, dp, materialize_grads=True)
        self.t += 1
        self._adam("G", gp, g_grads, cfg["lr_G"], cfg["G_adam_b1"],
                   cfg["G_adam_b2"])
        self._adam("D", dp, d_grads, cfg["lr_D"], cfg["D_adam_b1"],
                   cfg["D_adam_b2"])
        return {"g_total": float(total.detach()),
                "d_loss": float(d_loss.detach()),
                "grads": {"G": g_grads, "D": d_grads}}


