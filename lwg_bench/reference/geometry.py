"""Plain float32 geometry of the Liquid Warping GAN: SMPL linear-blend
skinning, the renderer's weak-perspective projection, a z-buffer that
enumerates each face's pixel box, the correspondence flow T, the fim
encoding and the morphology masks.

The benchmark's own reference: it imports nothing of the program. SMPL,
the projection and the flow follow the reference implementation
(svip-lab/impersonator, ``utils/nmr.py`` and ``networks/batch_smpl.py``)
as the program states them; the z-buffer computes the same winner as the
neural renderer's rasteriser (pixel-centre inside test, barycentrics
clipped to [0, 1] and renormalised, perspective-correct depth, near 0.1
and far 25, the lowest face id on equal depth, a vertical flip) by
another route: every (pixel, face) pair of the face's pixel box, then a
scatter-min over depth. Call it with TF32 off (``full_fp32``)."""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

NEAR, FAR = 0.1, 25.0
EYE_Z = 1.0 / math.tan(math.radians(30.0)) + 1.0
BG_FLOW = -2.0
OPS_TEST, OPS_HIT = 15, 23   # float operations of a pair's box / hit test


@contextlib.contextmanager
def full_fp32():
    """float32 matmuls and convolutions without TF32 inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class Body:
    """The body's constant tensors on one device, from the arrays of
    ``reference.body.body_arrays``."""

    def __init__(self, arrays: dict, device):
        def f32(name):
            return torch.as_tensor(np.asarray(arrays[name], np.float32),
                                   device=device)

        self.v_template = f32("v_template")
        self.shapedirs = f32("shapedirs")
        self.posedirs = f32("posedirs")
        self.j_regressor = f32("j_regressor")
        self.lbs_weights = f32("lbs_weights")
        self.joint_regressor = f32("joint_regressor")
        self.parents = np.asarray(arrays["parents"])
        self.faces = torch.as_tensor(np.asarray(arrays["faces"], np.int64),
                                     device=device)


def rodrigues(theta):
    """Axis-angle (..., 3) -> rotations (..., 3, 3), with the reference's
    +1e-8 before the norm."""
    shifted = theta + 1e-8
    angle = torch.linalg.norm(shifted, dim=-1, keepdim=True)
    r = shifted / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = r.unbind(-1)
    zero = torch.zeros_like(rx)
    skew = torch.stack([torch.stack([zero, -rz, ry], -1),
                        torch.stack([rz, zero, -rx], -1),
                        torch.stack([-ry, rx, zero], -1)], -2)
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    return (cos * eye + (1.0 - cos) * r[..., :, None] * r[..., None, :]
            + sin * skew)


def smpl(body: Body, theta85):
    """θ (N, 85) = cam (3), pose (72), shape (10) -> (verts (N, nv, 3),
    2-D cocoplus joints (N, 19, 2), cam (N, 3))."""
    n = theta85.shape[0]
    cam, pose, beta = theta85[:, :3], theta85[:, 3:75], theta85[:, 75:]
    nv = body.v_template.shape[0]
    v_shaped = (beta @ body.shapedirs).reshape(n, nv, 3) + body.v_template
    joints = torch.einsum("nvc,vj->njc", v_shaped, body.j_regressor)
    rots = rodrigues(pose.reshape(n, 24, 3))
    eye = torch.eye(3, dtype=rots.dtype, device=rots.device)
    v_posed = (((rots[:, 1:] - eye).reshape(n, -1) @ body.posedirs)
               .reshape(n, nv, 3) + v_shaped)
    parents = body.parents
    bones = joints.clone()
    bones[:, 1:] = joints[:, 1:] - joints[:, parents[1:]]
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rots.dtype,
                          device=rots.device).expand(n, 24, 1, 4)
    local = torch.cat([torch.cat([rots, bones[..., None]], -1), bottom], -2)
    chain = [local[:, 0]]
    for i in range(1, 24):
        chain.append(chain[int(parents[i])] @ local[:, i])
    world = torch.stack(chain, 1)
    rest = torch.einsum("njab,njb->nja", world[..., :3], joints)
    rel = world.clone()
    rel[..., 3] = world[..., 3] - rest
    skin = torch.einsum("vj,njab->nvab", body.lbs_weights, rel)
    homo = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], -1)
    verts = torch.einsum("nvab,nvb->nva", skin, homo)[..., :3]
    j3d = torch.einsum("nvc,vk->nkc", verts, body.joint_regressor)
    j2d = cam[:, None, 0:1] * (j3d[..., :2] + cam[:, None, 1:])
    return verts, j2d, cam


def face_verts(body: Body, verts, cam):
    """Posed vertices -> each face's vertices in raster space (N, nf, 3,
    3): s · (xy + t), y flipped, z moved to the eye at EYE_Z."""
    xy = cam[:, None, 0:1] * (verts[..., :2] + cam[:, None, 1:])
    proj = torch.cat([xy[..., :1], -xy[..., 1:], verts[..., 2:] + EYE_Z], -1)
    return proj[:, body.faces]


def f2pts(fverts):
    """Face vertices' xy with y back in the image-up convention."""
    return torch.stack([fverts[..., 0], -fverts[..., 1]], -1)


def swap_smpl(src_cam, src_shape, tgt, first_cam):
    """The "smooth" camera strategy: the source's scale and shape, the
    source's shift plus the target's xy drift from its first frame, the
    target's pose."""
    n = tgt.shape[0]
    cam = torch.cat([src_cam[:, :1].expand(n, 1),
                     src_cam[:, 1:] + tgt[:, 1:3] - first_cam[:, 1:]], 1)
    return torch.cat([cam, tgt[:, 3:75], src_shape.expand(n, 10)], 1)


def _pixel_boxes(px, py, s):
    """Each face's box of pixel indices whose centre can lie inside it,
    widened by one pixel and clamped to the image: (x0, x1, y0, y1)."""
    x0 = torch.ceil(px.amin(-1)) - 1
    x1 = torch.floor(px.amax(-1)) + 1
    y0 = torch.ceil(py.amin(-1)) - 1
    y1 = torch.floor(py.amax(-1)) + 1
    return (x0.clamp(0, s - 1), x1.clamp(-1, s - 1), y0.clamp(0, s - 1),
            y1.clamp(-1, s - 1))


def zbuffer(fverts, s: int, count: bool = False):
    """fverts (B, nf, 3, 3) -> fim (B, S, S) int64 (-1 background), wim
    (B, S, S, 3) (0 background); with ``count`` also the pairs of pixel
    and front-facing face with the pixel in the face's exact pixel box,
    and those passing the inside test, summed over the batch (the work a
    z-buffer of these faces needs, whatever implements it)."""
    fv = fverts.float()
    b, nf = fv.shape[:2]
    dev = fv.device
    sf = float(s)
    xv, yv, zv = fv[..., 0], fv[..., 1], fv[..., 2]
    front = ((yv[..., 2] - yv[..., 0]) * (xv[..., 1] - xv[..., 0])
             >= (yv[..., 1] - yv[..., 0]) * (xv[..., 2] - xv[..., 0]))
    px = 0.5 * (xv * sf + sf - 1.0)
    py = 0.5 * (yv * sf + sf - 1.0)
    p0x, p1x, p2x = px.unbind(-1)
    p0y, p1y, p2y = py.unbind(-1)
    denom = p2x * (p0y - p1y) + p0x * (p1y - p2y) + p1x * (p2y - p0y)
    denom = torch.where(denom == 0.0, 1.0, denom)
    inv = torch.stack([
        torch.stack([p1y - p2y, p2x - p1x, p1x * p2y - p2x * p1y], -1),
        torch.stack([p2y - p0y, p0x - p2x, p2x * p0y - p0x * p2y], -1),
        torch.stack([p0y - p1y, p1x - p0x, p0x * p1y - p1x * p0y], -1),
    ], -2) / denom[..., None, None]
    x0, x1, y0, y1 = _pixel_boxes(px, py, s)
    live = front & (x0 <= x1) & (y0 <= y1)
    extent = torch.maximum(x1 - x0, y1 - y0) + 1
    ex0, ex1 = torch.ceil(px.amin(-1)), torch.floor(px.amax(-1))
    ey0, ey1 = torch.ceil(py.amin(-1)), torch.floor(py.amax(-1))

    keys, zs, fids, ws = [], [], [], []
    n_box = n_hit = 0
    lo = 0
    for k in (4, 8, 16, 32, 64, 128, 256, 512):
        group = live & (extent > lo) & (extent <= k)
        lo = k
        bi, fi = torch.nonzero(group, as_tuple=True)
        chunk = max(1, (1 << 23) // (k * k))
        d = torch.arange(k, device=dev, dtype=torch.float32)
        for c in range(0, bi.numel(), chunk):
            bb, ff = bi[c:c + chunk], fi[c:c + chunk]
            xi = x0[bb, ff][:, None, None] + d[None, None, :]
            yi = y0[bb, ff][:, None, None] + d[None, :, None]
            inbox = (xi <= x1[bb, ff][:, None, None]) \
                & (yi <= y1[bb, ff][:, None, None])

            def v(a):
                return a[bb, ff][:, None, None]

            xp = (2.0 * xi + 1.0 - sf) / sf
            yp = (2.0 * yi + 1.0 - sf) / sf
            fx0, fx1, fx2 = (v(xv[..., j]) for j in range(3))
            fy0, fy1, fy2 = (v(yv[..., j]) for j in range(3))
            t0 = (yp - fy0) * (fx1 - fx0) - (xp - fx0) * (fy1 - fy0)
            t1 = (yp - fy1) * (fx2 - fx1) - (xp - fx1) * (fy2 - fy1)
            t2 = (yp - fy2) * (fx0 - fx2) - (xp - fx2) * (fy0 - fy2)
            inside = inbox & (t0 >= 0) & (t1 >= 0) & (t2 >= 0)
            w = [(v(inv[..., j, 0]) * xi + v(inv[..., j, 1]) * yi
                  + v(inv[..., j, 2])).clamp(0.0, 1.0) for j in range(3)]
            wsum = w[0] + w[1] + w[2]
            wsum = torch.where(wsum == 0.0, 1.0, wsum)
            w = [wj / wsum for wj in w]
            zp = 1.0 / (w[0] / v(zv[..., 0]) + w[1] / v(zv[..., 1])
                        + w[2] / v(zv[..., 2]))
            ok = inside & (zp > NEAR) & (zp < FAR)
            if count:
                exact = ((xi >= v(ex0)) & (xi <= v(ex1)) & (yi >= v(ey0))
                         & (yi <= v(ey1)) & inbox)
                n_box += int(exact.sum())
                n_hit += int(inside.sum())
            sel = torch.nonzero(ok, as_tuple=True)
            pix = (yi.expand_as(ok)[sel] * s + xi.expand_as(ok)[sel]).long()
            keys.append(bb[sel[0]] * (s * s) + pix)
            zs.append(zp[sel])
            fids.append(ff[sel[0]])
            ws.append(torch.stack([wj.expand_as(ok)[sel] for wj in w], -1))
    key = torch.cat(keys) if keys else torch.zeros(0, dtype=torch.long,
                                                   device=dev)
    z = torch.cat(zs) if zs else torch.zeros(0, device=dev)
    fid = torch.cat(fids) if fids else torch.zeros(0, dtype=torch.long,
                                                   device=dev)
    w = torch.cat(ws) if ws else torch.zeros(0, 3, device=dev)
    npx = b * s * s
    zmin = torch.full((npx,), FAR, device=dev).scatter_reduce(
        0, key, z, "amin")
    win = z == zmin[key]
    fmin = torch.full((npx,), nf, dtype=torch.long, device=dev)
    fmin = fmin.scatter_reduce(0, key[win], fid[win], "amin")
    best = win & (fid == fmin[key])
    fim = torch.full((npx,), -1, dtype=torch.long, device=dev)
    wim = torch.zeros((npx, 3), device=dev)
    fim[key[best]] = fid[best]
    wim[key[best]] = w[best]
    fim = fim.reshape(b, s, s).flip(1)
    wim = wim.reshape(b, s, s, 3).flip(1)
    if count:
        return fim, wim, (n_box, n_hit)
    return fim, wim


def flow(src_pts, fim, wim):
    """T (B, S, S, 2): each covered pixel's barycentric blend of its
    face's source-image vertex xy; BG_FLOW on background. src_pts (Bs,
    nf, 3, 2) with Bs in {1, B}."""
    b = fim.shape[0]
    covered = fim >= 0
    idx = fim.clamp(min=0)
    src = src_pts.expand(b, *src_pts.shape[1:])
    rows = torch.arange(b, device=fim.device)[:, None, None]
    t = torch.einsum("bhwk,bhwkc->bhwc", wim, src[rows, idx])
    return torch.where(covered[..., None], t, BG_FLOW)


def encode(fim, table):
    """fim -> (B, S, S, C) rows of ``table`` (nf + 1, C), the last row
    for background."""
    nf = table.shape[0] - 1
    return table[torch.where(fim < 0, nf, fim)]


def erode(mask, ks: int):
    """(B, H, W, 1) {0, 1} mask kept where its whole ks × ks window is
    set, the border counted as set."""
    x = F.pad(mask.permute(0, 3, 1, 2), (ks // 2,) * 4, value=1.0)
    sums = F.avg_pool2d(x, ks, stride=1, divisor_override=1)
    return (sums == float(ks * ks)).to(mask.dtype).permute(0, 2, 3, 1)


def flow_bytes(b: int, nf: int, s: int) -> int:
    """Bytes a fused z-buffer + flow pass must move at least: the faces'
    raster-space vertices (B, nf, 9) and the source's face xy (nf, 6)
    read once, float32, and fim (int32) and T (2 × float32) written
    once."""
    return 4 * (9 * b * nf + 6 * nf) + 12 * b * s * s
