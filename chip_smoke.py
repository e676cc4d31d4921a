#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (impersonator_tpu_torch) on
one NVIDIA GPU. Run from the repository root:

    python3 chip_smoke.py

Phases, each failing the run (exit 1) on any error:

1. needs torch.cuda; prints the card's name and power limit;
2. builds the hand-written kernels with nvcc, every csrc/*.cu at once,
   and beside them the image codec (csrc/host_codec.cpp against nvJPEG
   and zlib; build seconds);
3. bucket kernels vs their plain twins on the card at 256² on the
   12,880-face synthetic body: 16 poses, plus a random scene with one
   oversized front face, a scene behind the far plane and a degenerate
   scene (equal vertices on pixel centres, collinear faces, slivers: the
   pairs the kernels' warp cull must keep, tests/test_torch_cuda.py);
   fim equal, weights <= 2e-4, flow <= 1e-5; the share of (warp, face)
   pairs the cull keeps on the bodies (its plain mirror); ms of the twin
   and of the kernel at batch 16: the median of CUDA events around a
   lone call (the record's ms, as the earlier records timed it; it also
   counts the host's launch), and the median device time of one launch
   under torch.profiler (device_ms);
3b. zbuffer_tiles vs its plain twin at the renderer's tile_params()
   point (tile 8, cap 288, span 3 at 256²) on the same 16 bodies, the
   random + oversized scene, the behind-far scene, 3,000 small faces
   at cap 4, where both drop the same candidates, and the tie scene
   (scenes.tie_scene: coplanar faces of equal depth on both sides of the
   kernel's share boundaries); fim equal, weights <= 2e-4; its fim on the
   bodies equals zbuffer_bucket_rows'; tile stats; ms and device_ms of
   the kernel, ms of the twin, on the bodies (a shape the renderer does
   not send it);
3c. the renderer's tiled route: render_fim_wim on 16 posed 63,480-face
   bodies launches zbuffer_tiles; on those slots, and on the tie scene
   at batch 16, the kernel's fim equals the twin's and its weights are
   within 2e-4; ms and device_ms of the kernel and ms of the twin there,
   the kernel's record; the route's device time split into the slot
   build and the kernel;
4. the given-SMPL slice at full width (256², conv_dim 64, 6 res blocks,
   bf16): Imitator.personalize and three 64-frame inference_by_smpls
   requests at batch 16, with the kernels' launch counts over that run;
   the float32 master weights the bf16 Imitator was given stay bit for
   bit;
4b. the image-driven leg at full width: HMR (ResNet-50 at 224², float32,
   TF32 off) + the same generator: personalize(src_img) with no given
   SMPL, then three 64-frame inference(tgt_imgs224, batch=16) requests;
   frames/s, HMR ms per batch of 16, launch counts;
5. the given-SMPL slice in float32 with TF32 off, 2 frames, the card
   against the CPU with the same weights: the kernels on the CPU run's
   geometry give the CPU twins' fim (equal), weights and flow; the
   generator tail on the card from the CPU's raster products gives preds
   within 1e-2. The gap of two fully independent runs is printed (the
   float32 SMPL matmuls differ by ~1e-7 between devices and can flip
   edge pixels);
5b. HMR on the card against the CPU, same weights and 224² images,
   with the process's TF32 flags on (HMR keeps full float32 itself): the
   2048-d features within 1e-5 of their largest magnitude, which the
   same encoder run in TF32 must fail, and max |dθ| <= 1e-4;
7. appearance transfer at full width (bf16): Swapper.swap_setup
   (2 zbuffer_bucket_rows launches), swap("body") and swap("all"), which
   must differ on the source's kept head, swap ms (CUDA events, median of
   20), and the swapped image personalised and driven through three
   64-frame imitate_by_smpls requests at batch 16 (4 zbuffer_bucket_flow
   launches each);
8. novel view at full width: Viewer.personalize (1 rows launch),
   view_sweep of 16 yaws (1 flow launch; the body covers > 2% of the
   pixels at yaw 0 and 90), three 64-view view_by_smpls requests with
   random root orientations at batch 16 (4 flow launches each), views/s;
8b. the DeepFill background (float32) with front_warp: personalize
   seconds (first call) and one 64-frame request;
10. test-time post-tune at full width (bf16 Imitator, float32 master,
   Sphere20a face net, seeded): adaptive_personalize on 8 default priors
   at batch 4 for 5 epochs (10 Adam steps, face loss on), twice, and
   post_tune_swapper for 50 iterations on phase 7's pair, twice: seconds
   per subject of each call, ms per tune step (CUDA events, median of
   10), the cycle-loss history, the rows and flow launches each adds;
   the losses are finite and inference after the tune differs from
   inference before it. Then one float32 tune step with TF32 off on the
   card and on the CPU from the same weights and pair batch (128², conv_dim
   64, 6 res blocks, batch 2, face loss on; the structure anchors
   swapped between the pairs, since the untuned generator's own output
   makes L1(init_preds, fake) a comparison of an image with itself whose
   gradient is the sign of rounding noise): losses within 1e-4
   relative, gradients within 5e-2 per tensor and 2e-2 over all tensors
   (L2, relative), and the Adam step the same on all but 1e-2 of the
   weights;
11. the adversarial trainer at full width (tasks/trainer.py; 256²,
   batch 16, conv_dim 64, 6 res blocks, a 4-layer instance-norm PatchGAN,
   VGG19 and Sphere20a losses on with seeded weights, the paper's loss
   weights, θs as the JAX bench's train point), in bf16 and again in
   float32 (cuDNN's default TF32): one warm-up step, then 5 timed G+D
   steps, 1 G-only step, one eval-only step and one visuals call, with
   the launch counts over those 8 (1 zbuffer_bucket_rows and 1
   zbuffer_bucket_flow each); ms per step (CUDA events, median of 5),
   samples/s, peak memory (max_memory_allocated above what the earlier
   phases still hold), finite losses, G's and
   D's weights moved, the float32 master and Adam's moments still
   float32 under bf16; a profile of one bf16 step (the largest kernels,
   the device's idle share, the z-buffers' share; full table in
   chiprun_out/profile_train_step.txt). On the step's own bodies, the
   raster with the kernels against the same calls on their plain twins
   (fim equal, weights <= 2e-4, T <= 1e-5). One float32 train step with
   TF32 off on the card and on the CPU from the same weights and the
   CPU's raster products (128², conv_dim 64, 6 res blocks, batch 2, VGG
   and face on): losses within 1e-4 relative, G and D gradients within
   5e-2 per tensor and 2e-2 over all (L2; D's conv biases before an
   instance norm, whose gradient is 0 in exact arithmetic, held below
   1e-5 of the whole gradient instead of per tensor, and no other tensor
   that small), the first Adam step
   the same on all but 1e-2 of the weights. Then cli.train.main at 256²,
   batch 16, synthetic data (64 items): 1 epoch of 4 steps, and a second
   call that resumes with --load_epoch -1 and trains epoch 2 (checkpoint
   files of both epochs, Adam's step count 8, 8 launches of each kernel);
12. host and device IO, serve and the CLIs (a temporary directory): 64
   seeded smooth 256² frames JPEG-encoded by the card's codec (quality
   95, 4:2:0) and decoded back above 35 dB; the committed fixtures
   (impersonator_tpu_torch/testdata/codec) decoded as OpenCV did (PNG
   exact, JPEG within JPEG_MAX_GAP / JPEG_OVER2_SHARE) and resize_u8 equal
   to JAX's native loader's; on a float32 task, inference_from_paths of
   the 64 frames at batch 16 with uint8 readback against
   round((inference + 1) * 127.5) (U8_STREAM_SHARE), with I420 readback
   within one level of rgb_to_i420 of the float preds, rgb_to_i420 and
   i420_to_rgb_device on the card against the CPU (equal; 1e-6), and the
   I420 ingest through _stream_infer against inference (STREAM_TOL), one
   zbuffer_bucket_flow launch per batch; on the bf16 leg of 4b: frames/s
   of the u8 and I420 streams (median of 3) against inference on the same
   frames pre-staged on the card, the split (the ring's decode + resize
   ms a frame, u8 H2D, HMR + imitation, D2H u8 / I420 ms a batch) and the
   device's idle share of one streamed request under torch.profiler
   (chiprun_out/profile_host_io.txt); serve's make_server in-process on
   127.0.0.1: /healthz (backend cuda), /personalize (a JPEG body),
   /imitate (64 θs -> 64 JPEGs of 256²), /imitate_frames (16 JPEGs), a
   malformed body 400 then 200, /imitate_video 400 without ffmpeg,
   latencies (median of 3), memory over 10 requests within
   SERVE_MEM_SLACK, HMR on the service's worker thread against a fresh
   thread (what the worker saves: PyTorch's per-thread cuDNN plans); then cli.run_imitator on the 64 frames (timed, first
   call), and together run_imitator --i420, run_swap, run_view (16 views)
   and demos imitator, each a subprocess with --device cuda, exit 0, the
   files written and decodable;
9. float32 with TF32 off, card against CPU on the same weights:
   swap_core on the card from the CPU's two states (preds within 1e-2),
   the flow kernel on the CPU's rotated meshes (fim equal to the twin's,
   flow within 1e-5) and the view tail from the CPU's raster (within
   1e-2), DeepFill's output (within 1e-3);
6. the bf16 warps of one imitation step at batch 16 (the source image
   and the generator's feature warps), CUDA events: ops.sampler's JAX
   arithmetic against one float32 F.grid_sample with its casts; then one
   full-leg request, one view_by_smpls request and one swap under
   torch.profiler: summed kernel time, the device's idle share of the
   wall time, the largest kernels and the z-buffer kernels' mean device
   time per launch (full tables in chiprun_out/profile_*.txt).

Phases run in the order 1-4b, 7, 8, 8b, 10, 11, 12, 9, 5, 5b, 6. Each
path (3c, 4, 4b, 7, 8, 8b, 10, 11's bf16, float32 and CLI runs, 12's
streamed requests and /imitate) runs with
every launch count set to 0 just before it and read just after, and
fails if a kernel of the path never launched; the record's
launches_by_path holds each path's counts ("train", "train_fp32",
"train_cli" for phase 11; "host_io_u8", "host_io_i420" and
"serve_imitate" for phase 12). The seconds of each phase and the whole
script's wall time are printed before the record. The line before the
last is nvidia-smi's name and power limit, the one before it the kernels' JSON record (with each kernel's
bound: the larger of its bytes over 3.35 TB/s and its float operations
over 67 TFLOP/s, the H100 SXM's published peaks, both counted on this
run's inputs: 15 operations per (pixel, live candidate) pair whose
pixel lies in the face's integer pixel bbox, as ops.rasterizer's cull
computes it, and 23 more per pair inside its face; every input read
once, except the slots' face ids, read only where a slot is live, and
zbuffer_tiles' face table, of which only the rows a live slot names are
read; bound_ms_all_pairs charges the 15 to every live pair instead, the
count of the earlier records); the last line is the JSON status. Weights
are random (seeded); no checkpoint is read.
"""

import contextlib
import copy
import json
import subprocess
import sys
import time
from pathlib import Path

GEOM = dict(s=256, tile=16, span=2)
TILES = (8, 288, 3)          # the renderer's tile_params() at 256², nf 12,880
FIM_EXACT, W_TOL, T_TOL, PRED_TOL = 0, 2e-4, 1e-5, 1e-2
# DeepFill card vs CPU, float32 without TF32 on both: outputs in [-1, 1]
# after ~35 convolutions summed in another order
INPAINT_TOL = 1e-3
# share of the kept part's pixels where swap("body") and swap("all") differ
SWAP_DIFFER = 0.9
# HMR card vs CPU: float32 convs in another summation order (cuDNN's
# algorithms against oneDNN's) move the 2048-d ResNet features by ~1e-6
# of their largest magnitude; TF32's 10-bit mantissa moves them by
# ~1e-3, so FEAT_RTOL passes full float32 and fails TF32. θ itself moves
# little: the IEF adds the features through fc3 weights scaled by 5e-5
FEAT_RTOL, THETA_TOL = 1e-5, 1e-4
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12   # H100 SXM: fp32 non-tensor, HBM3
# one float32 tune step (phase 10) or train step (phase 11), card vs CPU
# with TF32 off: losses (float32 sums in another order); the gradient in
# the L2 norm per tensor and over all
# tensors (tests/test_torch_post_tune.py's bounds against JAX: this
# net's float32 gradient is ~2e-2 per tensor from its float64 one); the
# share of weights whose first Adam step (±lr) differs
TUNE_LOSS_RTOL, TUNE_GRAD_RTOL, TUNE_GRAD_ALL_RTOL, TUNE_STEP_FLIPS = (
    1e-4, 5e-2, 2e-2, 1e-2)
# float operations of the z-buffer contract: the inside test (three edge
# functions) for every (pixel, candidate) pair that can pass it, the
# pixel in the face's bbox; barycentric rows 12, renormalisation 5 and
# depth 6 only for the pairs that pass it
OPS_TEST, OPS_HIT = 15, 23
# phase 12. The card's JPEG decoder is nvJPEG: its IDCT rounds otherwise
# than libjpeg's integer one (the chroma upsampling and colour conversion
# after it are libjpeg's, bit for bit), so a decode may sit a level or two
# from OpenCV's, and on the committed fixtures one value in 19,008 sits
# three off: at most JPEG_OVER2_SHARE of the values more than 2 levels off,
# none more than JPEG_MAX_GAP. A quality-95 JPEG of a smooth frame stays
# above JPEG_PSNR_DB. The u8 stream normalises x / 127.5 - 1 on the card,
# the reference x / 255 * 2 - 1 on the host: at most U8_STREAM_SHARE of
# the values more than one level apart. The I420 ingest against inference
# on the same unpacked frames: STREAM_TOL. Memory may grow by at most
# SERVE_MEM_SLACK bytes over 10 requests (autograd graphs would pile up
# by gigabytes).
JPEG_MAX_GAP, JPEG_OVER2_SHARE, JPEG_PSNR_DB = 3, 1e-4, 35.0
U8_STREAM_SHARE, STREAM_TOL, SERVE_MEM_SLACK = 1e-3, 1e-5, 64 << 20
IO_FRAMES, IO_BATCH = 64, 16     # phase 12's frames on disk and batch


def lap(name):
    """Close the running phase's wall-clock lap and start ``name``'s
    (None closes the last one); LAPS holds the seconds of each."""
    now = time.perf_counter()
    if _LAP[1] is not None:
        LAPS[_LAP[1]] = round(now - _LAP[0], 1)
    _LAP[:] = [now, name]


LAPS, _LAP = {}, [0.0, None]


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAIL: {msg}")


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, reps):
    """Median time of one fn() over reps calls, CUDA events around each
    call: the card's time from the call's start, so it also counts the
    host's launch."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def device_ms(fn, calls=20):
    """Median device time of one launch of the z-buffer kernel that fn
    launches, over `calls` calls under torch.profiler: the kernel's own
    time, whatever the host does. None when the profiler sees no
    z-buffer kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = sorted(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "zbuffer" in e.name)
    return times[len(times) // 2] / 1e3 if times else None


def held_stream_ms(fn, calls=20):
    """Mean device time of one fn() from CUDA events: a sleep kernel holds
    the stream while the host queues the start event, `calls` calls of fn
    and the end event, so no host time falls between the two events. None
    when the stream ran dry before the host had queued them all, four
    times over with a longer sleep each time."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000          # ~10 ms at the H100's 1.98 GHz boost
    for _ in range(4):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        held = not a.query()
        b.synchronize()
        if held:
            return a.elapsed_time(b) / calls
        cycles *= 4
    return None


def kernel_ms(fn):
    """(ms, device_ms, how, held_ms) of a kernel wrapper: the median of a
    lone call (median_ms), as the earlier records timed the kernels; the
    device time of one launch, the median under torch.profiler
    (device_ms, asked twice) or, where the profiler sees no z-buffer
    kernel, held_ms; `how` names which; and held_ms, the mean device time
    of one call from CUDA events on a held stream (held_stream_ms),
    measured every time so that the two methods are compared in every
    run."""
    held = held_stream_ms(fn)
    check(held is not None, "the held stream ran dry")
    dev_ms, how = device_ms(fn), "profiler"
    if dev_ms is None:
        dev_ms = device_ms(fn)
    if dev_ms is None:
        dev_ms, how = held, "cuda_events_held_stream"
        print("kernel_ms: the profiler saw no z-buffer kernel twice; device "
              "time from CUDA events on a held stream", flush=True)
    return median_ms(fn, 50), dev_ms, how, held


def bound(ops, nbytes):
    """Least time the card could take: (ms, what bounds it)."""
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def zbuffer_ops(cr, rast, gather, m, b, s, tile):
    """Float operations these inputs need: OPS_TEST per (pixel, live
    candidate) pair with the pixel in the face's integer pixel bbox (as
    the rasterizer's cull computes it) plus OPS_HIT per pair inside its
    face; the earlier count, OPS_TEST for every live pair; and the live
    (tile, candidate) pairs: all, those with a pixel of the tile in the
    face's bbox, and those passing the inside test at a pixel of the
    tile. gather(c0, c1) gives candidates c0..c1 of every tile: (face
    verts (B, T, C, 9), live (B, T, C) bool)."""
    n_tiles, npx = (s // tile) ** 2, tile * tile
    xi, yi, xp, yp = cr._tile_pixels(s, tile, gather(0, 1)[0].device)
    chunk = max(1, cr._PLAIN_BLOCK // (b * n_tiles * npx))
    pairs = in_bbox = hits = 0
    cands = [0, 0, 0]
    for c0 in range(0, m, chunk):
        d, live = gather(c0, c0 + chunk)
        inside = cr._pair_weights(d, xi, yi, xp, yp, float(s))[0]
        live = live[:, :, None, :]
        x0, x1, y0, y1 = (v[:, :, None] for v in rast._pixel_bbox(
            d[..., 0::3], d[..., 1::3], s))
        box = (xi >= x0) & (xi <= x1) & (yi >= y0) & (yi <= y1)
        pairs += int(live.sum()) * npx
        in_bbox += int((box & live).sum())
        hits += int((inside & live).sum())
        for i, any_px in enumerate((live, box & live, inside & live)):
            cands[i] += int(any_px.any(2).sum())
    return (OPS_TEST * in_bbox + OPS_HIT * hits,
            OPS_TEST * pairs + OPS_HIT * hits, tuple(cands))


def bucket_ops(cr, rast, verts, starts, s, tile, span):
    pos = cr._tile_candidates(starts, s // tile, span)
    bidx = batch_index(verts)

    def gather(c0, c1):
        p = pos[..., c0:c1]
        return verts[bidx, p.clamp(min=0)], p >= 0
    return zbuffer_ops(cr, rast, gather, pos.shape[-1], verts.shape[0], s,
                       tile)[:2]


def tiles_work(cr, rast, packed, cand, valid, s, tile):
    """((float operations, all-pairs operations), bytes, bytes with the
    whole face table charged, the live (tile, slot) pairs: all, with a
    pixel of the tile in the face's bbox, with a hit) of the fixed-slot
    z-buffer on these slots. Bytes: valid read once, cand only where a
    slot is live, the 36 bytes of each face row that a live slot names
    read once (the earlier records charged the whole face table), fim and
    the weights written once."""
    import torch
    b, nf = packed.shape[0], packed.shape[1]
    live = (valid != 0) & (cand >= 0) & (cand < nf)
    used = slots_used(live)
    bidx = batch_index(packed)

    def gather(c0, c1):
        ids = cand[..., c0:c1].clamp(0, nf - 1).long()
        return packed[bidx, ids], live[..., c0:c1]
    *ops, cands = zbuffer_ops(cr, rast, gather, used, b, s, tile)
    named = torch.zeros((b, nf), dtype=torch.bool, device=packed.device)
    named[bidx.expand_as(cand)[live], cand[live].long()] = True
    rest = nbytes(valid) + 4 * int(live.sum()) + 16 * b * s * s
    return (ops, 36 * int(named.sum()) + rest, nbytes(packed) + rest,
            cands)


def batch_index(t):
    import torch
    return torch.arange(t.shape[0], device=t.device)[:, None, None]


def slots_used(live):
    """1 + the last slot that is live in any tile (0 when none is)."""
    import torch
    used = torch.nonzero(live.reshape(-1, live.shape[-1]).any(0))
    return int(used.max()) + 1 if used.numel() else 0


def reset_counts(cr):
    for k in cr.KERNELS:
        k.launches = 0


def read_counts(cr):
    return {k.__name__: k.launches for k in cr.KERNELS}


def body_scene(assets, params, n, dev, rast, smpl_ops):
    """n poses as the JAX package's bench makes them: theta0 (cam 0.9)
    plus N(0, 0.05) pose noise; returns (thetas, face verts on dev)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    theta0 = np.zeros(85, np.float32)
    theta0[0] = 0.9
    thetas = np.tile(theta0, (n, 1))
    thetas[:, 3:75] += rng.normal(0, 0.05, (n, 72)).astype(np.float32)
    d = smpl_ops.get_details(params, torch.from_numpy(thetas).to(dev),
                             assets.parents)
    return thetas, rast.project_to_raster_space(d["verts"], d["cam"],
                                                params.faces)


def random_scene(dev):
    """Random scatter with one oversized front face, and the same scene
    behind the far plane."""
    import numpy as np
    import torch
    rng = np.random.default_rng(33)
    nf = 300
    xy = rng.uniform(-0.9, 0.9, (1, nf, 1, 2)) \
        + rng.uniform(-0.2, 0.2, (1, nf, 3, 2))
    z = rng.uniform(1.5, 3.0, (1, nf, 3, 1))
    fv = np.concatenate([xy, z], -1).astype(np.float32)
    fv[0, 0, :, :2] = [[-0.95, -0.95], [0.95, -0.9], [0.0, 0.95]]
    fv[0, 0, :, 2] = 1.2
    far = fv.copy()
    far[..., 2] = 30.0
    return torch.from_numpy(fv).to(dev), torch.from_numpy(far).to(dev)


def dense_scene(dev):
    """3,000 random faces of a few pixels: at cap 4 most 8-px tiles
    overflow."""
    import numpy as np
    import torch
    rng = np.random.default_rng(9)
    xy = rng.uniform(-0.8, 0.8, (2, 3000, 1, 2)) \
        + rng.uniform(-0.03, 0.03, (2, 3000, 3, 2))
    z = rng.uniform(1.5, 3.0, (2, 3000, 3, 1))
    fv = np.concatenate([xy, z], -1).astype(np.float32)
    return torch.from_numpy(fv).to(dev)


def source_image(s):
    """A smooth stand-in for a source photo: low-frequency colour waves
    in [-1, 1]. (Per-pixel noise would turn the ulp-level geometry gap
    between two devices into large warp differences; photos are smooth
    at the pixel scale.)"""
    import numpy as np
    y, x = np.mgrid[0:s, 0:s].astype(np.float32) / s
    tau = 2.0 * np.pi
    img = np.stack([np.sin(tau * (1.5 * x + 0.5 * y)),
                    np.cos(tau * (0.7 * x - 1.2 * y)),
                    np.sin(tau * (2.0 * x * y + 0.3))], -1)
    return (0.8 * img).astype(np.float32)


def kernel_vs_plain(cr, rast, fv, src_f2pts):
    """Both kernels and both twins on one scene; returns (fim coverage,
    max weight error, max flow error, inputs)."""
    import torch
    s, tile, span = GEOM["s"], GEOM["tile"], GEOM["span"]
    b, nf = fv.shape[0], fv.shape[1]
    verts, fid, starts, order = rast._bucket_sort(fv, s, tile, span,
                                                  rast.DEFAULT_FAR)
    src = src_f2pts.reshape(src_f2pts.shape[0], nf, 6).expand(b, nf, 6)
    srcxy = torch.gather(src, 1, order[..., None].expand(b, nf, 6))
    srcxy = srcxy.contiguous()
    geo = (s, tile, span, rast.DEFAULT_NEAR, rast.DEFAULT_FAR)
    fim_k, wim_k = cr.zbuffer_bucket_rows(verts, fid, starts, *geo)
    fimf_k, t_k = cr.zbuffer_bucket_flow(verts, fid, srcxy, starts, *geo)
    torch.cuda.synchronize()
    fim_p, wim_p = cr.zbuffer_bucket_rows_plain(verts, fid, starts, *geo)
    fimf_p, t_p = cr.zbuffer_bucket_flow_plain(verts, fid, srcxy, starts,
                                               *geo)
    n_bad = int((fim_k != fim_p).sum()) + int((fimf_k != fimf_p).sum())
    check(n_bad == FIM_EXACT, f"kernel fim differs from plain at {n_bad} px")
    check(bool((t_k[fim_k < 0] == -2.0).all()), "flow background != -2")
    check(bool((wim_k[fim_k < 0] == 0.0).all()), "weight background != 0")
    w_err = float((wim_k - wim_p).abs().max())
    t_err = float((t_k - t_p).abs().max())
    check(w_err <= W_TOL, f"weights differ by {w_err}")
    check(t_err <= T_TOL, f"flow differs by {t_err}")
    cov = float((fim_k >= 0).float().mean())
    return cov, w_err, t_err, (verts, fid, srcxy, starts, geo), fim_k


def tiles_vs_plain(cr, rast, fv, cap, tile=TILES[0], span=TILES[2]):
    """zbuffer_tiles and its twin on one scene's slots; returns (kernel
    fim and wim, max weight error, coverage, slot inputs)."""
    slots = rast._tiled_candidates(fv, GEOM["s"], tile, cap, span,
                                   rast.DEFAULT_FAR)
    return slots_vs_plain(cr, rast, slots, tile)


def tie_slots(dev, tile, slots, batch):
    """The tie scene's slots at 256² on the card (scenes.tie_scene)."""
    import torch
    from impersonator_tpu_torch.scenes import tie_scene
    return tuple(torch.from_numpy(a).to(dev) for a in tie_scene(
        GEOM["s"], tile, slots=slots, batch=batch))


def slots_vs_plain(cr, rast, slots, tile):
    """zbuffer_tiles and its twin on given slots (packed, cand, valid);
    returns as tiles_vs_plain."""
    import torch
    packed, cand, valid = slots
    s = GEOM["s"]
    geo = (s, tile, rast.DEFAULT_NEAR, rast.DEFAULT_FAR)
    fim_k, wim_k = cr.zbuffer_tiles(packed, cand, valid, *geo)
    torch.cuda.synchronize()
    fim_p, wim_p = cr.zbuffer_tiles_plain(packed, cand, valid, *geo)
    n_bad = int((fim_k != fim_p).sum())
    check(n_bad == FIM_EXACT, f"tiles fim differs from plain at {n_bad} px")
    check(bool((wim_k[fim_k < 0] == 0.0).all()), "tiles background != 0")
    w_err = float((wim_k - wim_p).abs().max())
    check(w_err <= W_TOL, f"tiles weights differ by {w_err}")
    cov = float((fim_k >= 0).float().mean())
    return (fim_k, wim_k), w_err, cov, (packed, cand, valid, geo)


def bounds_of(ops, nbytes_):
    """(bound ms, what bounds it, all-pairs bound ms) of (ops, all-pairs
    ops) and bytes."""
    return bound(ops[0], nbytes_) + (bound(ops[1], nbytes_)[0],)


def time_tiles(cr, rast, packed, cand, valid, geo):
    """(ms, device_ms, how, held_ms) of zbuffer_tiles (kernel_ms), the
    median ms of its twin on these slots, the kernel's bounds (ms, what bounds it,
    all-pairs ms, ms with the whole face table charged) and the live
    (tile, slot) pairs (tiles_work)."""
    ms = kernel_ms(lambda: cr.zbuffer_tiles(packed, cand, valid, *geo))
    plain_ms = median_ms(lambda: cr.zbuffer_tiles_plain(packed, cand, valid,
                                                        *geo), 5)
    ops, nbytes_, nbytes_table, cands = tiles_work(
        cr, rast, packed, cand, valid, geo[0], geo[1])
    return ms, plain_ms, (bounds_of(ops, nbytes_)
                          + (bound(ops[0], nbytes_table)[0],)), cands


def route_split(fn, calls=10):
    """Mean device time of one fn() under torch.profiler, split into the
    z-buffer kernels and everything else (ms, ms); None when the profiler
    sees no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kern = rest = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            if "zbuffer" in e.name:
                kern += us
            else:
                rest += us
    if kern + rest == 0.0:
        return None
    return rest / calls / 1e3, kern / calls / 1e3


def profile_request(fn, out_path):
    """One call of fn under torch.profiler (CPU + CUDA activity): returns
    (wall ms, summed kernel ms, [(kernel ms, launches, name)] largest
    first); writes the full key_averages table to out_path. Summed
    kernel time is None when the profiler saw no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    out_path.parent.mkdir(exist_ok=True)
    out_path.write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=60))
    return wall, (sum(r[0] for r in rows) if rows else None), rows


def not_measured(x, spec):
    """x formatted by spec, or 'not measured' for None (the profiler saw
    no device activity)."""
    return "not measured" if x is None else format(x, spec)


def kernel_share(kern, wall):
    """The summed kernel time of a profiled call and the device's idle
    share of its wall time; 'not measured' where the profiler saw no
    device activity."""
    if kern is None:
        return "summed kernel time not measured (the profiler saw no device "\
               "activity)"
    return (f"summed kernel time {kern:.2f} ms, device idle "
            f"{1 - kern / wall:.3f} of the wall")


def target_images(n, seed):
    """n stand-ins for 224² target crops in [-1, 1]: the smooth source
    pattern at random phases plus a little noise, so HMR's θ differs
    from frame to frame."""
    import numpy as np
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:224, 0:224].astype(np.float32) / 224
    ph = rng.uniform(0, 2 * np.pi, (n, 3, 1, 1)).astype(np.float32)
    img = np.stack([np.sin(6.0 * x + ph[:, 0]), np.cos(4.0 * y + ph[:, 1]),
                    np.sin(5.0 * x * y + ph[:, 2])], -1)
    img = 0.8 * img + rng.normal(0, 0.05, img.shape).astype(np.float32)
    return np.clip(img, -1, 1).astype(np.float32)


def to_device(state, dev):
    """A personalised state (tensors, and the feature lists) on dev."""
    import torch

    def move(v):
        if torch.is_tensor(v):
            return v.to(dev)
        if isinstance(v, (list, tuple)):
            return type(v)(move(x) for x in v)
        return v
    return {k: move(v) for k, v in state.items()}


def requests(fn, n=3):
    """(host seconds of each of n calls of fn, each ending in a
    synchronise; the last call's output)."""
    import torch
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, out


def view_coverage(viewer, vwr, euler_to_matrix, yaws):
    """Share of the pixels the source body covers at each yaw (the fim of
    the viewer's rotated mesh under the source camera)."""
    import torch
    st = viewer.src_info
    rots = torch.stack([euler_to_matrix([0.0, y, 0.0],
                                        device=st["verts"].device)
                        for y in yaws])
    mesh = vwr.rotate_verts(st["verts"], rots, torch.zeros_like(rots[:, 0]))
    fim, _ = viewer.renderer.render_flow(st["cam"].expand(len(yaws), 3),
                                         mesh, st["p2verts"])
    return (fim >= 0).float().mean((1, 2)).tolist()


def warp_ms(dev, s, batch=16):
    """Device ms (CUDA events, median of 20) of the bf16 warps of one
    imitation step at batch 16: the source image (3 channels at s²) and
    the generator's LWB warps of the batch-1 source features (128, 256
    and 512 channels at s/2, s/4, s/8; the 6 residual blocks' 3,072 at
    s/8), through ops.sampler.grid_sample_nchw (the JAX arithmetic in
    bf16) and through one F.grid_sample in float32 with its casts (the
    library call). Returns (port ms, library ms) summed over the warps."""
    import torch
    import torch.nn.functional as F
    from impersonator_tpu_torch.ops.sampler import grid_sample_nchw
    g = torch.Generator(device=dev).manual_seed(0)
    port = lib = 0.0
    for c, size in ((3, s), (128, s // 2), (256, s // 4), (512, s // 8),
                    (3072, s // 8)):
        x = torch.rand((1, c, size, size), generator=g, device=dev) \
            .to(torch.bfloat16)
        grid = torch.rand((batch, size, size, 2), generator=g,
                          device=dev) * 2.2 - 1.1
        port += median_ms(lambda: grid_sample_nchw(x, grid), 20)
        lib += median_ms(lambda: F.grid_sample(
            x.float().expand(batch, -1, -1, -1), grid, mode="bilinear",
            padding_mode="zeros", align_corners=True).to(x.dtype), 20)
    return port, lib


def tensor_gaps(a, b):
    """(largest per-tensor, all-tensor) |a - b| / |b| in the L2 norm over
    two dicts of tensors with the same keys."""
    import torch
    per = max(float((a[k] - b[k]).norm() / b[k].norm()) for k in b)
    cat = [torch.cat([d[k].flatten() for k in b]) for d in (a, b)]
    return per, float((cat[0] - cat[1]).norm() / cat[1].norm())


def tune_step_card_vs_cpu(imi, pt, face_cpu, assets, theta, dev):
    """One float32 tune step (TF32 off) on the CPU and on the card from
    the same master weights and the CPU's pair batch (128², conv_dim 64, 6
    res blocks, batch 2, face loss on, the pairs' structure anchors
    swapped): (loss gaps, gradient gaps, share of weights whose step
    differs, CPU seconds)."""
    import torch
    from impersonator_tpu_torch.config import TestConfig
    t0 = time.perf_counter()
    cfg = TestConfig(image_size=128, repeat_num=6, compute_dtype="float32")
    im_c = imi.Imitator(cfg, assets=assets, device="cpu")
    im_c.personalize(source_image(128), src_smpl=theta)
    batch = pt.build_meta_pairs(im_c, pt.default_prior_poses(
        im_c.src_info["theta"], n=2))
    batch["init_preds"] = batch["init_preds"].flip(0)
    bg = im_c.src_info["bg"].expand(2, -1, -1, -1)
    im_g = imi.Imitator(cfg, assets=assets, device=dev,
                        nets=imi.ImitatorNets(copy.deepcopy(
                            im_c.nets.generator)))
    w0 = {k: v.detach().clone() for k, v in
          im_c.nets.generator.named_parameters()}
    out = []
    for im, face, d in ((im_c, face_cpu, "cpu"),
                        (im_g, copy.deepcopy(face_cpu).to(dev), dev)):
        step = pt.make_tune_step(im, pt.tune_optimizer(im.nets.generator,
                                                       2e-4), face)
        metrics = step({k: v.to(d) for k, v in batch.items()}, bg.to(d))
        gen = im.nets.generator
        out.append(({k: float(v) for k, v in metrics.items()},
                    {k: p.grad.cpu() for k, p in gen.named_parameters()
                     if p.grad is not None},
                    {k: p.detach().cpu() for k, p in
                     gen.named_parameters()}))
    cpu_s = time.perf_counter() - t0
    (m_c, g_c, w_c), (m_g, g_g, w_g) = out
    loss_gap = max(abs(m_g[k] - m_c[k]) / abs(m_c[k]) for k in m_c)
    moved = sum(int((w_c[k] != w0[k]).sum()) for k in g_c)
    flips = sum(int(((w_g[k] - w_c[k]).abs() > 1e-4).sum()) for k in g_c)
    return m_c, loss_gap, tensor_gaps(g_g, g_c), flips / moved, cpu_s


def post_tune_phase(cr, imi, swapper, assets, cfg, src_img, thetas,
                    req_thetas, dev, tag):
    """Phase 10 (module docstring); returns the launch counts of the two
    post-tune paths."""
    import numpy as np
    import torch
    from impersonator_tpu_torch.models.facenet import Sphere20a, init_facenet
    from impersonator_tpu_torch.tasks import post_tune as pt
    face = init_facenet(Sphere20a(), torch.Generator().manual_seed(0))
    face.eval().requires_grad_(False)
    imit = imi.Imitator(cfg, assets=assets, device=dev)
    imit.personalize(src_img, src_smpl=thetas[0])
    before = imit.inference_by_smpls(req_thetas[:16], batch=16)
    priors = pt.default_prior_poses(imit.src_info["theta"], n=8)
    face_g = copy.deepcopy(face).to(dev)
    reset_counts(cr)
    secs, hist = [], []
    for _ in range(2):
        t, m = requests(lambda: pt.adaptive_personalize(
            imit, priors, epochs=5, batch_size=4, face=face_g), 1)
        secs.append(t[0])
        hist.append(m)
    launches = read_counts(cr)
    check(all(m["n_steps"] == 10 for m in hist), f"steps {hist}")
    check(all(np.isfinite([m[k] for k in ("cyc", "str", "fid", "msk",
                                          "total")]).all()
              and np.isfinite(m["cyc_history"]).all() for m in hist),
          f"non-finite post-tune losses {hist}")
    check(hist[0]["fid"] > 0, "the face loss did not run")
    check(launches["zbuffer_bucket_rows"] == 4 and
          launches["zbuffer_bucket_flow"] == 2,
          f"post-tune launches {launches}")
    after = imit.inference_by_smpls(req_thetas[:16], batch=16)
    diff = float((after - before).abs().max())
    check(bool(torch.isfinite(after).all()) and diff > 1e-4,
          f"inference after post-tune moved by {diff}")
    # ms per tune step: a minibatch of 4 pairs, CUDA events
    batch = pt.build_meta_pairs(imit, priors[:4])
    bg = imit.src_info["bg"].expand(4, -1, -1, -1)
    step = pt.make_tune_step(imit, pt.tune_optimizer(imit.nets.generator,
                                                     2e-4), face_g)
    step_ms = median_ms(lambda: step(batch, bg), 10)
    print(f"post-tune (imitator): adaptive_personalize, 8 priors, batch 4, 5 "
          f"epochs ({hist[0]['n_steps']} Adam steps, face loss on), "
          f"{secs[0]:.3f} s per subject on the first call, {secs[1]:.3f} s "
          f"on the second; {step_ms:.3f} ms per tune step at batch 4 "
          f"(median of 10, CUDA events); launches over both calls "
          f"{launches}; {cfg.image_size}^2, conv_dim 64, {cfg.repeat_num} "
          f"res blocks, float32 master, bf16 inference {tag}", flush=True)
    for i, m in enumerate(hist):
        print(f"post-tune (imitator) call {i + 1}: cyc_history "
              f"{[round(x, 5) for x in m['cyc_history']]}, last step "
              f"{ {k: round(m[k], 5) for k in ('cyc', 'str', 'fid', 'msk', 'total')} }")
    print(f"post-tune (imitator): inference of 16 poses after the tune "
          f"differs from before it by up to {diff:.4f}", flush=True)

    swap_before = swapper.swap(target_part="body")
    reset_counts(cr)
    sw_secs, sw_m = [], []
    for _ in range(2):
        t, m = requests(lambda: pt.post_tune_swapper(swapper, iters=50), 1)
        sw_secs.append(t[0])
        sw_m.append(m)
    sw_launches = read_counts(cr)
    check(all(np.isfinite(list(m.values())).all() for m in sw_m),
          f"non-finite swapper tune losses {sw_m}")
    check(sw_launches["zbuffer_bucket_rows"] == 8 and
          sw_launches["zbuffer_bucket_flow"] == 4,
          f"swapper post-tune launches {sw_launches}")
    swap_after = swapper.swap(target_part="body")
    sw_diff = float((swap_after - swap_before).abs().max())
    check(bool(torch.isfinite(swap_after).all()) and sw_diff > 1e-4,
          f"swap after the tune moved by {sw_diff}")
    print(f"post-tune (swapper): post_tune_swapper, 50 iterations on the "
          f"2-pair batch, {sw_secs[0]:.3f} s per subject on the first call, "
          f"{sw_secs[1]:.3f} s on the second, last step "
          f"{ {k: round(v, 5) for k, v in sw_m[1].items()} }; launches over "
          f"both calls {sw_launches}; swap('body') after the tune differs by "
          f"up to {sw_diff:.4f} {tag}", flush=True)

    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    m_c, loss_gap, (g_per, g_all), flips, cpu_s = tune_step_card_vs_cpu(
        imi, pt, face, assets, thetas[0], dev)
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    print(f"post-tune step card vs CPU, float32, TF32 off (128^2, conv_dim "
          f"64, 6 res blocks, batch 2, face loss on; CPU side {cpu_s:.1f} "
          f"s): losses {m_c}, max relative gap {loss_gap:.3e} (bound "
          f"{TUNE_LOSS_RTOL}); gradient L2 gap per tensor {g_per:.3e} "
          f"(bound {TUNE_GRAD_RTOL}), over all {g_all:.3e} (bound "
          f"{TUNE_GRAD_ALL_RTOL}); weights whose Adam step differs "
          f"{flips:.3e} of those moved (bound {TUNE_STEP_FLIPS})",
          flush=True)
    check(loss_gap <= TUNE_LOSS_RTOL, f"tune losses card vs CPU {loss_gap}")
    check(g_per <= TUNE_GRAD_RTOL and g_all <= TUNE_GRAD_ALL_RTOL,
          f"tune gradient card vs CPU {g_per}, {g_all}")
    check(flips <= TUNE_STEP_FLIPS, f"tune step card vs CPU: {flips}")
    return launches, sw_launches


def train_batch(s, bs, seed):
    """A train batch of the JAX bench's train point (bench.py:427-436):
    images U(-1, 1) (bs, 2, s, s, 3), θs with cam scale 0.9 and N(0,
    0.03) poses (bs, 2, 85); numpy, NHWC, as the datasets give it."""
    import numpy as np
    rng = np.random.default_rng(seed)
    thetas = np.zeros((bs, 2, 85), np.float32)
    thetas[..., 0] = 0.9
    thetas[..., 3:75] = rng.normal(0, 0.03, (bs, 2, 72))
    images = rng.uniform(-1, 1, (bs, 2, s, s, 3)).astype(np.float32)
    return {"images": images, "smpls": thetas}


@contextlib.contextmanager
def plain_twins(cr):
    """The bucket kernels' wrappers swapped for their plain twins inside
    the block (the rasterizer calls them through the module)."""
    saved = cr.zbuffer_bucket_rows, cr.zbuffer_bucket_flow
    cr.zbuffer_bucket_rows = cr.zbuffer_bucket_rows_plain
    cr.zbuffer_bucket_flow = cr.zbuffer_bucket_flow_plain
    try:
        yield
    finally:
        cr.zbuffer_bucket_rows, cr.zbuffer_bucket_flow = saved


def train_twins(cr, smpl_ops, tt, trainer, batch):
    """The train step's raster on its own bodies, kernels against plain
    twins: the source's render_fim_wim (rows) and the target's
    render_flow from the source's points (flow), then the whole
    body_recovery_flow. Returns (max |dw|, max |dT|, body coverage,
    body_recovery_flow's largest gap over its outputs)."""
    import torch
    r, params = trainer.renderer, trainer.smpl_params
    parents = trainer.assets.parents
    smpls, images = batch["smpls"], batch["images"]
    src = smpl_ops.get_details(params, smpls[:, 0], parents)
    ref = smpl_ops.get_details(params, smpls[:, 1], parents)

    def raster():
        f2v, fim, wim = r.render_fim_wim(src["cam"], src["verts"])
        fim_f, t = r.render_flow(ref["cam"], ref["verts"],
                                 r.f2pts_from_f2verts(f2v))
        out = tt.body_recovery_flow(r, params, parents, images[:, 0],
                                    images[:, 1], smpls[:, 0], smpls[:, 1])
        torch.cuda.synchronize()
        return fim, wim, fim_f, t, out

    fim_k, wim_k, fimf_k, t_k, out_k = raster()
    with plain_twins(cr):
        fim_p, wim_p, fimf_p, t_p, out_p = raster()
    n_bad = int((fim_k != fim_p).sum()) + int((fimf_k != fimf_p).sum())
    check(n_bad == FIM_EXACT, f"train raster fim differs at {n_bad} px")
    w_err = float((wim_k - wim_p).abs().max())
    t_err = float((t_k - t_p).abs().max())
    check(w_err <= W_TOL and t_err <= T_TOL,
          f"train raster |dw| {w_err}, |dT| {t_err}")
    for k in ("src_crop_mask", "tsf_crop_mask"):
        check(torch.equal(out_k[k], out_p[k]), f"body_recovery_flow {k}")
    gap = max(float((out_k[k] - out_p[k]).abs().max())
              for k in out_k if out_k[k] is not None)
    return w_err, t_err, float((fim_k >= 0).float().mean()), gap


def grad_gaps(a, b, zero=()):
    """tensor_gaps over the tensors of b but ``zero``: the biases of
    convs feeding an instance norm, whose gradient is 0 in exact
    arithmetic, are held below 1e-5 of b's whole norm on both sides
    instead, and must be exactly the tensors of b that small.
    Returns (per-tensor, all-tensor, names left out)."""
    import torch
    norm = float(torch.cat([v.flatten() for v in b.values()]).norm())
    noise = [k for k, v in b.items() if float(v.norm()) <= 1e-5 * norm]
    check(sorted(noise) == sorted(zero),
          f"gradients below 1e-5 of the norm {noise}, expected {zero}")
    for k in noise:
        check(float(a[k].norm()) <= 1e-5 * norm, f"gradient of {k}")
    per, _ = tensor_gaps({k: a[k] for k in b if k not in noise},
                         {k: b[k] for k in b if k not in noise})
    return per, tensor_gaps(a, b)[1], noise


def train_step_card_vs_cpu(tt, assets, dev):
    """One float32 train step (TF32 off) on the CPU and on the card from
    the same weights, fresh Adam states and the CPU's raster products
    (128², conv_dim 64, 6 res blocks, a 4-layer PatchGAN, batch 2, VGG
    and face losses on): (CPU losses, loss gap, G gaps, D gaps, share of
    weights whose Adam step differs, CPU seconds)."""
    import torch
    from impersonator_tpu_torch.config import TrainConfig
    from impersonator_tpu_torch.data.loader import stage_batch
    t0 = time.perf_counter()
    cfg = TrainConfig(image_size=128, batch_size=2, repeat_num=6)
    tr_c = tt.build_trainer(cfg, assets, device="cpu")
    tr_g = tt.build_trainer(cfg, assets, device=dev)
    st_c = tr_c.init_state()
    st_g = tr_g.init_state(copy.deepcopy(st_c.generator),
                           copy.deepcopy(st_c.discriminator))
    b = stage_batch(train_batch(128, 2, 5), "cpu")
    src, tsf = b["images"][:, 0], b["images"][:, 1]
    inputs = tt.body_recovery_flow(tr_c.renderer, tr_c.smpl_params,
                                   assets.parents, src, tsf,
                                   b["smpls"][:, 0], b["smpls"][:, 1])

    def named(st):
        return [(f"{n}.{k}", p) for n, net in (("G", st.generator),
                                               ("D", st.discriminator))
                for k, p in net.named_parameters()]
    w0 = {k: p.detach().clone() for k, p in named(st_c)}
    out = []
    for tr, st, d in ((tr_c, st_c, "cpu"), (tr_g, st_g, dev)):
        inp = {k: None if v is None else v.to(d) for k, v in inputs.items()}
        st, m = tt.make_update(tr)(st, inp, src.to(d), tsf.to(d))
        out.append(({k: float(v) for k, v in m.items()},
                    {k: p.grad.cpu() for k, p in named(st)},
                    {k: p.detach().cpu() for k, p in named(st)}))
    cpu_s = time.perf_counter() - t0
    (m_c, g_c, w_c), (m_g, g_g, w_g) = out
    loss_gap = max(abs(m_g[k] - m_c[k]) / abs(m_c[k]) for k in m_c
                   if m_c[k] != 0.0)
    # D at 4 layers: conv, leaky, (conv, norm, leaky) x 4, head conv; the
    # convs before the norms are model.{2,5,8,11}
    zero = {"G": (), "D": tuple(f"D.model.{i}.bias" for i in (2, 5, 8, 11))}
    gaps = {n: grad_gaps({k: v for k, v in g_g.items() if k[0] == n},
                         {k: v for k, v in g_c.items() if k[0] == n},
                         zero[n])
            for n in "GD"}
    moved = sum(int((w_c[k] != w0[k]).sum()) for k in w0)
    flips = sum(int(((w_g[k] - w_c[k]).abs() > 1e-4).sum()) for k in w0)
    return m_c, loss_gap, gaps, flips / moved, cpu_s


def cli_phase(cr, tag):
    """cli.train.main in-process on the card at 256², batch 16, the
    synthetic dataset (64 items: 4 steps an epoch): 1 epoch, then a
    second call that resumes from the latest checkpoint (--load_epoch -1)
    for epoch 2. Returns the launch counts over both calls."""
    import tempfile
    from impersonator_tpu_torch.cli import train as cli
    with tempfile.TemporaryDirectory() as tmp:
        base = ["--dataset_mode", "synthetic", "--image_size",
                str(GEOM["s"]), "--batch_size", "16", "--nepochs_no_decay",
                "1", "--checkpoints_dir", tmp, "--name", "smoke"]
        reset_counts(cr)
        t0 = time.perf_counter()
        cli.main(base + ["--nepochs_decay", "0"])
        t1 = time.perf_counter()
        exp = Path(tmp) / "smoke"
        want = {f"{k}_epoch_1_id_{l}.pth" for k in ("net", "opt")
                for l in "GD"}
        check(want <= set(p.name for p in exp.iterdir()),
              f"epoch 1 files {sorted(p.name for p in exp.iterdir())}")
        state = cli.main(base + ["--nepochs_decay", "1", "--load_epoch",
                                 "-1"])
        t2 = time.perf_counter()
        launches = read_counts(cr)
        names = set(p.name for p in exp.iterdir())
        check({w.replace("_1_", "_2_") for w in want} <= names,
              f"epoch 2 files {sorted(names)}")
        p = next(state.generator.parameters())
        n_adam = int(state.g_opt.state[p]["step"])
        check(n_adam == 8, f"Adam steps after the resume {n_adam}")
    check(launches["zbuffer_bucket_rows"] == 8 and
          launches["zbuffer_bucket_flow"] == 8,
          f"cli.train launches {launches}")
    print(f"cli.train: epoch 1 (4 steps, batch 16, {GEOM['s']}^2, float32) "
          f"{t1 - t0:.2f} s with set-up, checkpoint files written; resumed "
          f"with --load_epoch -1 at epoch 1, epoch 2 (4 steps) "
          f"{t2 - t1:.2f} s, Adam steps {n_adam}, launches over both calls "
          f"{launches} {tag}", flush=True)
    return launches


def train_phase(cr, smpl_ops, assets, dev, tag):
    """Phase 11 (module docstring); returns ({path: launch counts},
    max |dw|, max |dT| of the kernels against their twins on the step's
    bodies)."""
    import numpy as np
    import torch
    from impersonator_tpu_torch.config import TrainConfig
    from impersonator_tpu_torch.data.loader import stage_batch
    from impersonator_tpu_torch.tasks import trainer as tt
    t_phase = time.perf_counter()
    s, bs = GEOM["s"], 16
    batch = stage_batch(train_batch(s, bs, 3), dev)
    by_path, twins = {}, None
    for dtype in ("bfloat16", "float32"):
        base = torch.cuda.memory_allocated()   # the earlier phases' tensors
        cfg = TrainConfig(image_size=s, batch_size=bs, repeat_num=6,
                          use_vgg=True, use_style=False, use_face=True,
                          train_dtype=dtype)
        tr = tt.build_trainer(cfg, assets, device=dev)
        st = tr.init_state()
        if twins is None:
            twins = train_twins(cr, smpl_ops, tt, tr, batch)
        nets = (("G", st.generator), ("D", st.discriminator))
        w0 = {f"{n}.{k}": p.detach().clone() for n, net in nets
              for k, p in net.named_parameters()}
        step = tt.make_train_step(tr, train_d=True)
        step_g = tt.make_train_step(tr, train_d=False)
        ev = tt.make_train_step(tr, eval_only=True)
        vis_fn = tt.make_visuals_fn(tr)
        st, _ = step(st, batch)                    # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(cr)
        times, metrics = [], []
        for fn in [step] * 5 + [step_g]:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            st, m = fn(st, batch)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
            metrics.append({k: float(v) for k, v in m.items()})
        m_eval = {k: float(v) for k, v in ev(st, batch).items()}
        visuals = vis_fn(st, batch)
        torch.cuda.synchronize()
        launches = read_counts(cr)
        peak = torch.cuda.max_memory_allocated() - base
        by_path["train" if dtype == "bfloat16" else "train_fp32"] = launches
        check(launches["zbuffer_bucket_rows"] == 8 and
              launches["zbuffer_bucket_flow"] == 8,
              f"train launches {launches} (1 each a step, 8 steps)")
        check(all(np.isfinite(list(m.values())).all()
                  for m in metrics + [m_eval]), f"non-finite losses "
              f"{metrics + [m_eval]}")
        check("d_loss" not in metrics[-1] and "d_loss" in metrics[0],
              "the G-only step's metrics")
        check(sorted(visuals) == ["1_real_img", "2_input_tsf", "3_fake_src",
                                  "4_fake_tsf", "5_fake_bg", "6_real_tsf",
                                  "7_fake_mask"]
              and all(tuple(v.shape) == (bs, s, s, 3) and
                      bool(torch.isfinite(v).all())
                      for v in visuals.values()), "train visuals")
        moved = {n: [float((p.detach() != w0[f"{n}.{k}"]).float().mean())
                     for k, p in net.named_parameters()] for n, net in nets}
        check(min(moved["G"]) > 0.5 and float(np.mean(moved["D"])) > 0.5,
              f"weights moved {moved}")
        master = all(p.dtype == torch.float32 and
                     opt.state[p]["exp_avg"].dtype == torch.float32
                     for (_, net), opt in zip(nets, (st.g_opt, st.d_opt))
                     for p in net.parameters())
        check(master, f"{dtype}: the master or Adam's moments left float32")
        ms = sorted(times[:5])[2]
        print(f"train ({dtype}): {ms:.3f} ms per G+D step (median of 5, "
              f"CUDA events; {[round(t, 3) for t in times[:5]]}), "
              f"{bs / ms * 1e3:.2f} samples/s, G-only step "
              f"{times[5]:.3f} ms; peak memory {peak / 2**30:.2f} GiB (the "
              f"trainer's: nets, Adam, activations; above the "
              f"{base / 2**30:.2f} GiB the earlier phases hold); "
              f"launches over 5 G+D, 1 G-only, 1 eval, 1 visuals "
              f"{launches}; batch 16, {s}^2, conv_dim 64, 6 res blocks, "
              f"PatchGAN 4 layers instance, VGG19 + Sphere20a on, float32 "
              f"master {tag}", flush=True)
        print(f"train ({dtype}): losses step 1 "
              f"{ {k: round(v, 5) for k, v in metrics[0].items()} }, step "
              f"5 { {k: round(v, 5) for k, v in metrics[4].items()} }, eval "
              f"{ {k: round(v, 5) for k, v in m_eval.items()} }; share of "
              f"each net's weights moved: G min {min(moved['G']):.4f}, D "
              f"mean {float(np.mean(moved['D'])):.4f}", flush=True)
        if dtype == "bfloat16":
            wall, kern, rows = profile_request(
                lambda: step(st, batch),
                Path("chiprun_out") / "profile_train_step.txt")
            zb = sum(r[0] for r in rows if "zbuffer" in r[2])
            print(f"profile, one bf16 train step at batch 16: wall "
                  f"{wall:.2f} ms (profiler on), {kernel_share(kern, wall)};"
                  f" the z-buffers {zb:.3f} ms "
                  f"({not_measured(kern and zb / kern, '.4f')} of the "
                  f"kernel time) {tag}", flush=True)
            for k_ms, n, name in rows[:12]:
                print(f"profile train: {k_ms:9.3f} ms {n:5d} x {name[:90]}")
        del st, tr, w0
        torch.cuda.empty_cache()
    w_err, t_err, cov, gap = twins
    print(f"train raster vs plain twins on the step's 16 bodies ({s}^2): "
          f"fim equal, coverage {cov:.4f}, max |dw| {w_err}, max |dT| "
          f"{t_err}; body_recovery_flow's largest output gap {gap}",
          flush=True)

    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    m_c, loss_gap, gaps, flips, cpu_s = train_step_card_vs_cpu(tt, assets,
                                                                dev)
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    print(f"train step card vs CPU, float32, TF32 off (128^2, conv_dim 64, "
          f"6 res blocks, batch 2, VGG + face on; CPU side {cpu_s:.1f} s): "
          f"losses { {k: round(v, 5) for k, v in m_c.items()} }, max "
          f"relative gap {loss_gap:.3e} (bound {TUNE_LOSS_RTOL}); gradient "
          f"L2 gap per tensor / over all: G {gaps['G'][0]:.3e} / "
          f"{gaps['G'][1]:.3e}, D {gaps['D'][0]:.3e} / {gaps['D'][1]:.3e} "
          f"(bounds {TUNE_GRAD_RTOL} / {TUNE_GRAD_ALL_RTOL}; D's "
          f"{gaps['D'][2]} left out per tensor: 0 in exact arithmetic); "
          f"weights whose Adam step differs {flips:.3e} of those moved "
          f"(bound {TUNE_STEP_FLIPS})", flush=True)
    check(loss_gap <= TUNE_LOSS_RTOL, f"train losses card vs CPU {loss_gap}")
    for n in "GD":
        check(gaps[n][0] <= TUNE_GRAD_RTOL and
              gaps[n][1] <= TUNE_GRAD_ALL_RTOL,
              f"{n} gradient card vs CPU {gaps[n]}")
    check(flips <= TUNE_STEP_FLIPS, f"train step card vs CPU: {flips}")
    by_path["train_cli"] = cli_phase(cr, tag)
    print(f"train phase: {time.perf_counter() - t_phase:.1f} s of wall time",
          flush=True)
    return by_path, w_err, t_err


def smooth_frames(n, s, seed):
    """n seeded smooth uint8 frames (s, s, 3): sine patterns at random
    phases, the shape of target_images without its noise."""
    import numpy as np
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:s, 0:s].astype(np.float32) / s
    ph = rng.uniform(0, 2 * np.pi, (n, 3, 1, 1)).astype(np.float32)
    img = np.stack([np.sin(6.0 * x + ph[:, 0]), np.cos(4.0 * y + ph[:, 1]),
                    np.sin(5.0 * x * y + ph[:, 2])], -1)
    return np.round((img * 0.45 + 0.5) * 255).astype(np.uint8)


def psnr_db(a, b):
    import numpy as np
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def codec_checks(native, dev, tmp, tag):
    """Phase 12's codec checks: 64 seeded 256² frames through the card's
    encoder and decoder (PSNR), the committed fixtures' decodes and
    resizes. Returns (frame paths, encode ms per frame)."""
    import numpy as np
    import torch
    s = GEOM["s"]
    frames = smooth_frames(IO_FRAMES, s, seed=3)
    fdir = tmp / "frames"
    fdir.mkdir()
    paths, enc_ms, worst = [], [], np.inf
    for i, f in enumerate(frames):
        t = torch.from_numpy(f).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data = native.encode_jpeg(t, device=dev)
        enc_ms.append(1e3 * (time.perf_counter() - t0))
        p = fdir / f"{i:03d}.jpg"
        p.write_bytes(data)
        paths.append(str(p))
        worst = min(worst, psnr_db(native.decode(data, dev), f))
    check(worst > JPEG_PSNR_DB, f"JPEG round trip PSNR {worst:.2f} dB")
    fix = Path(__file__).resolve().parent / "impersonator_tpu_torch" \
        / "testdata" / "codec"
    dec = np.load(fix / "cv2_decode.npz")
    res = np.load(fix / "jax_resize_u8.npz")
    gaps = {}
    for name in dec.files:
        got = native.read_image(str(fix / name), dev)
        diff = np.abs(got.astype(int) - dec[name].astype(int))
        gaps[name] = (int(diff.max()), float((diff > 2).mean()))
        if name.endswith(".png"):
            check(diff.max() == 0, f"PNG decode of {name} off by "
                                   f"{diff.max()}")
        else:
            check(diff.max() <= JPEG_MAX_GAP and
                  (diff > 2).mean() <= JPEG_OVER2_SHARE,
                  f"JPEG decode of {name}: max {diff.max()}, share over 2 "
                  f"{(diff > 2).mean()}")
        for sz in (48, 224):
            want = res[f"{name}@{sz}"]
            check(np.array_equal(native.resize_u8(dec[name], sz, dev), want),
                  f"resize_u8 of {name} at {sz} differs from JAX's native")
            if name.endswith(".png"):
                check(np.array_equal(native.decode_resize_u8(
                    str(fix / name), sz, dev), want),
                    f"decode_resize_u8 of {name} at {sz}")
    print(f"codec ({native.load(dev).kind} build): {IO_FRAMES} frames "
          f"{s}^2 encoded at quality 95, 4:2:0, {np.median(enc_ms):.3f} ms a "
          f"frame (median, host clock around a call that ends in a "
          f"synchronise), decoded back at >= {worst:.2f} dB PSNR; fixtures "
          f"against their OpenCV decodes (max gap, share over 2 levels) "
          f"{gaps}; resize_u8 equal to JAX's native on all four {tag}",
          flush=True)
    return paths, float(np.median(enc_ms))


def stream_checks(cr, imi, assets, src_img, thetas, paths, native, cs, dev,
                  tag):
    """Phase 12's stream checks on a float32 task: u8 and I420 readback
    against the float preds, the colour transforms card vs CPU, and the
    I420 ingest. Returns the u8 frames at 224 (numpy) and the launch
    counts of one streamed request."""
    import numpy as np
    import torch
    from impersonator_tpu_torch.config import TestConfig
    s = GEOM["s"]
    cfg32 = TestConfig(image_size=s, repeat_num=6, compute_dtype="float32")
    imit = imi.Imitator(cfg32, assets=assets, device=dev)
    imit.personalize(src_img, src_smpl=thetas[0])
    fr_u8 = np.stack([native.decode_resize_u8(p, 224, dev) for p in paths])
    ref = imit.inference(fr_u8.astype(np.float32) / 255.0 * 2.0 - 1.0,
                         batch=IO_BATCH)
    reset_counts(cr)
    got_u8 = imit.inference_from_paths(paths, batch=IO_BATCH,
                                       as_uint8=True)
    launches = read_counts(cr)
    check(launches["zbuffer_bucket_flow"] == IO_FRAMES // IO_BATCH,
          f"streamed request flow launches {launches}")
    want = torch.round((ref + 1.0) * 127.5).clamp(0, 255).cpu().numpy()
    diff = np.abs(got_u8.astype(int) - want.astype(int))
    share = float((diff > 1).mean())
    check(got_u8.shape == (IO_FRAMES, s, s, 3) and got_u8.dtype == np.uint8,
          f"u8 stream {got_u8.shape} {got_u8.dtype}")
    check(share <= U8_STREAM_SHARE, f"u8 stream: {share} of the values "
                                    f"more than 1 level off")
    preds = imit.inference_from_paths(paths, batch=IO_BATCH)
    got_i420 = imit.inference_from_paths(paths, batch=IO_BATCH,
                                         as_i420=True)
    gap_i420 = int(np.abs(got_i420.astype(int) - cs.rgb_to_i420(preds)
                          .cpu().numpy().astype(int)).max())
    check(gap_i420 <= 1, f"I420 stream off by {gap_i420} levels")
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(-1.05, 1.05, (16, s, s, 3))
                         .astype(np.float32))
    packed = cs.rgb_to_i420(x)
    check(torch.equal(cs.rgb_to_i420(x.to(dev)).cpu(), packed),
          "rgb_to_i420 on the card differs from the CPU")
    rgb_gap = float((cs.i420_to_rgb_device(packed.to(dev)).cpu()
                     - cs.i420_to_rgb_device(packed)).abs().max())
    check(rgb_gap <= 1e-6, f"i420_to_rgb_device card vs CPU {rgb_gap}")
    ingest = cs.rgb_to_i420(torch.from_numpy(fr_u8).float() / 127.5 - 1.0) \
        .numpy()
    got = imit._stream_infer((ingest[i:i + IO_BATCH]
                              for i in range(0, IO_FRAMES, IO_BATCH)),
                             imit.regress_smpl_i420, None, "smooth", False,
                             False)
    want = imit.inference(cs.i420_to_rgb_device(
        torch.from_numpy(ingest).to(dev)), batch=IO_BATCH)
    ingest_gap = float((got - want).abs().max())
    check(ingest_gap <= STREAM_TOL, f"I420 ingest stream {ingest_gap}")
    print(f"streams (float32 task, {IO_FRAMES} frames, batch {IO_BATCH}): u8 readback off "
          f"round((inference + 1) * 127.5) by > 1 level on {share:.2e} of "
          f"the values (max {diff.max()}); I420 readback max {gap_i420} "
          f"level(s) from rgb_to_i420 of the float preds; rgb_to_i420 card "
          f"= CPU, i420_to_rgb_device card vs CPU {rgb_gap:.2e}; I420 ingest "
          f"vs inference {ingest_gap:.2e}; launches {launches} {tag}",
          flush=True)
    del imit
    torch.cuda.empty_cache()
    return fr_u8, launches


def host_io_timings(cr, imit, paths, fr_u8, native, cs, dev, tag):
    """Phase 12's host-IO leg (bf16 Imitator, batch 16, 64 JPEG frames):
    frames/s of the u8 and I420 streams against inference on frames
    pre-staged on the card, the split, and one profiled request. Returns
    {path: launch counts}."""
    import numpy as np
    import torch
    mode = {"u8": dict(as_uint8=True), "i420": dict(as_i420=True)}
    imit.inference_from_paths(paths, batch=IO_BATCH, as_uint8=True)  # warm-up
    fps, launches = {}, {}
    for k, kw in mode.items():
        reset_counts(cr)
        times, _ = requests(lambda: imit.inference_from_paths(
            paths, batch=IO_BATCH, **kw))
        launches[f"host_io_{k}"] = read_counts(cr)
        check(launches[f"host_io_{k}"]["zbuffer_bucket_flow"]
              == 3 * (IO_FRAMES // IO_BATCH),
              f"{k} stream launches {launches[f'host_io_{k}']}")
        fps[k] = (IO_FRAMES / sorted(times)[1], times)
    staged = torch.from_numpy(fr_u8).to(dev).float() / 127.5 - 1.0
    ceil_t, _ = requests(lambda: imit.inference(staged, batch=IO_BATCH))
    fps["staged"] = (IO_FRAMES / sorted(ceil_t)[1], ceil_t)
    # the split
    t0 = time.perf_counter()
    ahead = 2 * IO_BATCH
    with native.NativeImageLoader(224, threads=3, capacity=ahead, u8=True,
                                  device=dev) as ring:
        for p in paths[:ahead]:
            ring.submit(p)
        for i in range(IO_FRAMES):
            ring.next()
            if i + ahead < IO_FRAMES:
                ring.submit(paths[i + ahead])
    ring_ms = 1e3 * (time.perf_counter() - t0) / IO_FRAMES
    pinned = torch.from_numpy(fr_u8[:IO_BATCH]).pin_memory()
    h2d = median_ms(lambda: pinned.to(dev, non_blocking=True), 20)
    xb = pinned.to(dev)

    def step():
        th = imit.regress_smpl_u8(xb)
        return imit._imitate(imit.src_info, th, th[0:1, 0:3], "smooth")
    step_ms = median_ms(step, 10)
    pred = step()
    d2h = {}
    for k, pk in (("u8", cs.rgb_to_u8(pred)), ("i420", cs.rgb_to_i420(pred))):
        host = torch.empty(pk.shape, dtype=pk.dtype, pin_memory=True)
        d2h[k] = median_ms(lambda: host.copy_(pk, non_blocking=True), 20)
    wall, kern, rows = profile_request(
        lambda: imit.inference_from_paths(paths, batch=IO_BATCH,
                                          as_uint8=True),
        Path("chiprun_out") / "profile_host_io.txt")
    print(f"host-IO leg (bf16 Imitator with HMR, {IO_FRAMES} JPEG frames "
          f"{GEOM['s']}^2, batch {IO_BATCH}, median of 3): inference_from_paths as_uint8 "
          f"{fps['u8'][0]:.1f} frames/s, as_i420 {fps['i420'][0]:.1f} "
          f"frames/s, against inference on the same frames pre-staged on "
          f"the card {fps['staged'][0]:.1f} frames/s (request seconds "
          f"{ {k: [round(t, 4) for t in v[1]] for k, v in fps.items()} }) "
          f"{tag}", flush=True)
    print(f"host-IO split: decode + resize {ring_ms:.3f} ms a frame (the "
          f"ring alone, 3 threads, {IO_FRAMES} frames); u8 H2D {h2d:.4f} ms "
          f"a batch of {IO_BATCH} (pinned, CUDA events); HMR + imitation {step_ms:.3f} ms a "
          f"batch (CUDA events); D2H u8 {d2h['u8']:.4f} ms, I420 "
          f"{d2h['i420']:.4f} ms a batch (pinned); one streamed u8 request "
          f"under the profiler: wall {wall:.2f} ms, {kernel_share(kern, wall)}"
          f" {tag}", flush=True)
    for ms, n, name in rows[:8]:
        print(f"profile host-IO: {ms:9.3f} ms {n:5d} x {name[:90]}")
    return launches


def serve_checks(cr, cfg, paths, req_thetas, src_img, native, dev, enc_ms,
                 tag):
    """Phase 12's HTTP checks: make_server in this process on 127.0.0.1
    (an ephemeral port) over the service's own bf16 Imitator (at cfg, on
    the config's assets, as `python -m ...cli.serve` builds it). Returns
    the launch counts of one /imitate request of 64 θs."""
    import base64
    import http.client
    import threading
    import numpy as np
    import torch
    from impersonator_tpu_torch.cli import serve
    from impersonator_tpu_torch.utils.video import have_ffmpeg
    s = GEOM["s"]
    service = serve.ImitatorService(cfg, batch=IO_BATCH, device=dev)
    server = serve.make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def call(method, path, body=None, headers=None):
        c = http.client.HTTPConnection("127.0.0.1", server.server_port,
                                       timeout=600)
        c.request(method, path, body=body, headers=headers or {})
        r = c.getresponse()
        out = r.status, r.read()
        c.close()
        return out

    try:
        code, body = call("GET", "/healthz")
        check(code == 200 and json.loads(body)["backend"] == dev.type,
              f"/healthz {code} {body[:200]}")
        src_u8 = np.round((src_img + 1.0) * 127.5).clip(0, 255) \
            .astype(np.uint8)
        code, body = call("POST", "/personalize",
                          native.encode_jpeg(src_u8, device=dev))
        check(code == 200, f"/personalize {code} {body[:200]}")
        imitate = json.dumps({"smpls": req_thetas.tolist()})
        reset_counts(cr)
        code, body = call("POST", "/imitate", imitate)
        launches = read_counts(cr)
        check(code == 200, f"/imitate {code} {body[:200]}")
        check(launches["zbuffer_bucket_flow"] == len(req_thetas) // IO_BATCH,
              f"/imitate launches {launches}")
        frames = json.loads(body)["frames"]
        check(len(frames) == len(req_thetas) and all(
            native.decode(base64.b64decode(f), dev).shape == (s, s, 3)
            for f in frames), f"/imitate frames do not decode to {s}^2")
        b64 = [base64.b64encode(Path(p).read_bytes()).decode("ascii")
               for p in paths[:IO_BATCH]]
        frames_body = json.dumps({"frames": b64})
        code, body = call("POST", "/imitate_frames", frames_body)
        check(code == 200 and len(json.loads(body)["frames"]) == IO_BATCH,
              f"/imitate_frames {code} {body[:200]}")
        lat, locked = {}, {}
        for name, path, req in (("imitate", "/imitate", imitate),
                                ("imitate_frames", "/imitate_frames",
                                 frames_body)):
            ts, inner = [], []
            for _ in range(3):
                t0 = time.perf_counter()
                code, body = call("POST", path, req)
                ts.append(time.perf_counter() - t0)
                check(code == 200, f"{path} {code}")
                inner.append(json.loads(body)["seconds"])
            lat[name], locked[name] = ts, sorted(inner)[1]
        code, _ = call("POST", "/imitate", b"{not json")
        check(code == 400, f"a malformed body got {code}")
        code, _ = call("POST", "/imitate", imitate)
        check(code == 200, f"the request after a 400 got {code}")
        code, body = call("POST", "/imitate_video", imitate)
        if not have_ffmpeg():
            check(code == 400 and b"ffmpeg" in body,
                  f"/imitate_video without ffmpeg got {code}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem = []
        for _ in range(10):
            check(call("POST", "/imitate", imitate)[0] == 200, "/imitate")
            mem.append((torch.cuda.memory_allocated(),
                        torch.cuda.max_memory_allocated()))
        grow = mem[-1][0] - mem[0][0]
        check(grow <= SERVE_MEM_SLACK and
              mem[-1][1] <= mem[0][1] + SERVE_MEM_SLACK,
              f"memory grew over 10 requests: {mem[0]} -> {mem[-1]}")
        hmr_worker, hmr_fresh = fresh_thread_cost(service, dev)
    finally:
        server.shutdown()
        thread.join(timeout=30)
        server.server_close()
        service.close()
    med = {k: sorted(v)[1] for k, v in lat.items()}
    print(f"serve over localhost (bf16 Imitator, batch {IO_BATCH}, median "
          f"of 3): /imitate of {len(req_thetas)} thetas "
          f"{1e3 * med['imitate']:.1f} ms (a JPEG each back), "
          f"/imitate_frames of {IO_BATCH} JPEG frames "
          f"{1e3 * med['imitate_frames']:.1f} ms (of which the model and "
          f"the JPEG encode on the service's worker: "
          f"{1e3 * locked['imitate']:.0f} / "
          f"{1e3 * locked['imitate_frames']:.0f} ms); HMR at batch "
          f"{IO_BATCH} on the worker {hmr_worker:.2f} ms, on a fresh "
          f"thread {hmr_fresh:.2f} ms (median of 3); JPEG encode ({s}^2) "
          f"{enc_ms:.3f} ms a frame; a malformed body 400 and the "
          f"next 200; /imitate_video {code} (ffmpeg "
          f"{'present' if have_ffmpeg() else 'absent'}); memory allocated "
          f"after 10 /imitate requests {mem[-1][0] / 2**30:.3f} GiB (first "
          f"{mem[0][0] / 2**30:.3f}), peak {mem[-1][1] / 2**30:.3f} GiB "
          f"(first {mem[0][1] / 2**30:.3f}); launches {launches} {tag}",
          flush=True)
    return launches


def fresh_thread_cost(service, dev):
    """Median ms of HMR on a batch of IO_BATCH 224² frames on the
    service's worker thread and on a fresh thread each call (as a model
    call on an HTTP handler thread would run): PyTorch keeps cuDNN's
    execution plans per thread."""
    import threading
    import torch
    x = torch.zeros(IO_BATCH, 224, 224, 3, device=dev)

    def hmr():
        with torch.no_grad():
            service.imitator.regress_smpl(x)
        torch.cuda.synchronize()

    def fresh():
        t = threading.Thread(target=hmr)
        t.start()
        t.join()

    out = []
    for call in (lambda: service._run(hmr), fresh):
        call()
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            call()
            ts.append(1e3 * (time.perf_counter() - t0))
        out.append(sorted(ts)[1])
    return out


def cli_checks(native, src_img, paths, dev, tmp, tag):
    """Phase 12's CLI checks: each entry point as a subprocess with
    --device cuda at 256²; run_imitator alone first (timed), then the
    others together."""
    import numpy as np
    root = Path(__file__).resolve().parent
    from impersonator_tpu_torch.utils.visualizer import write_png
    src = tmp / "src.png"
    write_png(str(src), np.round((src_img + 1.0) * 127.5).clip(0, 255)
              .astype(np.uint8))
    fdir = str(Path(paths[0]).parent)

    def cmd(mod, out, *extra):
        return [sys.executable, "-m", f"impersonator_tpu_torch.cli.{mod}",
                *extra, "--device", dev.type, "--image_size",
                str(GEOM["s"]), "--checkpoints_dir", str(tmp / "ckpt"),
                "--output_dir", str(tmp / out)]

    def wait(proc, what):
        out, err = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"{what} exited {proc.returncode}:\n"
                                    f"{out[-2000:]}\n{err[-3000:]}")

    t0 = time.perf_counter()
    wait(subprocess.Popen(cmd("run_imitator", "imit", "--src_path",
                              str(src), "--tgt_path", fdir, "--name", "a"),
                          cwd=root, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True),
         "run_imitator")
    imit_s = time.perf_counter() - t0
    jobs = {
        "run_imitator --i420": cmd("run_imitator", "imit420", "--src_path",
                                   str(src), "--tgt_path", fdir, "--i420",
                                   "--name", "b"),
        "run_swap": cmd("run_swap", "swap", "--src_path", str(src),
                        "--tgt_path", paths[0], "--name", "c"),
        "run_view": cmd("run_view", "view", "--src_path", str(src),
                        "--name", "d"),
        "demos imitator": cmd("demos", "demo", "imitator", "--name", "e")}
    t1 = time.perf_counter()
    procs = {k: subprocess.Popen(v, cwd=root, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, v in jobs.items()}
    for k, p in procs.items():
        wait(p, k)
    rest_s = time.perf_counter() - t1
    for out in ("imit", "imit420"):
        preds = sorted((tmp / out).glob("pred_*"))
        check(len(preds) == IO_FRAMES and all(
            native.read_image(str(p), dev).shape == (GEOM["s"], GEOM["s"], 3)
            for p in preds), f"{out}: {len(preds)} decodable pred files")
    check((tmp / "swap" / "swap_result.png").exists(), "no swap_result.png")
    check(len(list((tmp / "view").glob("view_*.png"))) == 16,
          "run_view did not write 16 views")
    print(f"CLIs (subprocesses, --device {dev.type}, {GEOM['s']}^2): "
          f"run_imitator on {IO_FRAMES} frames {imit_s:.2f} s of wall time (first call: start-up, "
          f"build check, nets, personalize, the frames, files); run_imitator "
          f"--i420, run_swap, run_view (16 views) and demos imitator "
          f"together {rest_s:.2f} s; {IO_FRAMES} decodable pred files each "
          f"{tag}",
          flush=True)


def host_io_phase(cr, imi, imit_h, assets, cfg, src_img, thetas, req_thetas,
                  dev, tag):
    """Phase 12 (module docstring); returns {path: launch counts}."""
    import tempfile
    from impersonator_tpu_torch.data import native
    from impersonator_tpu_torch.ops import colorspace as cs
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        paths, enc_ms = codec_checks(native, dev, tmp, tag)
        fr_u8, stream_launches = stream_checks(
            cr, imi, assets, src_img, thetas, paths, native, cs, dev, tag)
        launches = host_io_timings(cr, imit_h, paths, fr_u8, native, cs,
                                   dev, tag)
        launches["serve_imitate"] = serve_checks(
            cr, cfg, paths, req_thetas, src_img, native, dev, enc_ms, tag)
        cli_checks(native, src_img, paths, dev, tmp, tag)
    return launches


def main():
    import numpy as np
    import torch
    t_start = time.perf_counter()

    # -- phase 1: the card -------------------------------------------------
    lap("1")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    from impersonator_tpu_torch.assets import bench_assets, synthetic_assets
    from impersonator_tpu_torch.config import TestConfig
    from impersonator_tpu_torch.ops import cuda_raster as cr
    from impersonator_tpu_torch.ops import rasterizer as rast
    from impersonator_tpu_torch.ops import smpl as smpl_ops
    from impersonator_tpu_torch.tasks import imitator as imi
    from impersonator_tpu_torch.tasks.renderer import SMPLRenderer
    from impersonator_tpu_torch.scenes import degenerate_scene

    dev = torch.device("cuda")
    smi = gpu_line()
    tag = f"[{smi}]"
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; nvidia-smi: {smi}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- phase 2: build ----------------------------------------------------
    lap("2")
    from concurrent.futures import ThreadPoolExecutor
    from impersonator_tpu_torch.data import native
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:     # the codec builds meanwhile
        codec = pool.submit(native.load, dev)
        log = cr.build()
        build_s = time.perf_counter() - t0
        codec_kind = codec.result().kind
    codec_s = time.perf_counter() - t0
    for line in log.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill")):
            print("ptxas:", line.strip())
    print(f"build: {build_s:.2f} s (nvcc + load); the {codec_kind} image "
          f"codec (nvJPEG) built beside it, ready at {codec_s:.2f} s {tag}",
          flush=True)

    # -- phase 3: kernels vs plain twins -----------------------------------
    lap("3")
    assets = bench_assets()
    params = smpl_ops.SMPLParams.from_assets(assets, dev)
    renderer = SMPLRenderer.create(assets, dev, image_size=GEOM["s"])
    check(renderer._bucket_config() == (GEOM["tile"], GEOM["span"]),
          f"renderer gate {renderer._bucket_config()}")
    thetas, fv = body_scene(assets, params, 16, dev, rast, smpl_ops)
    src_f2pts = renderer.f2pts_from_f2verts(fv[0:1])
    cov, w_err, t_err, body_in, fim_rows = kernel_vs_plain(cr, rast, fv,
                                                           src_f2pts)
    check(cov > 0.02, f"body covers {cov:.4f} of the pixels")
    print(f"kernels vs plain, 16 bodies 256^2 ({assets.nf} faces): fim "
          f"equal, coverage {cov:.4f}, max |dw| {w_err}, max |dT| {t_err}")
    fv_rand, fv_far = random_scene(dev)
    src_rand = fv_rand[..., :2]
    cov_r, w_r, t_r, _, _ = kernel_vs_plain(cr, rast, fv_rand, src_rand)
    check(cov_r > 0.3, f"random scene covers {cov_r}")
    cov_f, w_f, t_f, _, _ = kernel_vs_plain(cr, rast, fv_far, src_rand)
    check(cov_f == 0.0, f"far scene covers {cov_f}")
    fv_deg = torch.from_numpy(degenerate_scene(GEOM["s"])).to(dev)
    cov_d, w_d, t_d, _, _ = kernel_vs_plain(cr, rast, fv_deg,
                                            fv_deg[0:1, ..., :2])
    check(cov_d > 0.0, f"degenerate scene covers {cov_d}")
    print(f"kernels vs plain, random+oversized: fim equal, max |dw| {w_r}, "
          f"max |dT| {t_r}; behind far: empty; degenerate ({fv_deg.shape[1]} "
          f"faces): fim equal, coverage {cov_d:.4f}, max |dw| {w_d}, max "
          f"|dT| {t_d}")
    errs = {"zbuffer_bucket_rows": max(w_err, w_r, w_f, w_d),
            "zbuffer_bucket_flow": max(t_err, t_r, t_f, t_d)}

    verts, fid, srcxy, starts, geo = body_in
    masks, pos = cr.bucket_warp_masks_plain(verts, starts, GEOM["s"],
                                            GEOM["tile"], GEOM["span"])
    n_warps = (GEOM["tile"] // cr.WARP_W) * (GEOM["tile"] // cr.WARP_H)
    kept = sum(int(((masks >> w) & 1).sum()) for w in range(n_warps))
    keep_share = kept / (int((pos >= 0).sum()) * n_warps)
    print(f"warp cull on the 16 bodies: keeps {kept} of "
          f"{int((pos >= 0).sum()) * n_warps} (warp, face) pairs, "
          f"{keep_share:.4f}", flush=True)
    timing = {
        "zbuffer_bucket_rows": (
            kernel_ms(lambda: cr.zbuffer_bucket_rows(verts, fid, starts,
                                                     *geo)),
            median_ms(lambda: cr.zbuffer_bucket_rows_plain(
                verts, fid, starts, *geo), 5)),
        "zbuffer_bucket_flow": (
            kernel_ms(lambda: cr.zbuffer_bucket_flow(
                verts, fid, srcxy, starts, *geo)),
            median_ms(lambda: cr.zbuffer_bucket_flow_plain(
                verts, fid, srcxy, starts, *geo), 5)),
    }
    # bounds: the operations these inputs need (OPS_TEST per pair of the
    # tiles' candidate ranges whose pixel is in the face's bbox, OPS_HIT
    # per pair inside its face; and the all-pairs count), each input read
    # once, each output written once
    ops = bucket_ops(cr, rast, verts, starts, GEOM["s"], GEOM["tile"],
                     GEOM["span"])
    n_px = verts.shape[0] * GEOM["s"] ** 2
    bounds = {
        "zbuffer_bucket_rows": bounds_of(ops, nbytes(verts, fid, starts)
                                         + 16 * n_px),
        "zbuffer_bucket_flow": bounds_of(ops, nbytes(verts, fid, srcxy,
                                                     starts) + 12 * n_px),
    }

    # -- phase 3b: zbuffer_tiles vs its plain twin -------------------------
    lap("3b")
    check(renderer.tile_params() == TILES,
          f"renderer tile_params {renderer.tile_params()}")
    tile8, cap, tspan = TILES
    (fim_tk, _), err_tb, cov_tb, tiles_in = tiles_vs_plain(cr, rast, fv,
                                                           cap)
    n_diff = int((fim_tk != fim_rows).sum())
    check(n_diff == 0, f"tiles fim differs from rows fim at {n_diff} px")
    stats = {k: v.tolist() for k, v in renderer.tile_stats(fv).items()}
    check(max(stats["dropped_pairs"]) == 0, f"tile stats {stats}")
    print(f"zbuffer_tiles vs plain, 16 bodies 256^2 (tile {tile8}, cap "
          f"{cap}, span {tspan}): fim equal, equal to zbuffer_bucket_rows' "
          f"fim, coverage {cov_tb:.4f}, max |dw| {err_tb}; tile_stats "
          f"max_tile_occupancy {stats['max_tile_occupancy']}, "
          f"dropped_pairs {stats['dropped_pairs']}, oversized_faces "
          f"{stats['oversized_faces']}")
    _, err_tr, cov_tr, _ = tiles_vs_plain(cr, rast, fv_rand, cap)
    fv_dense = dense_scene(dev)
    _, err_tz, cov_tz, _ = tiles_vs_plain(cr, rast, fv_dense, 4)
    over = {k: v.tolist() for k, v in rast.raster_tile_stats(
        fv_dense, GEOM["s"], rast.DEFAULT_FAR, tile8, 4, tspan).items()}
    check(min(over["dropped_pairs"]) > 0 and cov_tz > 0.05,
          f"cap 4: coverage {cov_tz}, stats {over}")
    _, err_tf, cov_tf, _ = tiles_vs_plain(cr, rast, fv_far, cap)
    check(cov_tr > 0.3 and cov_tf == 0.0,
          f"tiles coverage random {cov_tr}, far {cov_tf}")
    print(f"zbuffer_tiles vs plain, random+oversized: fim equal, max |dw| "
          f"{err_tr}; 3,000 small faces at cap 4: fim equal, max |dw| "
          f"{err_tz}, dropped_pairs {over['dropped_pairs']}; behind far: "
          f"empty", flush=True)
    n_slots = 16 + cap
    _, err_tt, cov_tt, _ = slots_vs_plain(cr, rast, tie_slots(
        dev, tile8, n_slots, 4), tile8)
    check(cov_tt > 0.05, f"tie scene coverage {cov_tt}")
    print(f"zbuffer_tiles vs plain, tie scene (4 items, {n_slots} slots, "
          f"240 coplanar faces at one depth in random slot order): fim "
          f"equal, max |dw| {err_tt}, coverage {cov_tt:.4f}", flush=True)
    errs["zbuffer_tiles"] = max(err_tb, err_tr, err_tz, err_tf, err_tt)
    for name, ((ms, dev_ms, dev_by, held), plain_ms) in timing.items():
        print(f"{name}: kernel {ms:.4f} ms a lone call, {dev_ms:.4f} ms of "
              f"device time per launch ({dev_by}; {held:.4f} ms from CUDA events on a "
              f"held stream), plain {plain_ms:.4f} ms, bound {bounds[name][0]:.4f} ms "
              f"({bounds[name][1]}), all-pairs bound {bounds[name][2]:.4f} "
              f"ms, batch 16 at 256^2 {tag}", flush=True)
    (ms_b, dev_b, *_), plain_b, bound_b, _ = time_tiles(cr, rast, *tiles_in)
    print(f"zbuffer_tiles on the 16 bodies ({assets.nf} faces, not its "
          f"path): kernel {ms_b:.4f} ms a lone call, {dev_b:.4f} ms of "
          f"device time per launch, "
          f"plain {plain_b:.4f} ms, bound {bound_b[0]:.4f} ms ({bound_b[1]}),"
          f" all-pairs bound {bound_b[2]:.4f} ms, bound with the whole face "
          f"table charged {bound_b[3]:.4f} ms, batch 16 at 256^2 {tag}", flush=True)

    # -- phase 3c: the renderer's tiled route (nf > 60,000) ----------------
    lap("3c")
    big = synthetic_assets(rings=24, segments=60)
    r_big = SMPLRenderer.create(big, dev, image_size=GEOM["s"])
    check(r_big.raster_route() == "tiled",
          f"{big.nf} faces route {r_big.raster_route()}")
    p_big = smpl_ops.SMPLParams.from_assets(big, dev)
    d_big = smpl_ops.get_details(p_big, torch.from_numpy(thetas).to(dev),
                                 big.parents)
    reset_counts(cr)
    f2v_big, fim_big, wim_big = r_big.render_fim_wim(d_big["cam"],
                                                     d_big["verts"])
    torch.cuda.synchronize()
    tiled_launches = read_counts(cr)
    check(tiled_launches["zbuffer_tiles"] >= 1,
          f"tiled route launches {tiled_launches}")
    tb, tcap, tsp = r_big.tile_params()
    (fim_bk, wim_bk), err_big, cov_big, big_in = tiles_vs_plain(
        cr, rast, f2v_big, tcap, tb, tsp)
    check(torch.equal(fim_big, fim_bk) and torch.equal(wim_big, wim_bk),
          "tiled route differs from zbuffer_tiles on its slots")
    _, err_bt, cov_bt, _ = slots_vs_plain(cr, rast, tie_slots(
        dev, tb, 16 + tcap, 16), tb)
    check(cov_bt > 0.05, f"tie scene coverage {cov_bt}")
    errs["zbuffer_tiles"] = max(errs["zbuffer_tiles"], err_big, err_bt)
    ms_t, plain_t, bound_t, cands = time_tiles(cr, rast, *big_in)
    timing["zbuffer_tiles"], bounds["zbuffer_tiles"] = (ms_t, plain_t), bound_t
    check(cov_big > 0.02, f"63k-face bodies cover {cov_big}")
    st_big = {k: v.tolist() for k, v in r_big.tile_stats(f2v_big).items()}
    print(f"tiled route: {big.nf} faces, 16 poses, tile_params "
          f"{r_big.tile_params()}, launches {tiled_launches}, fim equal to "
          f"the twin's, max |dw| {err_big}, coverage {cov_big:.4f}; "
          f"tile_stats max_tile_occupancy {st_big['max_tile_occupancy']}, "
          f"dropped_pairs {st_big['dropped_pairs']}; tie scene (16 items, "
          f"{16 + tcap} slots): fim equal, max |dw| {err_bt}", flush=True)
    print(f"zbuffer_tiles on its path ({big.nf} faces): kernel "
          f"{ms_t[0]:.4f} ms a lone call, {ms_t[1]:.4f} ms of device time "
          f"per launch ({ms_t[2]}; {ms_t[3]:.4f} ms from CUDA events on a held "
          f"stream), plain "
          f"{plain_t:.4f} ms, bound {bound_t[0]:.4f} ms ({bound_t[1]}), "
          f"all-pairs bound {bound_t[2]:.4f} ms, bound with the whole face "
          f"table charged {bound_t[3]:.4f} ms, batch 16 at 256^2 {tag}", flush=True)
    print(f"zbuffer_tiles' live (tile, slot) pairs on its path: {cands[0]}; "
          f"with a pixel of the tile in the face's pixel bbox {cands[1]} "
          f"({cands[1] / cands[0]:.4f}); passing the inside test at a pixel "
          f"of the tile {cands[2]} ({cands[2] / cands[0]:.4f}): an exact "
          f"tile cull keeps at least the latter", flush=True)
    split = route_split(lambda: rast.rasterize_fim_wim_tiled(
        f2v_big, GEOM["s"], rast.DEFAULT_NEAR, rast.DEFAULT_FAR, tb, tcap,
        tsp))
    if split is None:
        print("tiled route split: the profiler saw no device activity; not "
              "measured")
    else:
        print(f"tiled route, device time of one rasterize_fim_wim_tiled "
              f"(mean of 10): slot build (_tiled_candidates: sort, "
              f"searchsorted, gathers) {split[0]:.4f} ms, zbuffer_tiles "
              f"{split[1]:.4f} ms, the kernel "
              f"{split[1] / (split[0] + split[1]):.3f} of the route, batch "
              f"16 at 256^2 {tag}", flush=True)

    # -- phase 4: the slice at full width ----------------------------------
    lap("4")
    cfg = TestConfig(image_size=GEOM["s"], repeat_num=6)
    master = imi.build_nets(cfg, assets)
    master_sd = {k: v.clone() for k, v in
                 master.generator.state_dict().items()}
    imit = imi.Imitator(cfg, assets=assets, nets=master, device=dev)
    rng = np.random.default_rng(0)
    src_img = source_image(GEOM["s"])
    req_thetas = np.tile(thetas[0], (64, 1))
    req_thetas[:, 3:75] += rng.normal(0, 0.05, (64, 72)).astype(np.float32)
    reset_counts(cr)
    (pers_s,), src_info = requests(lambda: imit.personalize(
        src_img, src_smpl=thetas[0]), 1)
    rows_after_pers = cr.zbuffer_bucket_rows.launches
    req_s, preds = requests(lambda: imit.inference_by_smpls(req_thetas,
                                                            batch=16))
    launches = read_counts(cr)
    check(rows_after_pers >= 1, "personalize launched no rows kernel")
    check(launches["zbuffer_bucket_flow"] == 3 * 4,
          f"flow kernel launches {launches['zbuffer_bucket_flow']} != 12")
    check(tuple(preds.shape) == (64, GEOM["s"], GEOM["s"], 3),
          f"preds shape {tuple(preds.shape)}")
    check(bool(torch.isfinite(preds).all()), "non-finite preds")
    src_cov = float((src_info["fim"] >= 0).float().mean())
    check(src_cov > 0.02, f"source body covers {src_cov}")
    fps = 64 / sorted(req_s)[1]
    print(f"slice: personalize {pers_s:.3f} s (first call), requests "
          f"{[round(x, 4) for x in req_s]} s for 64 frames, median "
          f"{fps:.1f} frames/s at batch 16, bf16, 256^2 {tag}")
    master_same = all(
        v.dtype == torch.float32 and torch.equal(v.cpu(), master_sd[k])
        for k, v in master.generator.state_dict().items())
    check(master_same, "the bf16 Imitator changed its float32 master")
    check(imit.compute_nets.generator.tsf_model.img_reg[0].weight.dtype
          == torch.bfloat16, "the compute copy is not bf16")
    print(f"slice: launches {launches}, source coverage {src_cov:.4f}; the "
          f"float32 master weights given to the bf16 Imitator are bit-"
          f"identical after the phase ({len(master_sd)} tensors)",
          flush=True)

    # -- phase 4b: the image-driven leg at full width -----------------------
    lap("4b")
    imit_h = imi.Imitator(cfg, assets=assets, device=dev)   # HMR included
    tgt_imgs = torch.from_numpy(target_images(64, 1)).to(dev)
    imit_h.regress_smpl(tgt_imgs[:16])       # cuDNN's first-use set-up
    torch.cuda.synchronize()
    reset_counts(cr)
    (pers_h_s,), src_h = requests(lambda: imit_h.personalize(src_img),
                                  1)                  # θ from HMR
    rows_after_pers_h = cr.zbuffer_bucket_rows.launches
    req_h, preds_h = requests(lambda: imit_h.inference(tgt_imgs, batch=16))
    launches_h = read_counts(cr)
    check(rows_after_pers_h >= 1, "personalize(src_img) launched no rows")
    check(launches_h["zbuffer_bucket_flow"] == 3 * 4,
          f"full leg flow launches {launches_h['zbuffer_bucket_flow']}")
    check(tuple(preds_h.shape) == (64, GEOM["s"], GEOM["s"], 3),
          f"full leg preds shape {tuple(preds_h.shape)}")
    check(bool(torch.isfinite(preds_h).all()), "non-finite full leg preds")
    src_cov_h = float((src_h["fim"] >= 0).float().mean())
    check(src_cov_h > 0.02, f"HMR source body covers {src_cov_h}")
    mean_theta = torch.from_numpy(assets.mean_theta).to(dev)
    dev_theta = float((src_h["theta"] - mean_theta).abs().max())
    hmr_ms = median_ms(lambda: imit_h.regress_smpl(tgt_imgs[:16]), 20)
    fps_h = 64 / sorted(req_h)[1]
    print(f"full leg: personalize(src_img) {pers_h_s:.3f} s, requests "
          f"{[round(x, 4) for x in req_h]} s for 64 frames, median "
          f"{fps_h:.1f} frames/s at batch 16 (HMR fp32 + generator bf16), "
          f"256^2; HMR {hmr_ms:.4f} ms per batch of 16 at 224^2 {tag}")
    print(f"full leg: launches {launches_h}, source coverage "
          f"{src_cov_h:.4f}, source max |theta - mean_theta| {dev_theta:.4f}",
          flush=True)


    # -- phase 7: appearance transfer at full width -------------------------
    lap("7")
    from impersonator_tpu_torch.ops.projection import euler_to_matrix
    from impersonator_tpu_torch.tasks import swapper as swp
    from impersonator_tpu_torch.tasks import viewer as vwr
    s = GEOM["s"]
    tgt_img = np.ascontiguousarray(-src_img[:, ::-1])
    swapper = swp.Swapper(cfg, assets=assets, device=dev)
    reset_counts(cr)
    (setup_s,), _ = requests(lambda: swapper.swap_setup(
        src_img, tgt_img, thetas[0], thetas[1]), 1)
    launches_setup = read_counts(cr)
    check(launches_setup["zbuffer_bucket_rows"] == 2,
          f"swap_setup launches {launches_setup}")
    swaps = {p: swapper.swap(target_part=p) for p in ("body", "all")}
    for p, out in swaps.items():
        check(tuple(out.shape) == (1, s, s, 3), f"swap {p} shape {out.shape}")
        check(bool(torch.isfinite(out).all()), f"non-finite swap {p}")
    # part 0 of 'par' (the head): "body" leaves it to the source, "all"
    # takes it from the target
    kept = swapper.src_info["part"][0, ..., 0] != 0
    n_kept = int(kept.sum())
    check(n_kept > 0, "the source's kept part covers no pixel")
    diff = (swaps["body"] - swaps["all"]).abs().amax(-1)[0][kept]
    differ = float((diff > 0).float().mean())
    check(differ >= SWAP_DIFFER, f"body and all swaps differ on {differ} "
          f"of the kept part's {n_kept} px")
    swap_ms = median_ms(lambda: swapper.swap(target_part="body"), 20)
    # the appearance-transfer chain: personalise the swapped image, then
    # drive it through a motion
    comp_state = swapper.personalize(swaps["body"][0].cpu().numpy(),
                                     thetas[0])
    reset_counts(cr)
    req_w, preds_w = requests(lambda: swapper.imitate_by_smpls(
        comp_state, req_thetas, batch=16))
    launches_swap = read_counts(cr)
    check(launches_swap["zbuffer_bucket_flow"] == 3 * 4,
          f"swapped imitation flow launches {launches_swap}")
    check(tuple(preds_w.shape) == (64, s, s, 3) and
          bool(torch.isfinite(preds_w).all()), "swapped imitation preds")
    print(f"swap: swap_setup {setup_s:.3f} s (2 personalisations), launches "
          f"{launches_setup}; swap('body') {swap_ms:.4f} ms (median of 20, "
          f"CUDA events); the kept head covers {n_kept} px, of which "
          f"{differ:.4f} differ between 'body' and 'all' (max "
          f"{float(diff.max()):.4f}); swapped imitation requests "
          f"{[round(x, 4) for x in req_w]} s for 64 frames, median "
          f"{64 / sorted(req_w)[1]:.1f} frames/s at batch 16, launches "
          f"{launches_swap}, bf16, 256^2 {tag}", flush=True)

    # -- phase 8: novel view at full width ----------------------------------
    lap("8")
    viewer = vwr.Viewer(cfg, assets=assets, device=dev)
    reset_counts(cr)
    (pers_v_s,), _ = requests(lambda: viewer.personalize(src_img,
                                                         thetas[0]), 1)
    launches_pv = read_counts(cr)
    check(launches_pv["zbuffer_bucket_rows"] == 1,
          f"viewer personalize launches {launches_pv}")
    yaws = [22.5 * i for i in range(16)]
    reset_counts(cr)
    (sweep_s,), sweep = requests(lambda: viewer.view_sweep(yaws), 1)
    launches_sweep = read_counts(cr)
    check(launches_sweep["zbuffer_bucket_flow"] == 1,
          f"view_sweep launches {launches_sweep}")
    check(tuple(sweep.shape) == (16, s, s, 3) and
          bool(torch.isfinite(sweep).all()), "view_sweep preds")
    covs = view_coverage(viewer, vwr, euler_to_matrix, [0.0, 90.0])
    check(min(covs) > 0.02, f"view coverage at yaw 0 and 90: {covs}")
    vrng = np.random.default_rng(2)
    view_thetas = np.tile(thetas[0], (64, 1))
    view_thetas[:, 3:6] = vrng.normal(0, 0.8, (64, 3)).astype(np.float32)
    reset_counts(cr)
    req_v, preds_v = requests(lambda: viewer.view_by_smpls(view_thetas,
                                                           batch=16))
    launches_view = read_counts(cr)
    check(launches_view["zbuffer_bucket_flow"] == 3 * 4,
          f"view_by_smpls launches {launches_view}")
    check(tuple(preds_v.shape) == (64, s, s, 3) and
          bool(torch.isfinite(preds_v).all()), "view_by_smpls preds")
    print(f"view: personalize {pers_v_s:.3f} s, launches {launches_pv}; "
          f"view_sweep of 16 yaws {sweep_s:.4f} s, launches "
          f"{launches_sweep}, coverage at yaw 0 / 90 {covs[0]:.4f} / "
          f"{covs[1]:.4f}; view_by_smpls requests "
          f"{[round(x, 4) for x in req_v]} s for 64 views, median "
          f"{64 / sorted(req_v)[1]:.1f} views/s at batch 16, launches "
          f"{launches_view}, bf16, 256^2 {tag}", flush=True)

    # -- phase 8b: DeepFill background, front warp ---------------------------
    lap("8b")
    cfg_bg = TestConfig(image_size=s, repeat_num=6, bg_model="deepfill",
                        front_warp=True)
    imit_bg = imi.Imitator(cfg_bg, assets=assets, device=dev)
    # yaw 180°: the synthetic body faces the camera, so the face is pasted
    face = np.asarray([0.0, np.pi, 0.0], np.float32)
    th_face = thetas[0].copy()
    th_face[3:6] += face
    face_thetas = req_thetas.copy()
    face_thetas[:, 3:6] += face
    reset_counts(cr)
    (pers_bg_s,), src_bg = requests(lambda: imit_bg.personalize(
        src_img, src_smpl=th_face), 1)
    (req_bg_s,), preds_bg = requests(lambda: imit_bg.inference_by_smpls(
        face_thetas, batch=16), 1)
    launches_bg = read_counts(cr)
    check(launches_bg["zbuffer_bucket_rows"] == 1 and
          launches_bg["zbuffer_bucket_flow"] == 4,
          f"DeepFill leg launches {launches_bg}")
    check(bool(torch.isfinite(src_bg["bg"]).all()), "non-finite background")
    check(bool(torch.isfinite(preds_bg).all()), "non-finite DeepFill preds")
    print(f"DeepFill + front warp: personalize {pers_bg_s:.3f} s (first "
          f"call, DeepFill fp32), background mean |x| "
          f"{float(src_bg['bg'].abs().mean()):.4f}; one 64-frame request "
          f"{req_bg_s:.4f} s, {64 / req_bg_s:.1f} frames/s at batch 16, "
          f"launches {launches_bg}, 256^2 {tag}", flush=True)

    # -- phase 10: test-time post-tune at full width ------------------------
    lap("10")
    (pt_launches, pt_sw_launches) = post_tune_phase(
        cr, imi, swapper, assets, cfg, src_img, thetas, req_thetas, dev,
        tag)

    # -- phase 11: the adversarial trainer at full width --------------------
    lap("11")
    train_launches, w_tr, t_tr = train_phase(cr, smpl_ops, assets, dev, tag)
    errs["zbuffer_bucket_rows"] = max(errs["zbuffer_bucket_rows"], w_tr)
    errs["zbuffer_bucket_flow"] = max(errs["zbuffer_bucket_flow"], t_tr)

    # -- phase 12: host and device IO, serve and the CLIs -------------------
    lap("12")
    io_launches = host_io_phase(cr, imi, imit_h, assets, cfg, src_img,
                                thetas, req_thetas, dev, tag)

    # -- phase 9: fp32 (TF32 off) card vs CPU: swap, view, DeepFill ----------
    lap("9")
    torch.backends.cudnn.allow_tf32 = False
    cpu = torch.device("cpu")
    cfg32 = TestConfig(image_size=s, repeat_num=6, compute_dtype="float32")
    sw_c = swp.Swapper(cfg32, assets=assets, device=cpu)
    sw_g = swp.Swapper(cfg32, assets=assets, device=dev)
    sw_c.swap_setup(src_img, tgt_img, thetas[0], thetas[1])
    pred_c = sw_c.swap(target_part="body")
    pred_g = swp.swap_core(sw_g.nets, sw_g.renderer,
                           to_device(sw_c.src_info, dev),
                           to_device(sw_c.tsf_info, dev),
                           sw_g.left_faces("body"), swp.PART_IDS["body"], [0])
    swap_err = float((pred_g.cpu() - pred_c).abs().max())
    check(swap_err <= PRED_TOL, f"fp32 swap card vs CPU {swap_err}")
    vw_c = vwr.Viewer(cfg32, assets=assets, device=cpu)
    vw_g = vwr.Viewer(cfg32, assets=assets, device=dev)
    st_v = vw_c.personalize(src_img, thetas[0])
    yaws4 = [0.0, 90.0, 180.0, 270.0]
    rots = torch.stack([euler_to_matrix([0.0, y, 0.0]) for y in yaws4])
    mesh = vwr.rotate_verts(st_v["verts"], rots, torch.zeros(4, 3))
    cam4 = st_v["cam"].expand(4, 3)
    fim_vc, t_vc = vw_c.renderer.render_flow(cam4, mesh, st_v["p2verts"])
    fim_vg, t_vg = vw_g.renderer.render_flow(
        cam4.to(dev), mesh.to(dev), st_v["p2verts"].to(dev))
    check(torch.equal(fim_vg.cpu(), fim_vc),
          "view kernel fim on the card differs from the CPU twin's")
    t_v_err = float((t_vg.cpu() - t_vc).abs().max())
    check(t_v_err <= T_TOL, f"view flow card vs CPU {t_v_err}")
    tail_g = vwr.view_from_flow(vw_g.nets, vw_g.renderer,
                                to_device(st_v, dev), fim_vc.to(dev),
                                t_vc.to(dev))
    tail_c = vwr.view_from_flow(vw_c.nets, vw_c.renderer, st_v, fim_vc,
                                t_vc)
    view_err = float((tail_g.cpu() - tail_c).abs().max())
    check(view_err <= PRED_TOL, f"fp32 view tail card vs CPU {view_err}")
    bgnet_g = imit_bg.nets.bgnet
    bgnet_c = copy.deepcopy(bgnet_g).cpu()
    img_n = torch.from_numpy(src_img)[None].permute(0, 3, 1, 2)
    body = (src_bg["fim"] >= 0).float()[:, None].cpu()
    with torch.no_grad():
        x_g = bgnet_g(img_n.to(dev), body.to(dev), only_x=True).cpu()
        x_c = bgnet_c(img_n, body, only_x=True)
    inp_err = float((x_g - x_c).abs().max())
    check(inp_err <= INPAINT_TOL, f"DeepFill card vs CPU {inp_err}")
    print(f"cross-check fp32 (TF32 off), card vs CPU: swap_core from the "
          f"CPU's two states max |dpred| {swap_err} (bound {PRED_TOL}); "
          f"view kernel on the CPU's 4 rotated meshes: fim equal, max |dT| "
          f"{t_v_err} (bound {T_TOL}); view tail on the CPU's raster max "
          f"|dpred| {view_err} (bound {PRED_TOL}); DeepFill output max |dx| "
          f"{inp_err} (bound {INPAINT_TOL}, mean |x| "
          f"{float(x_c.abs().mean()):.4f})", flush=True)

    # -- phase 5: fp32 card vs CPU -----------------------------------------
    lap("5")
    ims, sts, preds = [], [], []
    for d in (dev, cpu):
        im = imi.Imitator(cfg32, assets=assets, device=d)
        sts.append(im.personalize(src_img, src_smpl=thetas[0]))
        preds.append(im.inference_by_smpls(req_thetas[:2], batch=2).cpu())
        ims.append(im)
    (im_g, im_c), (st_g, st_c) = ims, sts
    # each device with its own geometry: SMPL's float32 matmuls sum in
    # another order on the card (vertices ~1e-7 apart), which can flip a
    # pixel centre lying on a shared edge
    e2e_px = int((st_g["fim"].cpu() != st_c["fim"]).sum())
    e2e_diff = (preds[0] - preds[1]).abs()
    e2e_pred = float(e2e_diff.max())
    e2e_far = int((e2e_diff > PRED_TOL).any(-1).sum())
    check(bool(torch.isfinite(preds[0]).all()), "non-finite fp32 preds")
    # the raster across devices on identical input: the card's kernels on
    # the CPU run's geometry equal the CPU's plain twins
    tsf = imi.swap_smpl(st_c["cam"], st_c["shape"],
                        torch.from_numpy(req_thetas[:2]),
                        torch.from_numpy(req_thetas[0:1, 0:3]))
    info = smpl_ops.get_details(im_c.smpl_params, tsf, assets.parents)
    fim_c, t_c = im_c.renderer.render_flow(info["cam"], info["verts"],
                                           st_c["p2verts"])
    fim_g, t_g = im_g.renderer.render_flow(
        info["cam"].to(dev), info["verts"].to(dev), st_c["p2verts"].to(dev))
    _, fim_sg, wim_sg = im_g.renderer.render_fim_wim(
        st_c["cam"].to(dev), smpl_ops.get_details(
            im_c.smpl_params, st_c["theta"], assets.parents)["verts"].to(dev))
    check(torch.equal(fim_g.cpu(), fim_c) and
          torch.equal(fim_sg.cpu(), st_c["fim"]),
          "kernel fim on the card differs from the CPU twin's")
    t_dev = float((t_g.cpu() - t_c).abs().max())
    w_dev = float((wim_sg.cpu() - st_c["wim"]).abs().max())
    check(t_dev <= T_TOL and w_dev <= W_TOL,
          f"raster card vs CPU: |dT| {t_dev}, |dw| {w_dev}")
    # the continuous tail on the card from the CPU's raster products (as
    # tests/test_composition.py holds the raster fixed)
    keys = ("theta", "cam", "shape", "pose", "j2d")
    st_g2 = imi.personalize_from_raster(
        im_g.nets, st_c["img"].to(dev), {k: st_c[k].to(dev) for k in keys},
        st_c["fim"].to(dev), st_c["wim"].to(dev), st_c["p2verts"].to(dev),
        st_c["cond"].to(dev), cfg32.bg_ks, cfg32.ft_ks)
    pred_g2 = imi.imitate_from_flow(im_g.nets, im_g.renderer, st_g2,
                                    fim_c.to(dev), t_c.to(dev),
                                    im_g.renderer.encode_fim(fim_c.to(dev)))
    pred_err = float((pred_g2.cpu() - preds[1]).abs().max())
    bg_err = float((st_g2["bg"].cpu() - st_c["bg"]).abs().max())
    check(pred_err <= PRED_TOL, f"fp32 preds differ by {pred_err}")
    print(f"cross-check fp32 (TF32 off), 2 frames, card vs CPU: kernels on "
          f"the CPU's geometry: fim equal, max |dT| {t_dev}, max |dw| "
          f"{w_dev}; generator tail on the CPU's raster: max |dpred| "
          f"{pred_err}, max |dbg| {bg_err}; fully independent runs: "
          f"{e2e_px} source fim px differ, max |dpred| {e2e_pred} with "
          f"{e2e_far} of {e2e_diff[..., 0].numel()} px above {PRED_TOL}",
          flush=True)

    # -- phase 5b: HMR card vs CPU ------------------------------------------
    lap("5b")
    # both TF32 flags on for the process: HMR keeps its own convs and
    # matmuls in full float32; its encoder called outside that scope shows
    # what TF32 would do to the features
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    hmr_g = imit_h.nets.hmr
    hmr_cpu = copy.deepcopy(hmr_g).cpu()
    x = tgt_imgs[:4]
    with torch.no_grad():
        ft_g = hmr_g.features(x).cpu()
        ft_tf32 = hmr_g.resnet(x.permute(0, 3, 1, 2)).cpu()
        ft_c = hmr_cpu.features(x.cpu())
        th_c = hmr_cpu(x.cpu())
    th_g = imit_h.regress_smpl(x).cpu()
    ft_scale = float(ft_c.abs().max())
    ft_rel = float((ft_g - ft_c).abs().max()) / ft_scale
    tf32_rel = float((ft_tf32 - ft_c).abs().max()) / ft_scale
    th_err = float((th_g - th_c).abs().max())
    print(f"HMR card vs CPU, 4 images 224^2, process TF32 flags on: "
          f"features max |df| / max |f| {ft_rel:.3e} (bound {FEAT_RTOL}); "
          f"the encoder outside HMR's full-fp32 scope (TF32) "
          f"{tf32_rel:.3e}; max |dtheta| {th_err} (bound {THETA_TOL})",
          flush=True)
    check(ft_rel <= FEAT_RTOL, f"HMR features card vs CPU {ft_rel}")
    check(tf32_rel > FEAT_RTOL, f"TF32 features pass the check: {tf32_rel}")
    check(th_err <= THETA_TOL, f"HMR theta card vs CPU {th_err}")
    torch.backends.cuda.matmul.allow_tf32 = False   # PyTorch's defaults

    # -- phase 6: where a full-leg request's device time goes --------------
    lap("6")
    w_port, w_lib = warp_ms(dev, GEOM["s"])
    print(f"warps of one imitation step (batch 16, bf16, 256^2: the source "
          f"image and the LWB feature warps): {w_port:.4f} ms in the JAX "
          f"arithmetic (ops.sampler), {w_lib:.4f} ms through F.grid_sample "
          f"in float32 with its casts (CUDA events, sums of medians) {tag}",
          flush=True)
    wall, kern, rows = profile_request(
        lambda: imit_h.inference(tgt_imgs, batch=16),
        Path("chiprun_out") / "profile_full_leg.txt")
    hmr_wall, hmr_kern, _ = profile_request(
        lambda: imit_h.regress_smpl(tgt_imgs[:16]),
        Path("chiprun_out") / "profile_hmr.txt")
    print(f"profile, one 64-frame full-leg request at batch 16: wall "
          f"{wall:.2f} ms (profiler on), {kernel_share(kern, wall)}; HMR "
          f"alone {not_measured(hmr_kern, '.2f')} ms of kernels per batch "
          f"of 16 {tag}")
    for ms, n, name in rows[:12]:
        print(f"profile: {ms:9.3f} ms {n:5d} x {name[:90]}")
    for ms, n, name in rows:
        if "zbuffer" in name:
            print(f"profile: {ms / n:.4f} ms of device time per launch "
                  f"(mean) ({n} launches) of {name[:70]}")
    vwall, vkern, vrows = profile_request(
        lambda: viewer.view_by_smpls(view_thetas, batch=16),
        Path("chiprun_out") / "profile_view.txt")
    print(f"profile, one 64-view view_by_smpls request at batch 16: wall "
          f"{vwall:.2f} ms (profiler on), {kernel_share(vkern, vwall)} "
          f"{tag}")
    for ms, n, name in vrows[:10]:
        print(f"profile view: {ms:9.3f} ms {n:5d} x {name[:90]}")
    swall, skern, srows = profile_request(
        lambda: swapper.swap(target_part="body"),
        Path("chiprun_out") / "profile_swap.txt")
    print(f"profile, one swap('body') at batch 1: wall {swall:.2f} ms "
          f"(profiler on), {kernel_share(skern, swall)} in "
          f"{sum(r[1] for r in srows)} launches {tag}")
    for ms, n, name in srows[:8]:
        print(f"profile swap: {ms:9.3f} ms {n:5d} x {name[:90]}")
    sys.stdout.flush()

    # launches: each kernel's count over the path that carries it — the
    # full leg (4b) for the bucket kernels, the tiled route (3c) for
    # zbuffer_tiles
    path_launches = {**launches_h,
                     "zbuffer_tiles": tiled_launches["zbuffer_tiles"]}
    # each path's own counts, read just after it: 4b's and 3c's above, and
    # the appearance-transfer, novel-view and DeepFill paths
    by_path = {"given_smpl": launches, "full_leg": launches_h,
               "tiled_route": tiled_launches, "swap_setup": launches_setup,
               "swap_imitate": launches_swap, "view_personalize": launches_pv,
               "view_sweep": launches_sweep, "view_by_smpls": launches_view,
               "deepfill_front_warp": launches_bg,
               "post_tune_imitator": pt_launches,
               "post_tune_swapper": pt_sw_launches, **train_launches,
               **io_launches}
    record = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"impersonator_tpu_torch/csrc/{src}",
         "replaces": f"impersonator_tpu/ops/pallas_raster.py:{line}",
         "launches": path_launches[name],
         "launches_by_path": {p: c[name] for p, c in by_path.items()},
         "max_abs_err": errs[name],
         "ms": timing[name][0][0], "device_ms": timing[name][0][1],
         "device_ms_by": timing[name][0][2],
         "held_stream_ms": timing[name][0][3],
         "plain_ms": timing[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "bound_ms_all_pairs": bounds[name][2], "library_ms": None}
        for name, src, line in (
            ("zbuffer_bucket_rows", "zbuffer_bucket.cu", 365),
            ("zbuffer_bucket_flow", "zbuffer_bucket.cu", 413),
            ("zbuffer_tiles", "zbuffer_tiles.cu", 146))]}
    check(all(k["launches"] > 0 for k in record["kernels"]),
          f"a kernel never launched on its path: {path_launches}")
    lap(None)
    print(f"chip_smoke: seconds of wall time by phase {LAPS}", flush=True)
    print(f"chip_smoke: whole script {time.perf_counter() - t_start:.1f} s "
          f"of wall time, the kernels' build included {tag}", flush=True)
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
