#!/usr/bin/env python3
"""The card's check harness for the PyTorch/CUDA port
(impersonator_tpu_torch) on one NVIDIA GPU: every path against its plain
twin or the CPU, with launch counts, and no timing (the benchmark,
``lwg_bench/run.py``, measures). Run from the repository root:

    python3 chip_smoke.py

Phases, each failing the run (exit 1) on any error:

1. needs torch.cuda; prints the card's name and power limit;
2. builds the hand-written kernels with nvcc, every csrc/*.cu at once,
   loads their entry points, and beside them builds the image codec
   (csrc/host_codec.cpp against nvJPEG and zlib);
3. bucket kernels vs their plain twins on the card at 256² on the
   12,880-face synthetic body: 16 poses, plus a random scene with one
   oversized front face, a scene behind the far plane and a degenerate
   scene (equal vertices on pixel centres, collinear faces, slivers: the
   pairs the kernels' warp cull must keep, tests/test_torch_cuda.py);
   fim equal, weights <= 2e-4, flow <= 1e-5; the share of (warp, face)
   pairs the cull keeps on the bodies (its plain mirror);
3b. zbuffer_tiles vs its plain twin at the renderer's tile_params()
   point (tile 8, cap 288, span 3 at 256²) on the same 16 bodies, the
   random + oversized scene, the behind-far scene, 3,000 small faces
   at cap 4, where both drop the same candidates, and the tie scene
   (scenes.tie_scene: coplanar faces of equal depth on both sides of the
   kernel's share boundaries); fim equal, weights <= 2e-4; its fim on the
   bodies equals zbuffer_bucket_rows'; tile stats;
3c. the renderer's tiled route: render_fim_wim on 16 posed 63,480-face
   bodies launches zbuffer_tiles; on those slots, and on the tie scene
   at batch 16, the kernel's fim equals the twin's and its weights are
   within 2e-4;
3d. the half-precision warp kernel (ops/cuda_warp.py) against its plain
   twin at the five warps of an imitation batch of 16 at 256² (the source
   image, 3 channels at 256²; the encoder's 128, 256, 512 channels at
   128², 64², 32²; the residual blocks' 3,072 at 32²), bf16 and fp16, a
   batch-1 and a batch-16 source, on random flows with background rows
   and on phase 3's 16 body flows resized to each stage: equal bit for
   bit; every in-process
   path's counts include the calls of the warp's twin with a CUDA x,
   and the run fails unless each path's is 0;
4. the given-SMPL slice at full width (256², conv_dim 64, 6 res blocks,
   bf16): Imitator.personalize and one 64-frame inference_by_smpls
   request at batch 16, with the kernels' launch counts over that run
   (the warp kernel 5 a batch); the float32 master weights the bf16
   Imitator was given stay bit for bit;
4b. the image-driven leg at full width: HMR (ResNet-50 at 224², float32,
   TF32 off) + the same generator: personalize(src_img) with no given
   SMPL, then one 64-frame inference(tgt_imgs224, batch=16) request;
   launch counts;
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
   must differ on the source's kept head, and the swapped image
   personalised and driven through one 64-frame imitate_by_smpls request
   at batch 16 (4 zbuffer_bucket_flow launches);
8. novel view at full width: Viewer.personalize (1 rows launch),
   view_sweep of 16 yaws (1 flow launch; the body covers > 2% of the
   pixels at yaw 0 and 90), one 64-view view_by_smpls request with
   random root orientations at batch 16 (4 flow launches);
8b. the DeepFill background (float32) with front_warp: personalize and
   one 64-frame request;
10. test-time post-tune at full width (bf16 Imitator, float32 master,
   Sphere20a face net, seeded): adaptive_personalize on 8 default priors
   at batch 4 for 5 epochs (10 Adam steps, face loss on), twice, and
   post_tune_swapper for 50 iterations on phase 7's pair, twice: the
   cycle-loss history, the rows and flow launches each adds;
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
   float32 (cuDNN's default TF32): one warm-up step, then 5 G+D steps,
   1 G-only step, one eval-only step and one visuals call, with the
   launch counts over those 8 (1 zbuffer_bucket_rows and 1
   zbuffer_bucket_flow each); peak memory (max_memory_allocated above
   what the earlier phases still hold), finite losses, G's and D's
   weights moved, the float32 master and Adam's moments still float32
   under bf16. On the step's own bodies, the
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
   zbuffer_bucket_flow launch per batch; on the bf16 leg of 4b the u8
   and the I420 stream, one request each (one flow launch per batch);
   serve's make_server in-process on
   127.0.0.1: /healthz (backend cuda), /personalize (a JPEG body),
   /imitate (64 θs -> 64 JPEGs of 256²), /imitate_frames (16 JPEGs), a
   malformed body 400 then 200, /imitate_video 400 without ffmpeg,
   memory over 10 requests within SERVE_MEM_SLACK; then cli.run_imitator
   on the 64 frames, and together run_imitator --i420, run_swap,
   run_view (16 views) and demos imitator, each a subprocess with
   --device cuda, exit 0, the files written and decodable;
13. the remaining trainers at full width (256², batch 16, conv_dim 64, 6
   res blocks, 4-layer PatchGANs, VGG19 and Sphere20a on, seeded
   weights): the augmented trainer (tasks/trainer_aug.py: the Places2
   stream, a U(-1, 1) stand-in here, and the Global + Local D) in bf16
   and in float32, a warm-up step, 5 G+D steps and 1 G-only step (1
   zbuffer_bucket_rows and 1 zbuffer_bucket_flow launch each), peak
   memory, finite losses, both nets moved, the float32 master and Adam's
   moments float32; a small iPER + Places2 +
   DeepFashion tree (60 JPEGs from the card's encoder) read by
   dataset_by_name("iPER_fashion_place") through the loader on the card
   (4 threads, nvJPEG) into one float32 aug step;
   one float32 aug step card vs CPU with TF32 off at 128² under phase
   11's bounds (both PatchGANs' biases before an instance norm left out
   per tensor); the three ablation baselines (tasks/trainer_baseline.py)
   in float32, a warm-up step and 3 steps each (2
   zbuffer_bucket_rows launches a step, no flow), texture_warping's
   extract_texture + render_textured card vs CPU on the CPU's raster
   within TEX_TOL; soft_silhouette on the 12,880-face body card vs CPU
   at 128² (SIL_TOL) with its camera gradient (SIL_GRAD_RTOL), and its
   forward + backward peak memory at 256², batch 2; then
   cli.train.main --model impersonator_trainer_aug and --model
   feature_warping for one epoch of 4 steps each (launches 4 / 4 and
   8 / 0);
14. the evaluation suite (metrics/, cli/evaluate.py), the metric nets in
   float32 with TF32 off: LPIPS (alex, the repository's v0.1 lin heads,
   a seeded backbone) on 64 pairs at 256², batch 16, card vs CPU within
   EVAL_NET_RTOL; InceptionV3 (He-initialised, seeded) pool3 and
   probabilities of 64 images resized to 299², pool3 card
   vs CPU within EVAL_NET_RTOL and the FID of 32 against 32 images from
   each device's features within EVAL_FID_RTOL; InceptionResnetV1,
   SENet50, Sphere20a, OSNet and PCB embeddings of the 64 images, card
   vs CPU within EVAL_NET_RTOL; MTCNN with the repository's weights on
   16 frames of 256² with a drawn face (scenes.face_image), the same
   boxes on both devices within
   EVAL_BOX_PX; cli.evaluate.main on an iPER tree of 2 videos × 16 JPEG
   frames of 256² from the card's encoder with θ pickles (self- and
   cross-imitation, bf16) with every extractor: LPIPS on the
   repository's heads, MTCNN on its weights, and the seeded InceptionV3,
   InceptionResnetV1, SENet50, Sphere20a, OSNet and PCB above written
   here as the JAX package's msgpack files by utils.convert.TO_JAX and
   utils.checkpoint.write_flax_msgpack (each read back bit-equal), a
   seeded darknet graph (YOLO_CFG) and --sspe: launches exactly rows 2
   / flow 8, every self- and cross-imitation
   key finite, results.txt and results.json; then the same command in
   float32 (TF32 off) on one video at --max_frames 4, on the card (rows
   1 / flow 2) and on the CPU (reading the frames through the card's
   decoder: the card's host has no libjpeg), every key of results.json
   (self_imitation, cross_imitation, per_video) within eval_gap's bound;
15. the multi-card code paths on the one card (float32, TF32 off, cuDNN
   deterministic, at phase 11's point: 256², batch 16, a 4-layer
   PatchGAN, VGG19 + Sphere20a): (a) the train step twice without a
   process group and once in a process group of one under NCCL
   (parallel.init_distributed): losses bit-equal, all_reduce_mean_ over
   one process the identity on the step's gradients, the gradients and
   parameters within MC_NONDET_FACTOR of two plain steps' own gap (bit-
   equal where theirs is 0) (rows 3 / flow 3); (b) two
   processes on the card (torch.multiprocessing.spawn), each on 8 of the
   16 samples, each first stepping alone, then in a gloo group (a probe
   all-reduce of a CUDA tensor first): all_reduce_mean_ of the steps'
   gradients alone equal to their mean, bit for bit; the step in the
   group (step_nets' all-reduce; rows 1 / flow 1 in each rank) against
   the mean of their steps alone (losses MC_SAME_RTOL, gradients
   MC_SAME_GRAD_RTOL) and against one process on all 16 (MC_LOSS_RTOL;
   each net's MC_GRAD_RTOL per tensor and over all), both ranks'
   parameters bit-equal after Adam; (c) an
   Imitator whose mesh names the card twice (bf16, phase 4's width):
   personalize (rows 1: one personalisation, copied), one 64-frame
   inference_by_smpls request at batch 16 (flow 8: 4 batches x 2
   pieces) and one 64-frame inference (flow 8); then in float32 the two-replica mesh at batch 16 against one
   device at batch 8 (a piece's batch) on the same requests (PRED_TOL)
   with frame 0's camera reference; (d)
   run_imitator.main --data_parallel on 8 JPEG frames (rows 1 / flow 1)
   and serve's ImitatorService(data_parallel=True) answering 64 θs (flow
   4), each on a mesh of the visible cards. Before and after the phase
   (and before 5 and 5b), the process's state (process_state). Phase 15
   leaves glibc's heap ~3.9 GiB larger, mostly free (the gradients and
   parameters it brings to the host), so 9 and 5 then take their CPU
   memory from that heap;
16. the repository's tools on the port (impersonator_tpu_torch/tools), each
   a subprocess on the card (TOOL_LAUNCHER: the module run as by python
   -m, its process's launch counts printed last), all started together,
   on seeded inputs (tool_inputs: 16 smooth 256² PNG frames, their θs,
   the bench body written as an SMPL pickle + UV OBJ, released-layout HMR
   and full-width generator .pth files): convert_weights gen (the bytes
   of a second write of the same tree, read back bit-equal);
   make_prior_poses at batch 16 (θ against the CPU within FEAT_RTOL of
   the largest); visual_iper at batch 16 (rows 1; the card's fim equal
   to the plain twin's, the tool's triptychs equal to the card's renders;
   on the CPU's geometry of 2 frames fim equal to the CPU's, the render
   within TEX_TOL); parity_harness in bf16 and in float32 (rows 1 / flow
   2 each; the float32 JSON of the first batch of 8 frames against the
   CPU's within EVAL_BOUNDS, the CPU run on a thread beside the
   subprocesses); posttune_artifact and trainconv_artifact on the bench
   body with the full nets at 256² with TOOL_POSTTUNE / TOOL_TRAINCONV's
   fewer epochs (finite JSON; rows 6 / flow 5 and rows 8 / flow 6) and
   their recipes' first step card vs CPU at 128² on the tools' default
   body and nets (TUNE_LOSS_RTOL; made, with the prior-pose and visual
   checks, while the tools run);
   prepare_iper on a seeded mp4 where the host has ffmpeg (else a line
   saying it did not run); then run_imitator --post_tune --prior_poses
   on make_prior_poses' pickle, the bench body (rows 3 / flow 2). Phase
   16 runs after 15, so its CPU work also finds phase 15's grown heap;
9. float32 with TF32 off, card against CPU on the same weights:
   swap_core on the card from the CPU's two states (preds within 1e-2),
   the flow kernel on the CPU's rotated meshes (fim equal to the twin's,
   flow within 1e-5) and the view tail from the CPU's raster (within
   1e-2), DeepFill's output (within 1e-3).

Phases run in the order 1-4b, 7, 8, 8b, 10, 11, 12, 13, 14, 15, 16, 9, 5,
5b. Each path (3c, 4, 4b, 7, 8, 8b, 10, 11's bf16, float32 and CLI
runs, 12's streamed requests and /imitate, 13's trainers and CLI runs,
14's cli.evaluate runs, 15's steps, mesh requests and data-parallel
CLIs, 16's tool subprocesses) runs
with every launch count set to 0 just before it and read just after,
and fails if a kernel of the path never launched; the record's
launches_by_path holds each path's counts ("train", "train_fp32",
"train_cli" for phase 11; "host_io_u8", "host_io_i420" and
"serve_imitate" for phase 12; "train_aug", "train_aug_fp32",
"train_aug_disk", "train_concat", "train_texture_warping",
"train_feature_warping", "train_aug_cli" and
"train_feature_warping_cli" for phase 13; "evaluate_cli" and
"evaluate_cli_fp32" for phase 14; "train_group_of_one",
"train_two_ranks" (both ranks' counts, read in each rank's process),
"mesh_personalize", "mesh_inference_by_smpls", "mesh_inference",
"run_imitator_dp" and "serve_imitate_dp" for phase 15; "tool_<name>"
for each tool of phase 16 and "tool_run_imitator_post_tune"). The line
before the last is nvidia-smi's name and power limit, the one before it
the kernels' JSON record (each kernel's launches, launches by path and
largest error against its twin); the last line is the JSON status.
Weights are random (seeded); no checkpoint is read. Timing questions go
to ``python3 lwg_bench/run.py --workload W --seed N --seconds 51 --trace
1`` and ``lwg_bench/span_split.py``.
"""

import contextlib
import copy
import dataclasses
import json
import subprocess
import sys
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
# one float32 tune step (phase 10) or train step (phase 11), card vs CPU
# with TF32 off: losses (float32 sums in another order); the gradient in
# the L2 norm per tensor and over all
# tensors (tests/test_torch_post_tune.py's bounds against JAX: this
# net's float32 gradient is ~2e-2 per tensor from its float64 one); the
# share of weights whose first Adam step (±lr) differs
TUNE_LOSS_RTOL, TUNE_GRAD_RTOL, TUNE_GRAD_ALL_RTOL, TUNE_STEP_FLIPS = (
    1e-4, 5e-2, 2e-2, 1e-2)
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
# phase 13: texture_warping's texels, card vs CPU on the same raster
# (gathers and lerps in float32); the soft silhouette card vs CPU
# (elementwise float32, sums of logs over 12,880 faces in another order)
# and its camera gradient, relative L2
TEX_TOL, SIL_TOL, SIL_GRAD_RTOL = 1e-5, 1e-5, 1e-3
# phase 14: the metric nets card vs CPU (float32 without TF32; max |d| over
# the CPU output's max |x|), FID from the two devices' features (relative),
# MTCNN box corners (px); cli.evaluate card vs CPU in float32 without TF32
# on results.json: tests/test_torch_evaluate.py's BOUNDS
EVAL_NET_RTOL, EVAL_FID_RTOL, EVAL_BOX_PX = 1e-4, 1e-3, 0.5
EVAL_BOUNDS = {"ssim": 1e-5, "psnr": 1e-4, "lps": 1e-5}
# with every extractor, the other keys' bounds, each about 3x the largest
# gap of five runs on the H100 (NVIDIA H100 80GB HBM3, 700 W; readings
# beside each): SSPE (HMR θ distances, full float32; 2.912e-7), the
# matched cosines (float64 means of float32 embeddings; face-CS
# 1.646e-10, OS-CS-reid 1.271e-9, PCB-CS-reid 1.069e-8) and IS, absolute.
# IS read 0 in all five: its seeded nets' probabilities are equal over
# the 4 frames to float32 rounding on both devices, so IS is exactly 1;
# a gap δ in them moves it by ~δ² (KL's second order), and 1e-9 is ~100
# times the square of the probabilities' own card-vs-CPU gap (3e-6)
EVAL_CARD_BOUNDS = {"SSPE": 1e-6, "face-CS": 5e-10, "OS-CS-reid": 4e-9,
                    "PCB-CS-reid": 3e-8, "is": 1e-9}
# the Fréchet distances (float64 on the host from the embeddings' means
# and covariances) relative to the size of the terms they cancel, |mu1 -
# mu2|² + Tr(S1 + eps) + Tr(S2 + eps), of the CPU run (eval_terms): a
# distance between two nearly equal sets of seeded-net embeddings is a
# residue near -2·D·eps (the regularised square root's eps, not the
# traces'), so relative to itself or to 1 it means nothing. Readings of
# five runs, the largest: fid 4.566e-6 (terms 6.229), OS-freid 1.71e-7
# (1.222e-3), PCB-freid 9.33e-8 (0.2141), face-FD 4.88e-8 (1.052e-3)
EVAL_FD_RTOL = {"fid": 1.5e-5, "OS-freid": 5e-7, "PCB-freid": 3e-7,
                "face-FD": 1.5e-7}
EVAL_FD_KEYS = tuple(EVAL_FD_RTOL)
EVAL_SELF_KEYS = ["ssim", "psnr", "lps", "face-CS", "OS-CS-reid", "SSPE"]
EVAL_CROSS_KEYS = ["is", "fid", "OS-freid", "OS-CS-reid", "PCB-freid",
                   "PCB-CS-reid", "face-FD", "face-CS"]
EVAL_VIDEOS, EVAL_FRAMES, EVAL_IMAGES = 2, 16, 64
EVAL_MTCNN = (16, 256)          # MTCNN's frames and their size
# phase 15: the phase-11 point (batch MC_BATCH, its samples from seed
# MC_SEED), float32 without TF32, cuDNN's deterministic algorithms. Each
# bound is about 3x the largest gap of four runs on the H100 (NVIDIA H100
# 80GB HBM3, 700 W), whose readings agreed to 4 digits. Two processes on
# 8 samples each against one on all 16: the losses within MC_LOSS_RTOL
# (measured 2.955e-6 relative); the gradients of each net within
# MC_GRAD_RTOL[net] = (per tensor, over all; relative L2), measured G
# 9.435e-3 / 2.041e-3, D 3.205e-3 / 5.944e-4 (the tensors' norms below
# 1e-5 of their net's are left out per tensor: D's conv biases before an
# instance norm, 0 in exact arithmetic). They are not 0: the kernels at
# batch 8 round otherwise than at 16, and the L1 terms' gradients are
# signs, which those roundings flip (one process's own two halves are
# 1.391e-3 from its batch of 16 over all tensors); a missing or
# misscaled all-reduce of either net is off by O(1). A group of one
# against no group: where two plain steps already differ (atomics in the
# backward), the losses', gradients' and parameters' gaps may be up to
# MC_NONDET_FACTOR times theirs (0 where theirs is 0).
MC_BATCH, MC_SEED = 16, 3
MC_LOSS_RTOL = 1e-5
MC_GRAD_RTOL = {"G": (3e-2, 6e-3), "D": (1e-2, 2e-3)}
MC_NONDET_FACTOR = 4.0
# two processes in a group against their own steps alone: the losses
# are the same sums, the all-reduce's mean of two rounding once more
# (measured 5.956e-8 relative); the gradients over all within
# MC_SAME_GRAD_RTOL (measured 3.457e-4 / 3.458e-4, where two steps in one
# process differ by 6.7e-7): two processes sharing the card get other
# cuDNN algorithms than one alone (the free memory differs) and the L1
# terms' sign gradients flip with them. Each process may hold
# MC_CARD_SHARE of the card's memory.
MC_SAME_RTOL, MC_SAME_GRAD_RTOL = 2e-7, 1e-3
MC_CARD_SHARE = 0.35


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAIL: {msg}")


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# calls of the warp's plain twin with a CUDA x, counted by the wrapper
# that count_twin_on_card installs: every half-precision warp on the card
# launches the kernel, so each path reads 0
TWIN_ON_CARD = [0]


def count_twin_on_card():
    from impersonator_tpu_torch.ops import cuda_warp
    plain = cuda_warp.warp_bilinear_plain

    def counted(x, grid):
        TWIN_ON_CARD[0] += x.is_cuda
        return plain(x, grid)

    cuda_warp.warp_bilinear_plain = counted


def reset_counts(cr):
    from impersonator_tpu_torch.ops.cuda_warp import warp_bilinear
    for k in cr.KERNELS:
        k.launches = 0
    warp_bilinear.launches = TWIN_ON_CARD[0] = 0


def read_counts(cr):
    """The z-buffer kernels' launches, the warp kernel's, and the calls
    of the warp's twin with a CUDA x."""
    from impersonator_tpu_torch.ops.cuda_warp import warp_bilinear
    return {**{k.__name__: k.launches for k in cr.KERNELS},
            "warp_bilinear": warp_bilinear.launches,
            "warp_twin_on_card": TWIN_ON_CARD[0]}


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


def warp_kernel_phase(dev, flow):
    """Phase 3d: the warp kernel against its plain twin, bit for bit, at
    the five warps of an imitation batch, on random flows in [-1.1, 1.1]
    with background rows and on ``flow`` (the bodies' flow T, (B, S, S,
    2)) resized to each stage as the generator resizes it; batch-1 and
    batch-B sources, bf16 and fp16. -> the largest |kernel - twin|
    compared, NaNs where the twin's are."""
    import torch
    from impersonator_tpu_torch.ops import cuda_warp as cw
    from impersonator_tpu_torch.ops.sampler import resize_flow
    batch, s = flow.shape[0], flow.shape[1]
    g = torch.Generator(device=dev).manual_seed(0)
    err = 0.0
    for c, size in ((3, s), (128, s // 2), (256, s // 4), (512, s // 8),
                    (3072, s // 8)):
        x = torch.randn((1, c, size, size), generator=g,
                        device=dev).to(torch.bfloat16)
        noise = torch.rand((batch, size, size, 2), generator=g,
                           device=dev) * 2.2 - 1.1
        noise[0, :size // 4] = -2.0
        grid = resize_flow(flow, size, size)
        for src in (x, x.expand(batch, -1, -1, -1).contiguous()):
            for dt in (torch.bfloat16, torch.float16):
                for gr in (noise, grid):
                    got = cw.warp_bilinear(src.to(dt), gr)
                    want = cw.warp_bilinear_plain(src.to(dt), gr)
                    check(torch.equal(got.view(torch.int16),
                                      want.view(torch.int16)),
                          f"warp kernel differs from its twin at {c} x "
                          f"{size}^2, source batch {src.shape[0]}, {dt}")
                    nan = want.isnan()
                    check(torch.equal(got.isnan(), nan), "NaNs differ")
                    err = max(err, float((got.float() - want.float())[~nan]
                                         .abs().max()))
    print(f"warp kernel vs plain twin, the 5 warps of an imitation batch "
          f"(batch {batch}, {s}^2), random and body flows, bf16 and fp16, "
          f"batch-1 and batch-{batch} sources: equal bit for bit (largest "
          f"|difference| {err})", flush=True)
    return err


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
    differs)."""
    from impersonator_tpu_torch.config import TestConfig
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
    (m_c, g_c, w_c), (m_g, g_g, w_g) = out
    loss_gap = max(abs(m_g[k] - m_c[k]) / abs(m_c[k]) for k in m_c)
    moved = sum(int((w_c[k] != w0[k]).sum()) for k in g_c)
    flips = sum(int(((w_g[k] - w_c[k]).abs() > 1e-4).sum()) for k in g_c)
    return m_c, loss_gap, tensor_gaps(g_g, g_c), flips / moved


def post_tune_phase(cr, imi, swapper, assets, cfg, src_img, thetas,
                    req_thetas, dev):
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
    hist = [pt.adaptive_personalize(imit, priors, epochs=5, batch_size=4,
                                    face=face_g) for _ in range(2)]
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
    print(f"post-tune (imitator): adaptive_personalize, 8 priors, batch 4, 5 "
          f"epochs ({hist[0]['n_steps']} Adam steps, face loss on), twice; "
          f"launches over both calls {launches}; {cfg.image_size}^2, "
          f"conv_dim 64, {cfg.repeat_num} res blocks, float32 master, bf16 "
          f"inference", flush=True)
    for i, m in enumerate(hist):
        print(f"post-tune (imitator) call {i + 1}: cyc_history "
              f"{[round(x, 5) for x in m['cyc_history']]}, last step "
              f"{ {k: round(m[k], 5) for k in ('cyc', 'str', 'fid', 'msk', 'total')} }")
    print(f"post-tune (imitator): inference of 16 poses after the tune "
          f"differs from before it by up to {diff:.4f}", flush=True)

    swap_before = swapper.swap(target_part="body")
    reset_counts(cr)
    sw_m = [pt.post_tune_swapper(swapper, iters=50) for _ in range(2)]
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
          f"2-pair batch, twice, last step "
          f"{ {k: round(v, 5) for k, v in sw_m[1].items()} }; launches over "
          f"both calls {sw_launches}; swap('body') after the tune differs by "
          f"up to {sw_diff:.4f}", flush=True)

    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    m_c, loss_gap, (g_per, g_all), flips = tune_step_card_vs_cpu(
        imi, pt, face, assets, thetas[0], dev)
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    print(f"post-tune step card vs CPU, float32, TF32 off (128^2, conv_dim "
          f"64, 6 res blocks, batch 2, face loss on): losses {m_c}, max relative gap {loss_gap:.3e} (bound "
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
    weights whose Adam step differs)."""
    from impersonator_tpu_torch.config import TrainConfig
    from impersonator_tpu_torch.data.loader import stage_batch
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
    return m_c, loss_gap, gaps, flips / moved


def cli_phase(cr):
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
        cli.main(base + ["--nepochs_decay", "0"])
        exp = Path(tmp) / "smoke"
        want = {f"{k}_epoch_1_id_{l}.pth" for k in ("net", "opt")
                for l in "GD"}
        check(want <= set(p.name for p in exp.iterdir()),
              f"epoch 1 files {sorted(p.name for p in exp.iterdir())}")
        state = cli.main(base + ["--nepochs_decay", "1", "--load_epoch",
                                 "-1"])
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
    print(f"cli.train: epoch 1 (4 steps, batch 16, {GEOM['s']}^2, float32), "
          f"checkpoint files written; resumed with --load_epoch -1 at epoch "
          f"1, epoch 2 (4 steps), Adam steps {n_adam}, launches over both "
          f"calls {launches}", flush=True)
    return launches


def train_phase(cr, smpl_ops, assets, dev):
    """Phase 11 (module docstring); returns ({path: launch counts},
    max |dw|, max |dT| of the kernels against their twins on the step's
    bodies)."""
    import numpy as np
    import torch
    from impersonator_tpu_torch.config import TrainConfig
    from impersonator_tpu_torch.data.loader import stage_batch
    from impersonator_tpu_torch.tasks import trainer as tt
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
        metrics = []
        for fn in [step] * 5 + [step_g]:
            st, m = fn(st, batch)
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
        print(f"train ({dtype}): peak memory {peak / 2**30:.2f} GiB (the "
              f"trainer's: nets, Adam, activations; above the "
              f"{base / 2**30:.2f} GiB the earlier phases hold); "
              f"launches over 5 G+D, 1 G-only, 1 eval, 1 visuals "
              f"{launches}; batch 16, {s}^2, conv_dim 64, 6 res blocks, "
              f"PatchGAN 4 layers instance, VGG19 + Sphere20a on, float32 "
              f"master", flush=True)
        print(f"train ({dtype}): losses step 1 "
              f"{ {k: round(v, 5) for k, v in metrics[0].items()} }, step "
              f"5 { {k: round(v, 5) for k, v in metrics[4].items()} }, eval "
              f"{ {k: round(v, 5) for k, v in m_eval.items()} }; share of "
              f"each net's weights moved: G min {min(moved['G']):.4f}, D "
              f"mean {float(np.mean(moved['D'])):.4f}", flush=True)
        del st, tr, w0
        torch.cuda.empty_cache()
    w_err, t_err, cov, gap = twins
    print(f"train raster vs plain twins on the step's 16 bodies ({s}^2): "
          f"fim equal, coverage {cov:.4f}, max |dw| {w_err}, max |dT| "
          f"{t_err}; body_recovery_flow's largest output gap {gap}",
          flush=True)

    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    m_c, loss_gap, gaps, flips = train_step_card_vs_cpu(tt, assets, dev)
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    print(f"train step card vs CPU, float32, TF32 off (128^2, conv_dim 64, "
          f"6 res blocks, batch 2, VGG + face on): losses { {k: round(v, 5) for k, v in m_c.items()} }, max "
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
    by_path["train_cli"] = cli_phase(cr)
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


def codec_checks(native, dev, tmp):
    """Phase 12's codec checks: 64 seeded 256² frames through the card's
    encoder and decoder (PSNR), the committed fixtures' decodes and
    resizes. Returns the frame paths."""
    import numpy as np
    import torch
    s = GEOM["s"]
    frames = smooth_frames(IO_FRAMES, s, seed=3)
    fdir = tmp / "frames"
    fdir.mkdir()
    paths, worst = [], np.inf
    for i, f in enumerate(frames):
        data = native.encode_jpeg(torch.from_numpy(f).to(dev), device=dev)
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
          f"{s}^2 encoded at quality 95, 4:2:0, decoded back at >= "
          f"{worst:.2f} dB PSNR; fixtures against their OpenCV decodes (max "
          f"gap, share over 2 levels) {gaps}; resize_u8 equal to JAX's "
          f"native on all four", flush=True)
    return paths


def stream_checks(cr, imi, assets, src_img, thetas, paths, native, cs, dev):
    """Phase 12's stream checks on a float32 task: u8 and I420 readback
    against the float preds, the colour transforms card vs CPU, and the
    I420 ingest."""
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
          f"vs inference {ingest_gap:.2e}; launches {launches}", flush=True)
    del imit
    torch.cuda.empty_cache()


def serve_checks(cr, cfg, paths, req_thetas, src_img, native, dev):
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
    finally:
        server.shutdown()
        thread.join(timeout=30)
        server.server_close()
        service.close()
    print(f"serve over localhost (bf16 Imitator, batch {IO_BATCH}): "
          f"/imitate of {len(req_thetas)} thetas (a JPEG each back), "
          f"/imitate_frames of {IO_BATCH} JPEG frames; a malformed body 400 "
          f"and the next 200; /imitate_video {code} (ffmpeg "
          f"{'present' if have_ffmpeg() else 'absent'}); memory allocated "
          f"after 10 /imitate requests {mem[-1][0] / 2**30:.3f} GiB (first "
          f"{mem[0][0] / 2**30:.3f}), peak {mem[-1][1] / 2**30:.3f} GiB "
          f"(first {mem[0][1] / 2**30:.3f}); launches {launches}",
          flush=True)
    return launches


def cli_checks(native, src_img, paths, dev, tmp):
    """Phase 12's CLI checks: each entry point as a subprocess with
    --device cuda at 256²; run_imitator alone first, then the others
    together."""
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

    wait(subprocess.Popen(cmd("run_imitator", "imit", "--src_path",
                              str(src), "--tgt_path", fdir, "--name", "a"),
                          cwd=root, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True),
         "run_imitator")
    jobs = {
        "run_imitator --i420": cmd("run_imitator", "imit420", "--src_path",
                                   str(src), "--tgt_path", fdir, "--i420",
                                   "--name", "b"),
        "run_swap": cmd("run_swap", "swap", "--src_path", str(src),
                        "--tgt_path", paths[0], "--name", "c"),
        "run_view": cmd("run_view", "view", "--src_path", str(src),
                        "--name", "d"),
        "demos imitator": cmd("demos", "demo", "imitator", "--name", "e")}
    procs = {k: subprocess.Popen(v, cwd=root, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, v in jobs.items()}
    for k, p in procs.items():
        wait(p, k)
    for out in ("imit", "imit420"):
        preds = sorted((tmp / out).glob("pred_*"))
        check(len(preds) == IO_FRAMES and all(
            native.read_image(str(p), dev).shape == (GEOM["s"], GEOM["s"], 3)
            for p in preds), f"{out}: {len(preds)} decodable pred files")
    check((tmp / "swap" / "swap_result.png").exists(), "no swap_result.png")
    check(len(list((tmp / "view").glob("view_*.png"))) == 16,
          "run_view did not write 16 views")
    print(f"CLIs (subprocesses, --device {dev.type}, {GEOM['s']}^2): "
          f"run_imitator on {IO_FRAMES} frames, then run_imitator --i420, "
          f"run_swap, run_view (16 views) and demos imitator together; "
          f"{IO_FRAMES} decodable pred files each", flush=True)


def host_io_phase(cr, imi, imit_h, assets, cfg, src_img, thetas, req_thetas,
                  dev):
    """Phase 12 (module docstring); returns {path: launch counts}."""
    import tempfile
    from impersonator_tpu_torch.data import native
    from impersonator_tpu_torch.ops import colorspace as cs
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        paths = codec_checks(native, dev, tmp)
        stream_checks(cr, imi, assets, src_img, thetas, paths, native, cs,
                      dev)
        launches = {}
        for k, kw in (("u8", dict(as_uint8=True)),
                      ("i420", dict(as_i420=True))):
            reset_counts(cr)
            imit_h.inference_from_paths(paths, batch=IO_BATCH, **kw)
            launches[f"host_io_{k}"] = read_counts(cr)
            check(launches[f"host_io_{k}"]["zbuffer_bucket_flow"]
                  == IO_FRAMES // IO_BATCH,
                  f"{k} stream launches {launches[f'host_io_{k}']}")
        launches["serve_imitate"] = serve_checks(
            cr, cfg, paths, req_thetas, src_img, native, dev)
        cli_checks(native, src_img, paths, dev, tmp)
    return launches


# -- phase 13: the remaining trainers ----------------------------------------

def aug_train_batch(s, bs, seed):
    """train_batch plus a Places2 stand-in 'bg' (bs, s, s, 3) U(-1, 1)."""
    import numpy as np
    batch = train_batch(s, bs, seed)
    rng = np.random.default_rng(seed + 1000)
    batch["bg"] = rng.uniform(-1, 1, (bs, s, s, 3)).astype(np.float32)
    return batch


def run_steps(cr, st, batch, fns):
    """Each fn(st, batch) in turn: (state, metrics of each as floats,
    launch counts over them)."""
    reset_counts(cr)
    metrics = []
    for fn in fns:
        st, m = fn(st, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return st, metrics, read_counts(cr)


def weights(st):
    """A copy of G's and D's weights, {"G.<name>" | "D.<name>": tensor}."""
    return {f"{n}.{k}": p.detach().clone()
            for n, net in (("G", st.generator), ("D", st.discriminator))
            for k, p in net.named_parameters()}


def moved_and_master(st, w0):
    """(share of each G tensor's weights that moved: the least over the
    tensors the last step sent a gradient, mean share of D's; whether the
    masters and Adam's moments are float32), against w0 (weights(st)
    before the steps). feature_warping's source decoder feeds no loss:
    its tensors get no gradient and stay."""
    import numpy as np
    import torch
    nets = (("G", st.generator), ("D", st.discriminator))
    moved = {n: [float((p.detach() != w0[f"{n}.{k}"]).float().mean())
                 for k, p in net.named_parameters()
                 if bool(p.grad.ne(0).any())] for n, net in nets}
    master = all(p.dtype == torch.float32 and
                 opt.state[p]["exp_avg"].dtype == torch.float32
                 for (_, net), opt in zip(nets, (st.g_opt, st.d_opt))
                 for p in net.parameters())
    return min(moved["G"]), float(np.mean(moved["D"])), master


def aug_step_card_vs_cpu(ta, assets, dev):
    """One float32 aug step (TF32 off) on the CPU and on the card from the
    same weights, fresh Adam states and the CPU's raster products (128²,
    conv_dim 64, 6 res blocks, the 4-layer Global + Local D, batch 2, VGG
    and face on): (CPU losses, loss gap, G gaps, D gaps, share of
    weights whose Adam step differs)."""
    from impersonator_tpu_torch.config import TrainConfig
    from impersonator_tpu_torch.data.loader import stage_batch
    cfg = TrainConfig(image_size=128, batch_size=2, repeat_num=6,
                      model="impersonator_trainer_aug")
    tr_c = ta.build_aug_trainer(cfg, assets, device="cpu")
    tr_g = ta.build_aug_trainer(cfg, assets, device=dev)
    st_c = tr_c.init_state()
    st_g = tr_g.init_state(copy.deepcopy(st_c.generator),
                           copy.deepcopy(st_c.discriminator))
    b = stage_batch(aug_train_batch(128, 2, 5), "cpu")
    inputs, src, tsf, bg = ta.aug_inputs(tr_c, b)

    def named(st):
        return [(f"{n}.{k}", p) for n, net in (("G", st.generator),
                                               ("D", st.discriminator))
                for k, p in net.named_parameters()]
    w0 = {k: p.detach().clone() for k, p in named(st_c)}
    out = []
    for tr, st, d in ((tr_c, st_c, "cpu"), (tr_g, st_g, dev)):
        inp = {k: None if v is None else v.to(d) for k, v in inputs.items()}
        st, m = ta.make_aug_update(tr)(st, inp, src.to(d), tsf.to(d),
                                       bg.to(d))
        out.append(({k: float(v) for k, v in m.items()},
                    {k: p.grad.cpu() for k, p in named(st)},
                    {k: p.detach().cpu() for k, p in named(st)}))
    (m_c, g_c, w_c), (m_g, g_g, w_g) = out
    loss_gap = max(abs(m_g[k] - m_c[k]) / abs(m_c[k]) for k in m_c
                   if m_c[k] != 0.0)
    # both PatchGANs at 4 layers: the convs before the norms are
    # model.{2,5,8,11}
    zero = {"G": (), "D": tuple(f"D.{h}.model.{i}.bias"
                                for h in ("global_model", "local_model")
                                for i in (2, 5, 8, 11))}
    gaps = {n: grad_gaps({k: v for k, v in g_g.items() if k[0] == n},
                         {k: v for k, v in g_c.items() if k[0] == n},
                         zero[n])
            for n in "GD"}
    moved = sum(int((w_c[k] != w0[k]).sum()) for k in w0)
    flips = sum(int(((w_g[k] - w_c[k]).abs() > 1e-4).sum()) for k in w0)
    return m_c, loss_gap, gaps, flips / moved


def aug_phase(cr, ta, assets, dev):
    """Phase 13's augmented trainer at full width in bf16 and float32;
    returns ({path: launch counts}, the float32 trainer and state)."""
    import numpy as np
    import torch
    from impersonator_tpu_torch.config import TrainConfig
    from impersonator_tpu_torch.data.loader import stage_batch
    s, bs = GEOM["s"], 16
    batch = stage_batch(aug_train_batch(s, bs, 7), dev)
    by_path = {}
    for dtype in ("bfloat16", "float32"):
        base = torch.cuda.memory_allocated()
        cfg = TrainConfig(image_size=s, batch_size=bs, repeat_num=6,
                          model="impersonator_trainer_aug", train_dtype=dtype)
        tr = ta.build_aug_trainer(cfg, assets, device=dev)
        st = tr.init_state()
        step = ta.make_aug_train_step(tr, train_d=True)
        step_g = ta.make_aug_train_step(tr, train_d=False)
        st, _ = step(st, batch)                    # warm-up
        w0 = weights(st)
        torch.cuda.reset_peak_memory_stats()
        st, metrics, launches = run_steps(cr, st, batch,
                                          [step] * 5 + [step_g])
        peak = torch.cuda.max_memory_allocated() - base
        path = "train_aug" if dtype == "bfloat16" else "train_aug_fp32"
        by_path[path] = launches
        check(launches["zbuffer_bucket_rows"] == 6 and
              launches["zbuffer_bucket_flow"] == 6,
              f"{path} launches {launches} (1 each a step, 6 steps)")
        check(all(np.isfinite(list(m.values())).all() for m in metrics),
              f"{path}: non-finite losses {metrics}")
        check("d_loss" not in metrics[-1] and "d_loss" in metrics[0],
              f"{path}: the G-only step's metrics")
        g_moved, d_moved, master = moved_and_master(st, w0)
        check(g_moved > 0.5 and d_moved > 0.5,
              f"{path}: weights moved G {g_moved}, D {d_moved}")
        check(master, f"{path}: the master or Adam's moments left float32")
        print(f"train_aug ({dtype}): peak memory {peak / 2**30:.2f} GiB above "
              f"the {base / 2**30:.2f} GiB the earlier phases hold; launches "
              f"over 5 G+D + 1 G-only {launches}; batch 16, {s}^2, conv_dim "
              f"64, 6 res blocks, Global + Local PatchGAN 4 layers "
              f"instance, VGG19 + Sphere20a on, float32 master", flush=True)
        print(f"train_aug ({dtype}): losses step 1 "
              f"{ {k: round(v, 5) for k, v in metrics[0].items()} }, step 5 "
              f"{ {k: round(v, 5) for k, v in metrics[4].items()} }; share "
              f"of weights moved: G min {g_moved:.4f}, D mean "
              f"{d_moved:.4f}", flush=True)
        if dtype == "bfloat16":
            del st, tr
            torch.cuda.empty_cache()
    return by_path, tr, st


def baseline_phase(cr, tb, smpl_ops, assets, dev):
    """Phase 13's three ablation baselines at full width in float32 (VGG
    and face on): a warm-up step, then 3 G+D steps each; and
    texture_warping's texture card vs CPU. Returns {path: launches}."""
    import numpy as np
    import torch
    from impersonator_tpu_torch.config import TrainConfig
    from impersonator_tpu_torch.data.loader import stage_batch
    s, bs = GEOM["s"], 16
    batch = stage_batch(train_batch(s, bs, 9), dev)
    by_path = {}
    for mode in tb.BASELINE_MODES:
        base = torch.cuda.memory_allocated()
        cfg = TrainConfig(image_size=s, batch_size=bs, repeat_num=6,
                          model=mode)
        tr = tb.build_baseline_trainer(cfg, assets, device=dev)
        st = tr.init_state()
        step = tb.make_train_step(tr)
        st, _ = step(st, batch)                    # warm-up
        w0 = weights(st)
        torch.cuda.reset_peak_memory_stats()
        st, metrics, launches = run_steps(cr, st, batch, [step] * 3)
        peak = torch.cuda.max_memory_allocated() - base
        by_path[f"train_{mode}"] = launches
        check(launches["zbuffer_bucket_rows"] == 6 and
              launches["zbuffer_bucket_flow"] == 0,
              f"{mode} launches {launches} (2 rows a step, 3 steps)")
        check(all(np.isfinite(list(m.values())).all() for m in metrics)
              and "d_total" in metrics[0], f"{mode}: losses {metrics}")
        g_moved, d_moved, master = moved_and_master(st, w0)
        check(g_moved > 0.5 and d_moved > 0.5 and master,
              f"{mode}: weights moved G {g_moved}, D {d_moved}, float32 "
              f"{master}")
        print(f"train_{mode} (float32): peak memory {peak / 2**30:.2f} GiB; "
              f"launches over 3 steps {launches}; batch 16, {s}^2, conv_dim "
              f"64, 6 res blocks, PatchGAN 4 layers over 9 channels, VGG19 "
              f"+ Sphere20a on; losses step 1 "
              f"{ {k: round(v, 5) for k, v in metrics[0].items()} }",
              flush=True)
        if mode == "texture_warping":
            tex_err = texture_card_vs_cpu(tr, smpl_ops, assets, batch)
            print(f"texture_warping: extract_texture + render_textured on "
                  f"the card against the CPU on the CPU's raster (2 "
                  f"bodies, {s}^2, tex_size {tr.renderer.tex_size}): max "
                  f"|d| {tex_err} (bound {TEX_TOL})", flush=True)
            check(tex_err <= TEX_TOL, f"texture card vs CPU {tex_err}")
        del st, tr
        torch.cuda.empty_cache()
    return by_path


def texture_card_vs_cpu(tr, smpl_ops, assets, batch):
    """The texture-warping input of 2 batch items: the CPU renderer's
    source and target rasters, then extract_texture + render_textured on
    the CPU and on the card from the same cameras, vertices, fim and wim.
    Returns max |d|."""
    from impersonator_tpu_torch.tasks.renderer import SMPLRenderer
    r_c = SMPLRenderer.create(assets, "cpu", image_size=GEOM["s"])
    params = smpl_ops.SMPLParams.from_assets(assets, "cpu")
    smpls = batch["smpls"][:2].cpu()
    img = batch["images"][:2, 0].cpu().permute(0, 2, 3, 1).contiguous()
    src = smpl_ops.get_details(params, smpls[:, 0], assets.parents)
    ref = smpl_ops.get_details(params, smpls[:, 1], assets.parents)
    _, fim, wim = r_c.render_fim_wim(ref["cam"], ref["verts"])
    out = []
    for r, d in ((r_c, "cpu"), (tr.renderer, tr.device)):
        tex = r.extract_texture(img.to(d), src["cam"].to(d),
                                src["verts"].to(d))
        out.append(r.render_textured(fim.to(d), wim.to(d), tex).cpu())
    return float((out[0] - out[1]).abs().max())


def soft_silhouette_checks(rast, soft, smpl_ops, assets, dev):
    """soft_silhouette and the gradient of a silhouette loss with respect
    to the camera on the 12,880-face body, card vs CPU at 128² (batch 1),
    and the card's forward + backward peak memory at 256² (batch 2).
    Returns (max |dsil|, gradient gap)."""
    import numpy as np
    import torch
    params = smpl_ops.SMPLParams.from_assets(assets, "cpu")
    faces = torch.as_tensor(np.asarray(assets.faces, np.int64))
    theta = torch.from_numpy(train_batch(128, 2, 11)["smpls"][:, 0])
    info = smpl_ops.get_details(params, theta, assets.parents)
    target = soft.soft_silhouette(rast.project_to_raster_space(
        info["verts"][:1], info["cam"][:1] * 1.05, faces), 128)

    def run(d, cam, verts, s):
        cam = cam.to(d).requires_grad_(True)
        fv = rast.project_to_raster_space(verts.to(d), cam, faces.to(d))
        sil = soft.soft_silhouette(fv, s)
        loss = ((sil - target.to(d)) ** 2).sum() if s == 128 else sil.sum()
        loss.backward()
        return sil.detach().cpu(), cam.grad.cpu()

    sil_c, g_c = run("cpu", info["cam"][:1], info["verts"][:1], 128)
    sil_g, g_g = run(dev, info["cam"][:1], info["verts"][:1], 128)
    sil_err = float((sil_g - sil_c).abs().max())
    g_gap = float((g_g - g_c).norm() / g_c.norm())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run(dev, info["cam"], info["verts"], GEOM["s"])
    peak = torch.cuda.max_memory_allocated() - base
    print(f"soft_silhouette, 12,880 faces: card vs CPU at 128^2 max |dsil| "
          f"{sil_err} (bound {SIL_TOL}), camera gradient relative L2 gap "
          f"{g_gap:.3e} (bound {SIL_GRAD_RTOL}); forward + backward at "
          f"{GEOM['s']}^2, batch 2: peak memory {peak / 2**30:.2f} GiB "
          f"(each face chunk recomputed in the backward)", flush=True)
    check(sil_err <= SIL_TOL, f"soft silhouette card vs CPU {sil_err}")
    check(g_gap <= SIL_GRAD_RTOL, f"soft silhouette gradient {g_gap}")
    return sil_err, g_gap


def write_data_tree(root, native, dev, s):
    """A small iPER + Places2 + DeepFashion tree under root, every image a
    JPEG from the card's encoder: 12 videos of 3 frames at s² with
    pose_shape.pkl, 6 Places2 images larger than s² and 4 DeepFashion
    pairs with _smpl.pkl files. Returns the three folders."""
    import os
    import pickle
    import numpy as np
    rng = np.random.default_rng(13)
    frames = smooth_frames(36 + 8, s, 21)
    places = smooth_frames(6, s + 48, 22)

    def jpeg(path, img):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(native.encode_jpeg(img, device=dev))

    def thetas(n):
        t = train_batch(8, n, int(rng.integers(1 << 30)))["smpls"][:, 0]
        return {"cams": t[:, :3], "pose": t[:, 3:75], "shape": t[:, 75:]}

    iper, place, fashion = (os.path.join(root, d)
                            for d in ("iPER", "places", "fashion"))
    vids = [f"{v:03d}/1/1" for v in range(12)]
    for v, vid in enumerate(vids):
        for i in range(3):
            jpeg(os.path.join(iper, "images_HD", vid, f"{i:04d}.jpg"),
                 frames[3 * v + i])
        os.makedirs(os.path.join(iper, "smpls", vid))
        with open(os.path.join(iper, "smpls", vid, "pose_shape.pkl"),
                  "wb") as f:
            pickle.dump(thetas(3), f)
    with open(os.path.join(iper, "train.txt"), "w") as f:
        f.write("\n".join(vids) + "\n")
    for i, img in enumerate(places):
        jpeg(os.path.join(place, f"cat{i % 2}", f"{i:04d}.jpg"), img)
    lines = []
    for p in range(4):
        pair = []
        for k in range(2):
            rel = f"img/p{p}_{k}.jpg"
            jpeg(os.path.join(fashion, rel), frames[36 + 2 * p + k])
            with open(os.path.join(fashion, f"img/p{p}_{k}_smpl.pkl"),
                      "wb") as f:
                pickle.dump({a: b[0] for a, b in thetas(1).items()}, f)
            pair.append(rel)
        lines.append(" ".join(pair))
    with open(os.path.join(fashion, "pairs.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return iper, place, fashion


def disk_data_step(cr, ta, native, tr, st, dev):
    """The tree of write_data_tree read by dataset_by_name(
    "iPER_fashion_place") through the loader on the card (4 threads,
    nvJPEG) into one float32 aug step. Returns the step's launches."""
    import tempfile
    import numpy as np
    import torch
    from impersonator_tpu_torch.data.datasets import dataset_by_name
    from impersonator_tpu_torch.data.loader import DataLoader
    s = GEOM["s"]
    with tempfile.TemporaryDirectory() as tmp:
        iper, place, fashion = write_data_tree(tmp, native, dev, s)
        cfg = dataclasses.replace(tr.cfg, data_dir=iper, place_dir=place,
                                  fashion_dir=fashion)
        ds = dataset_by_name("iPER_fashion_place", cfg, device=dev)
        check(len(ds) == 16, f"iPER_fashion_place items {len(ds)}")
        batches = list(DataLoader(ds, 16, num_workers=4, seed=0,
                                  device=dev))
        check(len(batches) == 1, f"disk batches {len(batches)}")
        batch = batches[0]
    check(batch["images"].shape == (16, 2, 3, s, s) and
          batch["bg"].shape == (16, 3, s, s) and
          batch["images"].device.type == torch.device(dev).type,
          f"disk batch {[(k, tuple(v.shape)) for k, v in batch.items()]}")
    st, metrics, launches = run_steps(cr, st, batch,
                                      [ta.make_aug_train_step(tr)])
    check(launches["zbuffer_bucket_rows"] == 1 and
          launches["zbuffer_bucket_flow"] == 1,
          f"disk aug step launches {launches}")
    check(np.isfinite(list(metrics[0].values())).all(),
          f"disk aug step losses {metrics[0]}")
    print(f"iPER + Places2 + DeepFashion on disk (60 JPEGs from the card's "
          f"encoder): iPER_fashion_place, 16 items, one batch of 16 through "
          f"the loader on the card (4 threads, nvJPEG); one float32 aug "
          f"step on it, launches {launches}, losses "
          f"{ {k: round(v, 5) for k, v in metrics[0].items()} }", flush=True)
    return launches


def trainer_cli_runs(cr):
    """cli.train.main in-process on the card at 256², batch 16, one epoch
    of the synthetic data (64 items: 4 steps) for --model
    impersonator_trainer_aug (synthetic_bg) and --model feature_warping.
    Returns {path: launches}."""
    import tempfile
    from impersonator_tpu_torch.cli import train as cli
    by_path = {}
    want = {"impersonator_trainer_aug": (4, 4, "train_aug_cli"),
            "feature_warping": (8, 0, "train_feature_warping_cli")}
    with tempfile.TemporaryDirectory() as tmp:
        for model, (rows, flow, path) in want.items():
            reset_counts(cr)
            state = cli.main(["--model", model, "--image_size",
                              str(GEOM["s"]), "--batch_size", "16",
                              "--nepochs_no_decay", "1", "--nepochs_decay",
                              "0", "--checkpoints_dir", tmp, "--name",
                              model])
            launches = read_counts(cr)
            by_path[path] = launches
            names = {p.name for p in (Path(tmp) / model).iterdir()}
            check({f"{k}_epoch_1_id_{l}.pth" for k in ("net", "opt")
                   for l in "GD"} <= names, f"{model} files {sorted(names)}")
            p = next(state.generator.parameters())
            n_adam = int(state.g_opt.state[p]["step"])
            check(n_adam == 4, f"{model} Adam steps {n_adam}")
            check(launches["zbuffer_bucket_rows"] == rows and
                  launches["zbuffer_bucket_flow"] == flow,
                  f"{model} cli launches {launches}")
            print(f"cli.train --model {model}: one epoch (4 steps, batch "
                  f"16, {GEOM['s']}^2, float32, dataset auto), checkpoint "
                  f"files written, launches {launches}", flush=True)
    return by_path


def remaining_trainers_phase(cr, smpl_ops, assets, dev):
    """Phase 13 (module docstring); returns {path: launch counts}."""
    import torch
    from impersonator_tpu_torch.data import native
    from impersonator_tpu_torch.ops import rasterizer as rast
    from impersonator_tpu_torch.ops import soft_raster as soft
    from impersonator_tpu_torch.tasks import trainer_aug as ta
    from impersonator_tpu_torch.tasks import trainer_baseline as tb
    by_path, tr, st = aug_phase(cr, ta, assets, dev)
    by_path["train_aug_disk"] = disk_data_step(cr, ta, native, tr, st, dev)
    del st, tr
    torch.cuda.empty_cache()
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    m_c, loss_gap, gaps, flips = aug_step_card_vs_cpu(ta, assets, dev)
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    print(f"train_aug step card vs CPU, float32, TF32 off (128^2, conv_dim "
          f"64, 6 res blocks, batch 2, VGG + face on): losses { {k: round(v, 5) for k, v in m_c.items()} }, max "
          f"relative gap {loss_gap:.3e} (bound {TUNE_LOSS_RTOL}); gradient "
          f"L2 gap per tensor / over all: G {gaps['G'][0]:.3e} / "
          f"{gaps['G'][1]:.3e}, D {gaps['D'][0]:.3e} / {gaps['D'][1]:.3e} "
          f"(bounds {TUNE_GRAD_RTOL} / {TUNE_GRAD_ALL_RTOL}; D's "
          f"{gaps['D'][2]} left out per tensor: 0 in exact arithmetic); "
          f"weights whose Adam step differs {flips:.3e} of those moved "
          f"(bound {TUNE_STEP_FLIPS})", flush=True)
    check(loss_gap <= TUNE_LOSS_RTOL, f"aug losses card vs CPU {loss_gap}")
    for n in "GD":
        check(gaps[n][0] <= TUNE_GRAD_RTOL and
              gaps[n][1] <= TUNE_GRAD_ALL_RTOL,
              f"aug {n} gradient card vs CPU {gaps[n]}")
    check(flips <= TUNE_STEP_FLIPS, f"aug step card vs CPU: {flips}")
    by_path.update(baseline_phase(cr, tb, smpl_ops, assets, dev))
    soft_silhouette_checks(rast, soft, smpl_ops, assets, dev)
    by_path.update(trainer_cli_runs(cr))
    return by_path


# -- phase 14: the evaluation suite ------------------------------------------

def rel_gap(card, cpu):
    """max |card - cpu| / max |cpu| (card's tensor brought to the host)."""
    import torch
    card = torch.as_tensor(card).detach().float().cpu()
    cpu = torch.as_tensor(cpu).detach().float()
    return float((card - cpu).abs().max() / cpu.abs().max())


def batched(fn, x, batch=16):
    """fn over x in batches of ``batch``; tuple outputs concatenated."""
    import torch
    outs = [fn(x[i:i + batch]) for i in range(0, x.shape[0], batch)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


def seeded_net(cls, seed, init=None):
    """cls() with PyTorch's default initialisation drawn on the CPU from
    seed (or ``init(net, generator)``), in eval mode."""
    import torch
    torch.manual_seed(seed)
    net = cls()
    if init is not None:
        init(net, torch.Generator().manual_seed(seed))
    return net.eval().requires_grad_(False)


def he_init(net, generator):
    """Conv and dense weights N(0, 2 / fan_in), biases 0: activations keep
    their scale through ReLU stacks, so a deep random net's features still
    tell images apart (PyTorch's default init shrinks them layer by
    layer, and a random InceptionV3's pool3 features come out nearly
    equal for all images)."""
    import torch
    for m in net.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * (2.0 / m.weight[0].numel()) ** 0.5)
            if m.bias is not None:
                m.bias.zero_()


def metric_nets_checks(dev):
    """Phase 14's nets at full size, float32 without TF32: LPIPS on 64
    pairs at 256² and each embed net on 64 images, batch 16; each against
    the CPU on the same weights and inputs. Returns the seeded nets."""
    import numpy as np
    import torch
    from impersonator_tpu_torch.cli import evaluate as ev
    from impersonator_tpu_torch.metrics import reid, unpaired, zoo
    from impersonator_tpu_torch.models.facenet import (SENet50, Sphere20a,
                                                       init_facenet)
    cpu = torch.device("cpu")
    frames = smooth_frames(2 * EVAL_IMAGES, GEOM["s"], 31)
    x = torch.from_numpy(frames.astype(np.float32) / 127.5 - 1.0)
    a_c, b_c = x[:EVAL_IMAGES], x[EVAL_IMAGES:]
    a_g, b_g = a_c.to(dev), b_c.to(dev)

    lp_g = ev.lpips_apply_fn(ev.load_lpips(ev.REAL_LPIPS_LIN, dev))
    lp_c = ev.lpips_apply_fn(ev.load_lpips(ev.REAL_LPIPS_LIN, cpu))
    for i in range(0, EVAL_IMAGES, 16):
        lp_g(a_g[i:i + 16], b_g[i:i + 16])
    lp_rel = rel_gap(lp_g(a_g[:16], b_g[:16]), lp_c(a_c[:16], b_c[:16]))
    print(f"LPIPS (alex, the repository's v0.1 lin heads, a seeded "
          f"backbone), {EVAL_IMAGES} pairs at {GEOM['s']}^2, batch 16; card "
          f"vs CPU on 16 pairs {lp_rel:.3e} (bound {EVAL_NET_RTOL})",
          flush=True)
    check(lp_rel <= EVAL_NET_RTOL, f"LPIPS card vs CPU {lp_rel}")

    inc_c = seeded_net(zoo.InceptionV3, 41, torch.no_grad()(he_init))
    inc_fn_g = unpaired.inception_embed_fn(copy.deepcopy(inc_c).to(dev))
    inc_fn_c = unpaired.inception_embed_fn(inc_c)
    pool_g, probs_g = batched(inc_fn_g, a_g)
    pool_c, probs_c = batched(inc_fn_c, a_c)
    pool_rel, probs_rel = rel_gap(pool_g, pool_c), rel_gap(probs_g, probs_c)
    half = EVAL_IMAGES // 2

    def fid(pool):
        pool = pool.detach().float().cpu().numpy()
        m1, s1 = unpaired.gaussian_stats(pool[:half])
        m2, s2 = unpaired.gaussian_stats(pool[half:])
        return unpaired.frechet_distance(m1, s1, m2, s2)

    fid_g, fid_c = fid(pool_g), fid(pool_c)
    fid_rel = abs(fid_g - fid_c) / abs(fid_c)
    is_g = unpaired.inception_score(probs_g.cpu().numpy())
    print(f"InceptionV3 (seeded), {EVAL_IMAGES} images resized to 299^2, "
          f"batch 16; card vs CPU: pool3 "
          f"{pool_rel:.3e}, probs {probs_rel:.3e} (bound {EVAL_NET_RTOL}); "
          f"FID of {half} vs {half} images card {fid_g:.6f}, CPU "
          f"{fid_c:.6f}, relative gap {fid_rel:.3e} (bound {EVAL_FID_RTOL});"
          f" IS {is_g:.6f}", flush=True)
    check(pool_rel <= EVAL_NET_RTOL, f"InceptionV3 pool3 card vs CPU "
          f"{pool_rel}")
    check(fid_rel <= EVAL_FID_RTOL, f"FID card vs CPU {fid_rel}")

    nets = {
        "InceptionResnetV1": (unpaired.facenet_ir_embed_fn,
                              seeded_net(zoo.InceptionResnetV1, 42)),
        "SENet50": (unpaired.senet_face_embed_fn,
                    seeded_net(SENet50, 43, init_facenet)),
        "Sphere20a": (unpaired.sphere_face_embed_fn,
                      seeded_net(Sphere20a, 44, init_facenet)),
        "OSNet": (reid.osnet_reid_embed_fn, seeded_net(reid.OSNet, 45)),
        "PCB": (reid.pcb_reid_embed_fn, seeded_net(reid.PCBReid, 46)),
    }
    for name, (make_fn, net_c) in nets.items():
        fn_g = make_fn(copy.deepcopy(net_c).to(dev))
        batched(fn_g, a_g)
        gap = rel_gap(fn_g(a_g[:4]), make_fn(net_c)(a_c[:4]))
        print(f"{name} (seeded) embeddings of {EVAL_IMAGES} images, batch "
              f"16; card vs CPU on 4 images {gap:.3e} (bound "
              f"{EVAL_NET_RTOL})", flush=True)
        check(gap <= EVAL_NET_RTOL, f"{name} card vs CPU {gap}")
    seeded = {"inception": inc_c, "facenet_ir": nets["InceptionResnetV1"][1],
              "senet50": nets["SENet50"][1], "sphere": nets["Sphere20a"][1],
              "osnet": nets["OSNet"][1], "pcb": nets["PCB"][1]}
    return seeded


def mtcnn_checks(dev):
    """MTCNN with the repository's weights on EVAL_MTCNN frames (16 of
    256²), each with a drawn face (scenes.face_image), on the card and
    the CPU: the same count of boxes per frame, corners within
    EVAL_BOX_PX."""
    import numpy as np
    from impersonator_tpu_torch.cli import evaluate as ev
    from impersonator_tpu_torch.metrics.mtcnn import load_mtcnn
    from impersonator_tpu_torch.scenes import face_image
    rng = np.random.default_rng(47)
    n, s = EVAL_MTCNN
    imgs = np.stack([face_image(s, s, *rng.uniform(0.375 * s, 0.625 * s, 2),
                                rng.uniform(0.12 * s, 0.21 * s), seed=i)
                     for i in range(n)])
    det_g = load_mtcnn(ev.REAL_MTCNN, device=dev)
    det_c = load_mtcnn(ev.REAL_MTCNN, device="cpu")
    boxes_g, _ = det_g.detect(imgs)
    boxes_c, _ = det_c.detect(imgs)
    counts = [len(b) for b in boxes_c]
    check([len(b) for b in boxes_g] == counts,
          f"MTCNN box counts card {[len(b) for b in boxes_g]} vs CPU "
          f"{counts}")
    check(sum(counts) >= len(imgs), f"MTCNN found {counts} faces")
    gap = max(float(np.abs(bg[np.argsort(bg[:, 0]), :4]
                           - bc[np.argsort(bc[:, 0]), :4]).max())
              for bg, bc in zip(boxes_g, boxes_c) if len(bc))
    print(f"MTCNN (the repository's P / R / O-net weights) on {n} frames "
          f"of {s}^2: {sum(counts)} boxes on both devices ({counts}), "
          f"corners card vs CPU within {gap:.3e} px (bound {EVAL_BOX_PX})",
          flush=True)
    check(gap <= EVAL_BOX_PX, f"MTCNN boxes card vs CPU {gap}")


def write_eval_tree(root, native, dev):
    """An iPER tree under root: EVAL_VIDEOS videos of EVAL_FRAMES seeded
    smooth JPEG frames at 256² from the card's encoder
    (images_HD/{vid}/%08d.jpg), θs of the JAX bench's train point in
    smpls/{vid}/pose_shape.pkl, and a protocol in the standard schema:
    self-imitation over every frame, cross-imitation of the next video.
    Returns the protocol file."""
    import os
    import pickle
    import numpy as np
    rng = np.random.default_rng(48)
    frames = smooth_frames(EVAL_VIDEOS * EVAL_FRAMES, GEOM["s"], 32)
    vids = [f"{v:03d}/1/1" for v in range(EVAL_VIDEOS)]
    names = [f"{i:08d}.jpg" for i in range(EVAL_FRAMES)]
    for v, vid in enumerate(vids):
        d = os.path.join(root, "images_HD", vid)
        os.makedirs(d)
        for i, name in enumerate(names):
            with open(os.path.join(d, name), "wb") as f:
                f.write(native.encode_jpeg(frames[v * EVAL_FRAMES + i],
                                           device=dev))
        t = train_batch(8, EVAL_FRAMES, int(rng.integers(1 << 30)))
        t = t["smpls"][:, 0]
        os.makedirs(os.path.join(root, "smpls", vid))
        with open(os.path.join(root, "smpls", vid, "pose_shape.pkl"),
                  "wb") as f:
            pickle.dump({"cams": t[:, :3], "pose": t[:, 3:75],
                         "shape": t[:, 75:]}, f)
    last = EVAL_FRAMES - 1
    proto = {"val": {vid: {
        "source": [names[0]], "view angle": [0], "s_n": {"1": [names[0]]},
        "self_imitation": {"target": vid, "range": [0, last]},
        "cross_imitation": {"target": vids[(v + 1) % len(vids)],
                            "range": [0, last]},
        "flag": [0, last]} for v, vid in enumerate(vids)}}
    path = os.path.join(root, "iPER_protocol.json")
    with open(path, "w") as f:
        json.dump(proto, f)
    return path


# a small darknet graph of every layer kind metrics/yolo.py builds (convs
# with and without BatchNorm, both maxpools, a shortcut, routes, an
# upsample, two YOLO heads over 4 classes, class 0 a person); its seeded
# weights stand in for yolov3-spp's, which the repository does not hold
YOLO_CFG = """[net]
width=256
height=256
channels=3

[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[shortcut]
from=-2
activation=linear

[convolutional]
batch_normalize=1
filters=32
size=3
stride=2
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=32
size=3
stride=2
pad=1
activation=leaky

[maxpool]
size=2
stride=1

[maxpool]
size=5
stride=1

[route]
layers=-1,-2

[convolutional]
filters=27
size=1
stride=1
pad=1
activation=linear

[yolo]
mask=0,1,2
anchors=10,14, 23,27, 37,58, 81,82, 135,169, 344,319
classes=4

[route]
layers=3

[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=leaky

[upsample]
stride=2

[convolutional]
filters=27
size=1
stride=1
pad=1
activation=linear

[yolo]
mask=3,4,5
anchors=10,14, 23,27, 37,58, 81,82, 135,169, 344,319
classes=4
"""


def write_yolo(root, seed=49):
    """YOLO_CFG and a seeded darknet .weights file for it (the header of
    five int32, then per conv its BatchNorm bias, scale, mean, variance
    or its bias, then the OIHW kernel, float32)."""
    import numpy as np
    from impersonator_tpu_torch.metrics import yolo
    cfg = root / "yolo.cfg"
    cfg.write_text(YOLO_CFG)
    rng = np.random.default_rng(seed)
    chunks = []
    for ld in yolo.build_layers(yolo.parse_darknet_cfg(str(cfg))):
        if ld["type"] != "convolutional":
            continue
        co, ci, k = ld["filters"], ld["in_ch"], ld["size"]
        if ld["bn"]:
            chunks += [rng.normal(0, 0.1, co), rng.uniform(0.5, 1.5, co),
                       rng.normal(0, 0.1, co), rng.uniform(0.5, 1.5, co)]
        else:
            chunks.append(rng.normal(0, 0.1, co))
        chunks.append(rng.standard_normal(co * ci * k * k)
                      / np.sqrt(ci * k * k))
    weights = root / "yolo.weights"
    with open(weights, "wb") as f:
        np.zeros(5, np.int32).tofile(f)
        np.concatenate(chunks).astype(np.float32).tofile(f)
    return str(cfg), str(weights)


def write_eval_weights(root, seeded):
    """The evaluator's weight files of phase 14's seeded nets, written on
    this host without flax: each net's state dict (the reference's keys)
    through utils.convert.TO_JAX and utils.checkpoint.write_flax_msgpack;
    read back by read_flax_msgpack + FROM_JAX equal to the net bit for
    bit, and a second write the same bytes. Plus write_yolo's pair.
    Returns {flag: path}."""
    import torch
    from impersonator_tpu_torch.utils import convert as C
    from impersonator_tpu_torch.utils.checkpoint import (flax_msgpack_bytes,
                                                         read_flax_msgpack,
                                                         write_flax_msgpack)
    flags = {"inception": "--inception_path", "facenet_ir": "--facenet_path",
             "senet50": "--senet_path", "sphere": "--sphere_path",
             "osnet": "--osnet_path", "pcb": "--pcb_path"}
    out, sizes = {}, {}
    for kind, net in seeded.items():
        sd = net.state_dict()
        tree = C.TO_JAX[kind](sd)
        path = write_flax_msgpack(tree, str(root / f"{kind}.msgpack"))
        data = Path(path).read_bytes()
        check(flax_msgpack_bytes(tree) == data, f"{kind}: two writes differ")
        back = C.FROM_JAX[kind](read_flax_msgpack(path))
        check(all(torch.equal(back[k], v) for k, v in sd.items()
                  if not k.endswith("num_batches_tracked")),
              f"{kind}: the file does not read back to the net")
        out[flags[kind]] = path
        sizes[kind] = len(data)
    out["--yolo_cfg"], out["--yolo_weights"] = write_yolo(root)
    print(f"evaluator weight files written on this host (TO_JAX + "
          f"write_flax_msgpack, each read back bit-equal): "
          f"{ {k: f'{v / 2**20:.1f} MiB' for k, v in sizes.items()} }, a "
          f"seeded darknet graph for --yolo_cfg / --yolo_weights",
          flush=True)
    return out


@contextlib.contextmanager
def card_decoder_for_cpu(native):
    """The card's host has no libjpeg, so the codec's CPU build cannot be
    made there. Inside the block a request for the "cpu" codec gets the
    card's build (nvJPEG decodes into host memory): a CPU run reads the
    same pixels as the card run, and their comparison holds the compute
    alone."""
    import torch
    load = native.load

    def card_load(device="cuda"):
        return load("cuda" if torch.device(device).type == "cpu" else device)

    native.load = card_load
    try:
        yield
    finally:
        native.load = load


def eval_gap(key, got, want, terms):
    """cli.evaluate's card-vs-CPU gap of one results.json key, as
    EVAL_BOUNDS, EVAL_CARD_BOUNDS and EVAL_FD_RTOL bound it (a distance's
    gap over ``terms[want]``, its CPU terms); (gap, bound)."""
    if key in EVAL_FD_KEYS:
        return abs(got - want) / terms[want], EVAL_FD_RTOL[key]
    return abs(got - want), {**EVAL_BOUNDS, **EVAL_CARD_BOUNDS}[key]


@contextlib.contextmanager
def eval_terms():
    """Inside the block each Fréchet distance the unpaired metrics take
    records the size of its terms, |mu1 - mu2|² + Tr(S1 + eps) + Tr(S2 +
    eps) (frechet_distance_of's eps), under its value: {distance:
    terms}."""
    import numpy as np
    from impersonator_tpu_torch.metrics.unpaired import UnpairedMetricRunner
    fd, terms, eps = UnpairedMetricRunner._fd, {}, 1e-6

    def fd_terms(pred, ref):
        v = fd(pred, ref)
        p, r = np.asarray(pred, np.float64), np.asarray(ref, np.float64)
        terms[v] = float(np.sum((p.mean(0) - r.mean(0)) ** 2)
                         + np.var(p, 0, ddof=1).sum()
                         + np.var(r, 0, ddof=1).sum() + 2 * p.shape[1] * eps)
        return v

    UnpairedMetricRunner._fd = staticmethod(fd_terms)
    try:
        yield terms
    finally:
        UnpairedMetricRunner._fd = staticmethod(fd)


def evaluate_cli_checks(cr, native, dev, weights):
    """cli.evaluate.main on the card on write_eval_tree's tree (256²,
    conv_dim 64, 6 res blocks, bf16) with every extractor: LPIPS on the
    repository's lin heads, MTCNN on its weights, ``weights``' InceptionV3,
    InceptionResnetV1 (the face net; SENet50 and Sphere20a are its
    fallbacks, also passed), OSNet, PCB and YOLO files, and --sspe: the
    frames evaluated, exact launch counts; then the same
    command in float32 with TF32 off, one video and --max_frames 4 on the
    card and on the CPU (card_decoder_for_cpu), every key of results.json
    (self_imitation, cross_imitation, per_video) within eval_gap's bound.
    Returns {path: launch counts}."""
    import os
    import tempfile
    import numpy as np
    import torch
    from impersonator_tpu_torch.cli import evaluate as ev
    with tempfile.TemporaryDirectory() as tmp:
        proto = write_eval_tree(tmp, native, dev)
        print(f"evaluation tree: {EVAL_VIDEOS * EVAL_FRAMES} JPEGs of "
              f"{GEOM['s']}^2 from the card's encoder and their θs",
              flush=True)
        base = ["--data_dir", tmp, "--protocol_file", proto,
                "--lpips_path", ev.REAL_LPIPS_LIN, "--image_size",
                str(GEOM["s"]), "--checkpoints_dir",
                os.path.join(tmp, "ckpt"), "--name", "eval",
                "--mtcnn_path", ev.REAL_MTCNN, "--sspe",
                *[a for kv in weights.items() for a in kv]]
        out = os.path.join(tmp, "out")
        reset_counts(cr)
        res = ev.main(base + ["--output_dir", out, "--device", dev.type])
        launches = read_counts(cr)
        n = res["num_si_frames"] + res["num_ci_frames"]
        # per video: personalize (1 rows), self- and cross-imitation in
        # batches of 8 (1 flow each)
        per_clip = -(-EVAL_FRAMES // 8)
        check(n == 2 * EVAL_VIDEOS * EVAL_FRAMES, f"evaluated frames {n}")
        check(launches["zbuffer_bucket_rows"] == EVAL_VIDEOS and
              launches["zbuffer_bucket_flow"] == 2 * per_clip * EVAL_VIDEOS,
              f"cli.evaluate launches {launches}")
        on_disk = json.loads(Path(out, "results.json").read_text())
        check(on_disk["self_imitation"] == res["self_imitation"] and
              list(res["self_imitation"]) == EVAL_SELF_KEYS and
              sorted(res["cross_imitation"]) == sorted(EVAL_CROSS_KEYS) and
              all(np.isfinite(v) for part in ("self_imitation",
                                              "cross_imitation")
                  for v in res[part].values()),
              f"results {res['self_imitation']} {res['cross_imitation']}")
        check("Self-imitation Results" in Path(out, "results.txt")
              .read_text(), "results.txt")
        print(f"cli.evaluate (bf16, {EVAL_VIDEOS} videos x {EVAL_FRAMES} "
              f"frames, self- and cross-imitation): {n} frames evaluated; "
              f"self-imitation "
              f"{ {k: round(v, 5) for k, v in res['self_imitation'].items()} }"
              f", cross-imitation "
              f"{ {k: round(v, 5) for k, v in res['cross_imitation'].items()} }"
              f"; launches {launches}", flush=True)

        cmp = base + ["--compute_dtype", "float32", "--max_videos", "1",
                      "--max_frames", "4"]
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        reset_counts(cr)
        res_g = ev.main(cmp + ["--output_dir", os.path.join(tmp, "g"),
                               "--device", dev.type])
        launches_32 = read_counts(cr)
        with card_decoder_for_cpu(native), eval_terms() as terms:
            res_c = ev.main(cmp + ["--output_dir", os.path.join(tmp, "c"),
                                   "--device", "cpu"])
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
        check(launches_32["zbuffer_bucket_rows"] == 1 and
              launches_32["zbuffer_bucket_flow"] == 2,
              f"float32 cli.evaluate launches {launches_32}")
        check(sorted(res_g) == sorted(res_c) and
              list(res_g["per_video"]) == list(res_c["per_video"]),
              "card and CPU results differ in their keys")
        pairs = [(res_g[part], res_c[part])
                 for part in ("self_imitation", "cross_imitation")] + [
            (res_g["per_video"][v], res_c["per_video"][v])
            for v in res_c["per_video"]]
        gaps, bounds = {}, {}
        for got, want in pairs:
            check(list(got) == list(want), f"metric keys {list(got)}")
            for k, v in want.items():
                gap, bounds[k] = eval_gap(k, got[k], v, terms)
                gaps[k] = max(gaps.get(k, 0.0), gap)
        check(sorted(gaps) == sorted(set(EVAL_SELF_KEYS + EVAL_CROSS_KEYS)),
              f"float32 results hold {sorted(gaps)}")
        print(f"cli.evaluate float32 (TF32 off), one video, --max_frames "
              f"4, card vs CPU: self-imitation card "
              f"{ {k: round(v, 6) for k, v in res_g['self_imitation'].items()} }"
              f", cross-imitation card "
              f"{ {k: round(v, 6) for k, v in res_g['cross_imitation'].items()} }"
              f", largest gaps { {k: f'{v:.3e}' for k, v in gaps.items()} } "
              f"(bounds {bounds}; the distances' relative to their CPU "
              f"terms { {k: f'{terms[res_c['cross_imitation'][k]]:.4g}' for k in EVAL_FD_KEYS} } "
              f"in cross-imitation, the others absolute); launches "
              f"{launches_32}", flush=True)
        for k, gap in gaps.items():
            check(gap <= bounds[k], f"cli.evaluate {k} card vs CPU {gap}")
    return {"evaluate_cli": launches, "evaluate_cli_fp32": launches_32}


def evaluation_phase(cr, native, dev):
    """Phase 14 (module docstring); returns {path: launch counts}."""
    import tempfile
    seeded = metric_nets_checks(dev)
    mtcnn_checks(dev)
    with tempfile.TemporaryDirectory() as wdir:
        weights = write_eval_weights(Path(wdir), seeded)
        return evaluate_cli_checks(cr, native, dev, weights)


# -- phase 15: the multi-card code paths on one card -------------------------

def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mc_trainer(tt, assets, dev):
    """The phase-11 point in float32: 256², batch MC_BATCH, conv_dim 64, 6
    res blocks, a 4-layer PatchGAN, VGG19 + Sphere20a (seeded)."""
    from impersonator_tpu_torch.config import TrainConfig
    cfg = TrainConfig(image_size=GEOM["s"], batch_size=MC_BATCH,
                      repeat_num=6, use_vgg=True, use_style=False,
                      use_face=True, train_dtype="float32")
    return tt.build_trainer(cfg, assets, device=dev)


def mc_step(tt, tr, batch):
    """One G+D step from the config's seeded weights and fresh Adam ->
    (losses, gradients, parameters after the step)."""
    st = tr.init_state()
    st, m = tt.make_train_step(tr, train_d=True)(st, batch)
    named = [(f"{n}.{k}", p) for n, net in (("G", st.generator),
                                            ("D", st.discriminator))
             for k, p in net.named_parameters()]
    return ({k: float(v) for k, v in m.items()},
            {k: p.grad.detach().clone() for k, p in named},
            {k: p.detach().clone() for k, p in named})


def process_state():
    """What phase 15 could leave behind in this process, and how the host
    runs now: torch's intra- and inter-op threads, the cuDNN and matmul
    flags, whether a process group is up, Python's and the OS's threads,
    live child processes, the load average and glibc's heap (mallinfo2:
    the arenas' bytes, the free bytes inside them, the mmapped bytes)."""
    import ctypes
    import multiprocessing
    import os
    import threading
    import torch

    class MallInfo2(ctypes.Structure):
        _fields_ = [(n, ctypes.c_size_t) for n in (
            "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks",
            "fsmblks", "uordblks", "fordblks", "keepcost")]

    try:
        libc = ctypes.CDLL(None)
        libc.mallinfo2.restype = MallInfo2
        mi = libc.mallinfo2()
        heap = {"arena_mib": mi.arena >> 20, "free_mib": mi.fordblks >> 20,
                "mmapped_mib": mi.hblkhd >> 20}
    except (OSError, AttributeError):
        heap = None
    with open("/proc/self/status") as f:
        os_threads = next((int(ln.split()[1]) for ln in f
                           if ln.startswith("Threads:")), None)
    return {"torch_threads": torch.get_num_threads(),
            "interop_threads": torch.get_num_interop_threads(),
            "cudnn": (torch.backends.cudnn.allow_tf32,
                      torch.backends.cudnn.deterministic,
                      torch.backends.cudnn.benchmark),
            "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "dist": torch.distributed.is_initialized(),
            "py_threads": threading.active_count(),
            "os_threads": os_threads,
            "children": len(multiprocessing.active_children()),
            "loadavg": os.getloadavg(), "heap": heap}


def gloo_rank(rank, port, out_dir, dev_type):
    """Phase 15 (b), one of two processes on the one card (each held to
    MC_CARD_SHARE of its memory): the phase-11 point's float32 step on
    rows [8 rank, 8 rank + 8) of the 16-sample batch alone; then in a
    gloo group of two a probe all-reduce of a CUDA tensor,
    all_reduce_mean_ of that step's gradients, and the same step again,
    whose gradients and losses step_nets averages with the other
    process's. Writes both steps' losses and gradients, the collective's
    result, the parameters and the launch counts of the
    group's step to out_dir/rank{rank}.pt."""
    import torch
    import torch.distributed as dist
    from impersonator_tpu_torch.assets import bench_assets
    from impersonator_tpu_torch.data.loader import stage_batch
    from impersonator_tpu_torch.ops import cuda_raster as cr
    from impersonator_tpu_torch.parallel import distributed as pdist
    from impersonator_tpu_torch.tasks import trainer as tt
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device(dev_type)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_per_process_memory_fraction(MC_CARD_SHARE)
    tr = mc_trainer(tt, bench_assets(), dev)
    half = MC_BATCH // 2
    full = train_batch(GEOM["s"], MC_BATCH, MC_SEED)
    batch = stage_batch({k: v[rank * half:(rank + 1) * half]
                         for k, v in full.items()}, dev)
    m_alone, g_alone, _ = mc_step(tt, tr, batch)
    check(pdist.init_distributed(f"127.0.0.1:{port}", 2, rank,
                                 backend="gloo", device=dev),
          f"rank {rank} is not in a group of 2")
    probe = torch.full((4,), float(rank + 1), device=dev)
    dist.all_reduce(probe)
    check(probe.device == dev and bool((probe == 3.0).all()),
          f"gloo all-reduce of a {dev.type} tensor gave {probe.tolist()}")
    coll = [v.clone() for v in g_alone.values()]
    pdist.all_reduce_mean_(coll)
    reset_counts(cr)
    m, g, p = mc_step(tt, tr, batch)
    launches = read_counts(cr)
    torch.save({"metrics": m, "grads": {k: v.cpu() for k, v in g.items()},
                "alone": (m_alone, {k: v.cpu() for k, v in g_alone.items()}),
                "collective": {k: v.cpu() for k, v in zip(g_alone, coll)},
                "params": {k: v.cpu() for k, v in p.items()},
                "launches": launches,
                "device": str(dev)},
               Path(out_dir) / f"rank{rank}.pt")
    dist.destroy_process_group()


def max_loss_gap(a, b):
    """Largest |a - b| / max(|b|, 1e-3) over the loss terms of b."""
    return max(abs(a[k] - v) / max(abs(v), 1e-3) for k, v in b.items())


def nccl_world_one(tt, tr, batch, backend):
    """Phase 15 (a): the step twice without a process group, then under
    a process group of one (NCCL on the card) -> the first plain run's
    losses and gradients on the host."""
    import torch
    import torch.distributed as dist
    from impersonator_tpu_torch.parallel import distributed as pdist
    plain = [mc_step(tt, tr, batch) for _ in range(2)]
    check(not pdist.init_distributed(
        f"127.0.0.1:{free_port()}", 1, 0, backend=backend,
        device=batch["images"].device),
        "a group of one reports more processes")
    try:
        got = dist.get_backend()
        m_d, g_d, p_d = mc_step(tt, tr, batch)
        again = {k: v.clone() for k, v in g_d.items()}
        pdist.all_reduce_mean_(list(again.values()))
        identity = all(torch.equal(again[k], g_d[k]) for k in g_d)
    finally:
        dist.destroy_process_group()
    (m0, g0, p0), (m1, g1, p1) = plain
    gaps = {"losses": (max_loss_gap(m1, m0), max_loss_gap(m_d, m0)),
            "gradients": (tensor_gaps(g1, g0)[1], tensor_gaps(g_d, g0)[1]),
            "parameters": (tensor_gaps(p1, p0)[1],
                           tensor_gaps(p_d, p0)[1])}
    print(f"multi-card (a), {got} process group of one, the phase-11 point "
          f"in float32 (TF32 off, cuDNN deterministic): all_reduce_mean_ "
          f"over one process is the identity on the step's {len(g_d)} "
          f"gradients: {identity}; gap of the step in the group to the "
          f"plain step (two plain steps' own gap): "
          + ", ".join(f"{k} {v[1]:.3e} ({v[0]:.3e})"
                      for k, v in gaps.items())
          + " (losses: max relative; gradients, parameters: L2 over all)",
          flush=True)
    check(got == (backend or "nccl"), f"process group backend {got}")
    check(identity, "all_reduce_mean_ over one process changed a gradient")
    # bit-equal where the plain step is itself deterministic; where its
    # backward is not (atomics in the warps' and resizes' gradients), the
    # step in the group may differ from the plain one only as much as two
    # plain steps differ from each other
    for k, (plain_gap, group_gap) in gaps.items():
        check(group_gap <= MC_NONDET_FACTOR * plain_gap,
              f"group of one: {k} gap {group_gap} against {plain_gap} "
              f"between two plain steps")
    return m0, {k: v.cpu() for k, v in g0.items()}


def gloo_two_ranks(one, halves, dev):
    """Phase 15 (b): two processes on the one card under gloo, each on 8
    of the 16 samples. all_reduce_mean_ of their steps' gradients alone
    must be the mean of those gradients, bit for bit; the step in the
    group (step_nets' all-reduce) is held against the mean of their steps
    alone and against one process's step on all 16 (``one``: losses,
    gradients; ``halves``: the same process's steps on each half, whose
    gap to it is printed). Returns the launch counts of both ranks' steps
    in the group, summed."""
    import tempfile
    import torch
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as out:
        mp.spawn(gloo_rank, args=(free_port(), out, dev.type), nprocs=2,
                 join=True)
        ranks = [torch.load(Path(out) / f"rank{r}.pt") for r in range(2)]
    r0, r1 = ranks
    check(r0["metrics"] == r1["metrics"], "the ranks' averaged losses differ")
    check(all(torch.equal(r0["params"][k], r1["params"][k])
              for k in r0["params"]), "the ranks' parameters differ")
    m_one, g_one = one
    alone = [r["alone"] for r in ranks]
    m_half = {k: (alone[0][0][k] + alone[1][0][k]) / 2 for k in m_one}
    g_half = {k: (alone[0][1][k] + alone[1][1][k]) / 2 for k in g_one}
    collective = all(torch.equal(r0["collective"][k], g_half[k]) and
                     torch.equal(r1["collective"][k], g_half[k])
                     for k in g_half)
    half_loss = max_loss_gap(r0["metrics"], m_half)
    half_gap = tensor_gaps(r0["grads"], g_half)[1]
    batch_gap = tensor_gaps({k: (halves[0][1][k] + halves[1][1][k]) / 2
                             for k in g_one}, g_one)[1]
    one_loss = max_loss_gap(r0["metrics"], m_one)
    gaps = {}
    for net in "GD":
        keys = [k for k in g_one if k[0] == net]
        net_norm = float(torch.cat([g_one[j].flatten() for j in keys]).norm())
        # D's conv biases before an instance norm: 0 in exact arithmetic
        keys_t = [k for k in keys
                  if float(g_one[k].norm()) > 1e-5 * net_norm]
        gaps[net] = (tensor_gaps({k: r0["grads"][k] for k in keys_t},
                                 {k: g_one[k] for k in keys_t})[0],
                     tensor_gaps({k: r0["grads"][k] for k in keys},
                                 {k: g_one[k] for k in keys})[1])
    print(f"multi-card (b), 2 processes on one card under gloo, 8 samples "
          f"each, float32, TF32 off, cuDNN deterministic: all_reduce_mean_ "
          f"of their steps' gradients alone is their mean bit for bit: "
          f"{collective}; the step in the group against the mean of their "
          f"steps alone: losses {half_loss:.3e} (bound {MC_SAME_RTOL}), "
          f"gradients {half_gap:.3e} over all (bound "
          f"{MC_SAME_GRAD_RTOL}); against one process on all 16 (one "
          f"process's own halves are {batch_gap:.3e} from it), averaged "
          f"losses max relative gap {one_loss:.3e} (bound {MC_LOSS_RTOL}); "
          f"gradient gap per tensor / over all: G {gaps['G'][0]:.3e} / "
          f"{gaps['G'][1]:.3e} (bounds {MC_GRAD_RTOL['G']}), D "
          f"{gaps['D'][0]:.3e} / {gaps['D'][1]:.3e} (bounds "
          f"{MC_GRAD_RTOL['D']}); both ranks' parameters bit-equal after "
          f"Adam", flush=True)
    check(collective, "all_reduce_mean_ over two processes is not the mean")
    check(half_loss <= MC_SAME_RTOL and half_gap <= MC_SAME_GRAD_RTOL,
          f"two ranks against their steps alone: losses {half_loss}, "
          f"gradients {half_gap}")
    check(one_loss <= MC_LOSS_RTOL, f"two-rank losses {one_loss}")
    for net in "GD":
        check(gaps[net][0] <= MC_GRAD_RTOL[net][0] and
              gaps[net][1] <= MC_GRAD_RTOL[net][1],
              f"two-rank {net} gradients {gaps[net]}")
    return {k: r0["launches"][k] + r1["launches"][k] for k in r0["launches"]}


def mesh_imitator_checks(cr, imi, assets, cfg, imit_h, src_img, thetas,
                         req_thetas, tgt_imgs, dev):
    """Phase 15 (c): an Imitator whose mesh names the card twice. Returns
    {path: launch counts}."""
    import numpy as np
    import torch
    from impersonator_tpu_torch.config import TestConfig
    from impersonator_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(devices=[dev, dev])
    dp = imi.Imitator(cfg, assets=assets, nets=imit_h.nets, mesh=mesh)
    check(len(dp.replicas) == 2 and dp.replicas[1].compute_nets.generator
          is not dp.compute_nets.generator, "the mesh's replicas")
    out = {}
    reset_counts(cr)
    dp.personalize(src_img, src_smpl=thetas[0])
    torch.cuda.synchronize()
    out["mesh_personalize"] = read_counts(cr)
    reset_counts(cr)
    preds = dp.inference_by_smpls(req_thetas, batch=16)
    out["mesh_inference_by_smpls"] = read_counts(cr)
    reset_counts(cr)
    preds_h = dp.inference(tgt_imgs, batch=16)
    out["mesh_inference"] = read_counts(cr)
    check(out["mesh_personalize"]["zbuffer_bucket_rows"] == 1 and
          out["mesh_personalize"]["zbuffer_bucket_flow"] == 0,
          f"mesh personalize launches {out['mesh_personalize']} (one "
          f"personalisation, copied to the replica)")
    check(out["mesh_inference_by_smpls"]["zbuffer_bucket_flow"] == 8,
          f"mesh inference_by_smpls launches "
          f"{out['mesh_inference_by_smpls']} (4 batches x 2 pieces)")
    check(out["mesh_inference"]["zbuffer_bucket_flow"] == 8,
          f"mesh inference launches {out['mesh_inference']}")
    for x in (preds, preds_h):
        check(tuple(x.shape) == (64, GEOM["s"], GEOM["s"], 3) and
              bool(torch.isfinite(x).all()), "mesh preds")
    print(f"multi-card (c), an Imitator on a mesh naming the card twice "
          f"(bf16, 256^2, batch 16 in two pieces of 8): inference_by_smpls "
          f"and inference (HMR) of 64 frames; launches {out}", flush=True)

    cfg32 = TestConfig(image_size=GEOM["s"], repeat_num=6,
                       compute_dtype="float32")
    nets32 = imi.build_nets(cfg32, assets)
    solo = imi.Imitator(cfg32, assets=assets, nets=nets32, device=dev)
    dp32 = imi.Imitator(cfg32, assets=assets, nets=nets32, mesh=mesh)
    gaps = []
    for im in (solo, dp32):
        im.personalize(src_img, src_smpl=thetas[0])
    # the mesh at batch 16 runs pieces of 8: held against one device at
    # batch 8, the same kernels on the same rows (at batch 16 HMR's θs
    # round otherwise, which moves a few edge pixels of the raster by
    # O(1)); the camera reference of every piece is frame 0's: its θ, or
    # its θ from HMR on the first piece
    for fn, cam in (
            (lambda im, b: im.inference_by_smpls(req_thetas, batch=b),
             lambda: torch.as_tensor(req_thetas[0:1, 0:3], device=dev)),
            (lambda im, b: im.inference(tgt_imgs, batch=b),
             lambda: dp32.regress_smpl(tgt_imgs[:8])[0:1, 0:3])):
        a, b = fn(solo, 8), fn(dp32, 16)
        gaps.append(float((a - b).abs().max()))
        check(torch.equal(dp32.first_cam, cam()),
              "the mesh's camera reference is not frame 0's")
    print(f"multi-card (c), float32 (TF32 off): the two-replica mesh at "
          f"batch 16 against one device at batch 8, 64 frames, max |dpred| "
          f"inference_by_smpls {gaps[0]:.3e}, inference {gaps[1]:.3e} "
          f"(bound {PRED_TOL})", flush=True)
    check(max(gaps) <= PRED_TOL, f"mesh preds differ by {gaps}")
    return out


def data_parallel_cli_checks(cr, cfg, src_img, thetas, req_thetas, native,
                             dev):
    """Phase 15 (d): run_imitator --data_parallel in this process and
    serve's service with data_parallel=True, on a mesh of the visible
    cards. Returns {path: launch counts}."""
    import tempfile
    import numpy as np
    import torch
    from impersonator_tpu_torch.cli import run_imitator, serve
    from impersonator_tpu_torch.utils.visualizer import write_png
    s, n = GEOM["s"], 8
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "tgt").mkdir()
        for i, f in enumerate(smooth_frames(n, s, 15)):
            (tmp / "tgt" / f"{i:03d}.jpg").write_bytes(
                native.encode_jpeg(f, device=dev))
        src_u8 = np.round((src_img + 1.0) * 127.5).clip(0, 255).astype(
            np.uint8)
        write_png(str(tmp / "src.png"), src_u8)
        reset_counts(cr)
        preds = run_imitator.main([
            "--src_path", str(tmp / "src.png"), "--tgt_path",
            str(tmp / "tgt"), "--output_dir", str(tmp / "out"),
            "--checkpoints_dir", str(tmp / "ckpt"), "--image_size", str(s),
            "--batch", str(n), "--data_parallel", "--device", dev.type])
        out["run_imitator_dp"] = read_counts(cr)
        check(len(preds) == n and len(list((tmp / "out").glob("pred_*")))
              == n, "run_imitator --data_parallel preds")
        service = serve.ImitatorService(cfg, batch=16, data_parallel=True,
                                        device=dev)
        try:
            mesh = service.imitator.mesh
            check(mesh is not None and mesh.size == torch.cuda.device_count(),
                  f"serve's data-parallel mesh {mesh}")
            service.personalize(native.encode_jpeg(src_u8, device=dev),
                                smpl=thetas[0])
            reset_counts(cr)
            reply = service.imitate(req_thetas)
            out["serve_imitate_dp"] = read_counts(cr)
        finally:
            service.close()
    check(out["run_imitator_dp"]["zbuffer_bucket_rows"] == 1 and
          out["run_imitator_dp"]["zbuffer_bucket_flow"] == 1,
          f"run_imitator --data_parallel launches {out['run_imitator_dp']}")
    check(len(reply["frames"]) == 64 and
          out["serve_imitate_dp"]["zbuffer_bucket_flow"] == 4,
          f"serve data_parallel /imitate: {len(reply['frames'])} frames, "
          f"launches {out['serve_imitate_dp']}")
    print(f"multi-card (d), mesh of the {torch.cuda.device_count()} visible "
          f"card(s): run_imitator --data_parallel in-process on {n} JPEG "
          f"frames, launches {out['run_imitator_dp']}; serve with "
          f"data_parallel=True: 64 theta -> 64 JPEGs, launches "
          f"{out['serve_imitate_dp']}", flush=True)
    return out


def multi_card_phase(cr, imi, assets, cfg, imit_h, src_img, thetas,
                     req_thetas, tgt_imgs, dev, backend=None):
    """Phase 15 (module docstring); returns {path: launch counts}.
    ``backend`` names (a)'s backend when it is not the card's NCCL."""
    import torch
    from impersonator_tpu_torch.data import native
    from impersonator_tpu_torch.data.loader import stage_batch
    from impersonator_tpu_torch.tasks import trainer as tt
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        tr = mc_trainer(tt, assets, dev)
        batch = stage_batch(train_batch(GEOM["s"], MC_BATCH, MC_SEED), dev)
        reset_counts(cr)
        m_one, g_one = nccl_world_one(tt, tr, batch, backend)
        by_path = {"train_group_of_one": read_counts(cr)}
        check(by_path["train_group_of_one"]["zbuffer_bucket_rows"] == 3 and
              by_path["train_group_of_one"]["zbuffer_bucket_flow"] == 3,
              f"(a)'s launches {by_path['train_group_of_one']} (3 steps)")
        half = MC_BATCH // 2
        halves = []
        for r in range(2):
            m, g, _ = mc_step(tt, tr, {k: v[r * half:(r + 1) * half]
                                          for k, v in batch.items()})
            halves.append((m, {k: v.cpu() for k, v in g.items()}))
        del tr, batch
        torch.cuda.empty_cache()
        by_path["train_two_ranks"] = gloo_two_ranks((m_one, g_one), halves,
                                                    dev)
        torch.backends.cudnn.deterministic = flags[1]
        check(by_path["train_two_ranks"]["zbuffer_bucket_rows"] == 2 and
              by_path["train_two_ranks"]["zbuffer_bucket_flow"] == 2,
              f"two ranks' launches {by_path['train_two_ranks']} (one step "
              f"each)")
        by_path.update(mesh_imitator_checks(
            cr, imi, assets, cfg, imit_h, src_img, thetas, req_thetas,
            tgt_imgs, dev))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    by_path.update(data_parallel_cli_checks(cr, cfg, src_img, thetas,
                                            req_thetas, native, dev))
    return by_path


# -- phase 16: the repository's tools on the port ----------------------------

TOOL_FRAMES = 16            # seeded 256² frames, one batch of 16
# the frames of the CPU's float32 parity harness: Imitator.inference's
# first batch of 8 (one flow launch), whose predictions do not depend on
# the frames after it (the camera comes from frame 0)
TOOL_CPU_FRAMES = 8
# phase 16's artifact runs, on the bench body with the full nets (6
# residual blocks; the trainer's PatchGAN 4 layers) at 256², with fewer
# epochs: post-tune 8 priors at its recipe's batch 4, 2 epochs (4 steps;
# the JAX tool's default is 6 priors, 5 epochs at 128², the synthetic
# body, 2 blocks); the trainer 32 items at batch 16, 0 + 2 epochs (4
# steps, the second epoch's learning rate decayed; its default is 64
# items at batch 4, 5 + 25 epochs at 64², the synthetic body, 2 blocks, a
# 2-layer PatchGAN)
TOOL_POSTTUNE = ("--size", "256", "--priors", "8", "--epochs", "2",
                 "--repeat_num", "6")
TOOL_TRAINCONV = ("--image_size", "256", "--batch_size", "16", "--n_items",
                  "32", "--nepochs_no_decay", "0", "--nepochs_decay", "2",
                  "--repeat_num", "6", "--d_layers", "4")
# runs a module as ``python -m`` would and prints, last, the launch counts
# of its process
# (rows, flow) of each counted tool run. posttune_artifact with
# TOOL_POSTTUNE: the structured source and its personalisation (2 rows),
# the before and after metrics (self-imitation 1 flow, held-out 1 rows + 1
# flow, each), the pair batch (1 rows, 1 flow), the refresh (1 rows).
# trainconv_artifact with TOOL_TRAINCONV: the train and held-out sets (2
# rows), 4 steps and 2 epochs' visuals (1 rows + 1 flow each).
# run_imitator --post_tune on TOOL_FRAMES frames and make_prior_poses'
# TOOL_FRAMES prior poses: personalise, the pair batch, the refresh (3
# rows), the pair batch and one batch of 32 frames (2 flow)
POSTTUNE_LAUNCHES = (6, 5)
TRAINCONV_LAUNCHES = (8, 6)
RUN_IMITATOR_PT_LAUNCHES = (3, 2)
TOOL_LAUNCHER = """
import json, runpy, sys
from impersonator_tpu_torch.ops import cuda_raster as cr
name = sys.argv[1]
sys.argv = [name] + sys.argv[2:]
runpy.run_module(name, run_name="__main__", alter_sys=True)
print("LAUNCHES " + json.dumps({k.__name__: k.launches
                                for k in cr.KERNELS}), flush=True)
"""


def write_bench_smpl(root, assets):
    """``assets`` (the bench body) as an SMPL model pickle and a UV-mapper
    OBJ that assets.load_smpl_assets reads back: the same vertices,
    blend shapes, regressors, weights, kinematic tree and faces (the UVs,
    one vt per face corner, within an ulp: the loader flips v)."""
    import pickle
    import numpy as np
    nv = assets.v_template.shape[0]
    parents = np.asarray(assets.parents, np.int64).copy()
    parents[0] = 0
    dd = {"v_template": assets.v_template,
          "shapedirs": np.asarray(assets.shapedirs).T.reshape(nv, 3, -1),
          "posedirs": np.asarray(assets.posedirs).T.reshape(nv, 3, -1),
          "J_regressor": np.asarray(assets.j_regressor).T,
          "cocoplus_regressor": np.asarray(assets.joint_regressor).T,
          "weights": assets.lbs_weights,
          "kintree_table": np.stack([parents, np.arange(len(parents))]),
          "f": np.asarray(assets.faces, np.int32)}
    pkl = root / "bench_smpl.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(dd, f)
    uv = np.asarray(assets.f2uvs, np.float32).reshape(-1, 2)
    lines = [f"vt {u:.9g} {1.0 - v:.9g}" for u, v in uv]
    lines += [f"f {3 * i + 1}/{3 * i + 1} {3 * i + 2}/{3 * i + 2} "
              f"{3 * i + 3}/{3 * i + 3}" for i in range(len(assets.faces))]
    obj = root / "bench_uv.obj"
    obj.write_text("\n".join(lines) + "\n")
    return str(pkl), str(obj)


def tool_inputs(root, assets):
    """Phase 16's seeded inputs under root: TOOL_FRAMES smooth 256² PNG
    frames (the first TOOL_CPU_FRAMES of them also in a directory of
    their own), a source PNG and a reference pred_*.png for each frame,
    the frames' θs as a pose_shape.pkl, the bench body as an SMPL pickle
    + UV OBJ, and released-layout HMR and full-width generator .pth
    files."""
    import pickle
    import numpy as np
    import torch
    from impersonator_tpu_torch.models.generator import ImpersonatorGenerator
    from impersonator_tpu_torch.models.hmr import HumanModelRecovery, init_hmr
    from impersonator_tpu_torch.models.layers import init_weights
    from impersonator_tpu_torch.tasks.imitator import RANDOM_HMR_FC3_SCALE
    from impersonator_tpu_torch.utils.visualizer import write_png
    s = GEOM["s"]
    frames, refs = root / "frames", root / "refs"
    first = root / "frames_first"
    for d in (frames, refs, first):
        d.mkdir()
    imgs = smooth_frames(2 * TOOL_FRAMES + 1, s, 61)
    for i in range(TOOL_FRAMES):
        write_png(str(frames / f"{i:03d}.png"), imgs[i])
        write_png(str(refs / f"pred_{i:03d}.png"), imgs[TOOL_FRAMES + i])
        if i < TOOL_CPU_FRAMES:
            write_png(str(first / f"{i:03d}.png"), imgs[i])
    write_png(str(root / "src.png"), np.round(
        (source_image(s) + 1.0) * 127.5).clip(0, 255).astype(np.uint8))
    th = train_batch(8, TOOL_FRAMES, 62)["smpls"][:, 0]
    with open(root / "pose_shape.pkl", "wb") as f:
        pickle.dump({"cams": th[:, :3], "pose": th[:, 3:75],
                     "shape": th[:, 75:]}, f)
    smpl_pkl, uv_obj = write_bench_smpl(root, assets)
    g = torch.Generator().manual_seed(63)
    hmr = HumanModelRecovery()
    init_hmr(hmr, g, assets.mean_theta, fc3_scale=RANDOM_HMR_FC3_SCALE)
    torch.save(hmr.state_dict(), root / "hmr.pth")
    gen = ImpersonatorGenerator()
    init_weights(gen, g)
    torch.save(gen.state_dict(), root / "gen.pth")
    return {"frames": str(frames), "frames_first": str(first),
            "refs": str(refs), "thetas": th,
            "smpl": ["--smpl_model", smpl_pkl, "--uv_mapping", uv_obj],
            "src": str(root / "src.png"), "hmr": str(root / "hmr.pth"),
            "gen": str(root / "gen.pth"), "gen_sd": gen.state_dict()}


def start_modules(jobs, root):
    """Each {label: [module, args...]} as a subprocess of TOOL_LAUNCHER,
    all started together; {label: process}."""
    return {k: subprocess.Popen([sys.executable, "-c", TOOL_LAUNCHER, *v],
                                cwd=root, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
            for k, v in jobs.items()}


def finish_modules(procs):
    """Wait for start_modules' processes; {label: (stdout, launch
    counts)}. Fails on a non-zero exit."""
    out = {}
    for k, proc in procs.items():
        so, se = proc.communicate(timeout=900)
        check(proc.returncode == 0, f"{k} exited {proc.returncode}:\n"
                                    f"{so[-2000:]}\n{se[-3000:]}")
        last = [ln for ln in so.splitlines() if ln.startswith("LAUNCHES ")]
        check(len(last) == 1, f"{k}: no launch counts")
        out[k] = (so, json.loads(last[0][len("LAUNCHES "):]))
    return out


def tool_launches(label, got, rows, flow, tiles=0):
    want = {"zbuffer_bucket_rows": rows, "zbuffer_bucket_flow": flow,
            "zbuffer_tiles": tiles}
    check(got == want, f"{label} launches {got}, expected {want}")
    return got


def prior_poses_checks(inp, native, got_pkl):
    """make_prior_poses' θs from the card against the same HMR on the CPU
    (TF32 off in both, HMR's own full_fp32): within FEAT_RTOL of the
    largest |θ|."""
    import pickle
    import numpy as np
    from impersonator_tpu_torch.tools import image_paths
    from impersonator_tpu_torch.tools import make_prior_poses as mpp
    from impersonator_tpu_torch.utils import cv_utils
    with open(got_pkl, "rb") as f:
        d = pickle.load(f)
    th_g = np.concatenate([d["cams"], d["pose"], d["shape"]], 1)
    with card_decoder_for_cpu(native):
        imgs = np.stack([cv_utils.resize_img_hwc(cv_utils.read_img(p, "cpu"),
                                                 224)
                         for p in image_paths(inp["frames"])])
    th_c = mpp.regress(mpp.load_hmr(inp["hmr"], "cpu"), imgs, "cpu")
    gap = float(np.abs(th_g - th_c).max() / np.abs(th_c).max())
    print(f"make_prior_poses on the card: {th_g.shape[0]} θs, against the "
          f"CPU {gap:.3e} of the largest |θ| (bound {FEAT_RTOL})",
          flush=True)
    check(th_g.shape == (TOOL_FRAMES, 85) and np.isfinite(th_g).all(),
          f"prior poses {th_g.shape}")
    check(gap <= FEAT_RTOL, f"make_prior_poses card vs CPU {gap}")


VISUAL_CPU_FRAMES = 2      # visual_iper's frames rendered on the CPU too


def visual_checks(cr, inp, out_dir, dev):
    """visual_iper's renders: on the card's own geometry the rows kernel's
    fim equals its plain twin's (on the card) and the tool's triptychs
    equal the card's in-process ones, every value; on the CPU's geometry
    of the first VISUAL_CPU_FRAMES frames the card's fim equals the CPU's
    and its debug render is within TEX_TOL of the CPU's."""
    import numpy as np
    import torch
    from impersonator_tpu_torch.assets import load_smpl_assets
    from impersonator_tpu_torch.data import native
    from impersonator_tpu_torch.ops import smpl as smpl_ops
    from impersonator_tpu_torch.tasks.renderer import SMPLRenderer
    from impersonator_tpu_torch.tools import image_paths
    from impersonator_tpu_torch.tools import visual_iper as vi
    from impersonator_tpu_torch.utils import cv_utils
    assets = load_smpl_assets(inp["smpl"][1], inp["smpl"][3])
    s, th = GEOM["s"], torch.from_numpy(inp["thetas"])
    parents = assets.parents
    rend = {d: (SMPLRenderer.create(assets, d, image_size=s),
                smpl_ops.SMPLParams.from_assets(assets, d))
            for d in ("cpu", dev.type)}
    rend_g, params_g = rend[dev.type]
    reset_counts(cr)
    fim_g, rgb_g, sil_g = vi.render_batch(rend_g, params_g, parents,
                                          th.to(dev))
    torch.cuda.synchronize()
    one = read_counts(cr)
    with plain_twins(cr):
        fim_p, _, _ = vi.render_batch(rend_g, params_g, parents, th.to(dev))
    check(one["zbuffer_bucket_rows"] == 1, f"visual render launches {one}")
    check(torch.equal(fim_g, fim_p), "visual_iper fim: kernel vs plain twin")
    paths = image_paths(inp["frames"])
    imgs = cv_utils.load_image_batch(paths, s, dev)
    for j, p in enumerate(paths):
        got = native.read_image(str(Path(out_dir) / f"qa_{Path(p).stem}.png"),
                                dev)
        want = cv_utils._to_u8(vi.triptych(imgs[j], rgb_g[j].cpu().numpy(),
                                           sil_g[j].cpu().numpy()), True)
        check(np.array_equal(got, want), f"visual_iper {p}: the tool's "
                                         f"triptych")

    n = VISUAL_CPU_FRAMES
    rend_c, params_c = rend["cpu"]
    fim_c, rgb_c, _ = vi.render_batch(rend_c, params_c, parents, th[:n])
    info = smpl_ops.get_details(params_c, th[:n], parents)
    f2v, fim, wim = rend_g.render_fim_wim(info["cam"].to(dev),
                                          info["verts"].to(dev))
    rgb = rend_g.render_textured(fim, wim, torch.ones(
        (n, f2v.shape[1], rend_g.tex_size ** 2, 3), device=dev))
    rgb_gap = float((rgb.cpu() - rgb_c).abs().max())
    print(f"visual_iper: {len(paths)} triptychs of the "
          f"{assets.faces.shape[0]}-face bench body equal to the card's "
          f"renders, fim = plain twin; on the CPU's geometry of {n} frames "
          f"fim card = CPU, render gap {rgb_gap:.3e} (bound {TEX_TOL})",
          flush=True)
    check(torch.equal(fim.cpu(), fim_c), "visual_iper fim card vs CPU")
    check(rgb_gap <= TEX_TOL, f"visual_iper render card vs CPU {rgb_gap}")


def cpu_harness(inp, native, out):
    """parity_harness in float32 on the CPU on the first TOOL_CPU_FRAMES
    frames (the card's decoder reading the PNGs: card_decoder_for_cpu)
    into out['json'], a failure into out['error']; phase 16 runs it on a
    thread beside the tool subprocesses."""
    from impersonator_tpu_torch.tools import parity_harness as ph
    try:
        with card_decoder_for_cpu(native):
            out["json"] = ph.harness(ph.parse_args(
                harness_args(inp, inp["frames_first"])
                + ["--compute_dtype", "float32", "--device", "cpu"]))
    except BaseException as e:    # noqa: BLE001 (re-raised by the phase)
        out["error"] = e


def harness_checks(res_c, res32, res16):
    """parity_harness: the card's float32 JSON on its first
    TOOL_CPU_FRAMES frames against the CPU's within EVAL_BOUNDS, each
    frame; the bf16 and float32 runs' JSON finite over every frame."""
    import numpy as np
    gaps = {k: 0.0 for k in EVAL_BOUNDS}
    check([r["frame"] for r in res32["per_frame"]][:TOOL_CPU_FRAMES] ==
          [r["frame"] for r in res_c["per_frame"]] and
          len(res_c["per_frame"]) == TOOL_CPU_FRAMES and
          len(res32["per_frame"]) == TOOL_FRAMES, "harness frames")
    for g, c in zip(res32["per_frame"], res_c["per_frame"]):
        for k in gaps:
            gaps[k] = max(gaps[k], abs(g[k] - c[k]))
    check(len(res16["per_frame"]) == TOOL_FRAMES and all(
        np.isfinite(r[k]) for res in (res16, res32)
        for r in res["per_frame"] for k in gaps), "harness JSON")
    print(f"parity_harness on the card, {TOOL_FRAMES} frames at "
          f"{GEOM['s']}^2 (bench body, full generator): bf16 aggregate "
          f"{res16['aggregate']}; float32 card vs CPU on the first "
          f"{TOOL_CPU_FRAMES}, largest gaps "
          f"{ {k: f'{v:.3e}' for k, v in gaps.items()} } (bounds "
          f"{ {k: EVAL_BOUNDS[k] for k in gaps} })", flush=True)
    for k, v in gaps.items():
        check(v <= EVAL_BOUNDS[k], f"parity_harness {k} card vs CPU {v}")


def harness_args(inp, frames):
    from impersonator_tpu_torch.cli import evaluate as ev
    return ["--src_path", inp["src"], "--tgt_path", frames,
            "--ref_dir", inp["refs"], "--gen_ckpt", inp["gen"],
            "--hmr_ckpt", inp["hmr"], "--lpips_ckpt", ev.REAL_LPIPS_LIN,
            "--image_size", str(GEOM["s"]), *inp["smpl"]]


def artifact_first_steps(dev):
    """The two artifacts' recipes, first step card vs CPU (128², batch 2,
    float32, TF32 off), on the CPU's raster products:
    posttune_artifact's structured source and prior poses through one
    tune step, trainconv_artifact's learnable set through one G+D step;
    losses within TUNE_LOSS_RTOL. On the tools' own defaults (the
    synthetic body, 2 residual blocks, a 2-layer PatchGAN), not the bench
    body and the full nets: phases 10 and 11 hold the same tune and train
    steps card vs CPU there, and here that point cost 45.9 s of CPU time
    on phase 16's longest path (against 5 s)."""
    import torch
    from impersonator_tpu_torch.config import TrainConfig
    from impersonator_tpu_torch.data.loader import stage_batch
    from impersonator_tpu_torch.tasks import post_tune as pt
    from impersonator_tpu_torch.tasks import trainer as tt
    from impersonator_tpu_torch.tasks.imitator import Imitator, ImitatorNets
    from impersonator_tpu_torch.tools import posttune_artifact as pa
    from impersonator_tpu_torch.tools import trainconv_artifact as ta
    from impersonator_tpu_torch.utils.precision import full_fp32
    with full_fp32():
        im_c, _ = pa.build(128, 0, torch.device("cpu"), "float32")
        im_g = Imitator(im_c.cfg, assets=im_c.assets, device=dev,
                        nets=ImitatorNets(copy.deepcopy(
                            im_c.nets.generator)))
        priors = pt.default_prior_poses(im_c.src_info["theta"], n=2,
                                        scale=0.12)
        batch = pt.build_meta_pairs(im_c, priors)
        bg = im_c.src_info["bg"].expand(2, -1, -1, -1)
        tune = []
        for im, d in ((im_c, "cpu"), (im_g, dev)):
            step = pt.make_tune_step(im, pt.tune_optimizer(
                im.nets.generator, 2e-4))
            tune.append({k: float(v) for k, v in step(
                {k: v.to(d) for k, v in batch.items()}, bg.to(d)).items()})
        cfg = TrainConfig(image_size=128, batch_size=2, repeat_num=2,
                          d_layers=2, use_vgg=True, use_style=False,
                          use_face=False, train_dtype="float32")
        tr_c = tt.build_trainer(cfg, device="cpu")
        tr_g = tt.build_trainer(cfg, device=dev)
        st_c = tr_c.init_state()
        st_g = tr_g.init_state(copy.deepcopy(st_c.generator),
                               copy.deepcopy(st_c.discriminator))
        b = stage_batch(ta.make_learnable_batchset(tr_c, 2), "cpu")
        src, tsf = b["images"][:, 0], b["images"][:, 1]
        inputs = tt.body_recovery_flow(tr_c.renderer, tr_c.smpl_params,
                                       tr_c.assets.parents, src, tsf,
                                       b["smpls"][:, 0], b["smpls"][:, 1])
        train = []
        for tr, st, d in ((tr_c, st_c, "cpu"), (tr_g, st_g, dev)):
            inp = {k: None if v is None else v.to(d)
                   for k, v in inputs.items()}
            _, m = tt.make_update(tr)(st, inp, src.to(d), tsf.to(d))
            train.append({k: float(v) for k, v in m.items()})
    gaps = [max(abs(g[k] - c[k]) / abs(c[k]) for k in c if c[k] != 0.0)
            for c, g in (tune, train)]
    print(f"artifact recipes, first step card vs CPU (synthetic body, 2 "
          f"blocks, 2-layer D, 128², batch 2, float32, TF32 off, the CPU's "
          f"raster): post-tune losses "
          f"{gaps[0]:.3e}, train losses {gaps[1]:.3e} relative (bound "
          f"{TUNE_LOSS_RTOL})", flush=True)
    for gap, what in zip(gaps, ("post-tune", "train")):
        check(gap <= TUNE_LOSS_RTOL, f"{what} artifact step card vs CPU "
                                     f"{gap}")


def tools_phase(cr, native, assets, dev):
    """Phase 16 (module docstring); returns {path: launch counts}."""
    import math
    import pickle
    import tempfile
    import threading
    import numpy as np
    import torch
    from impersonator_tpu_torch.utils import convert as C
    from impersonator_tpu_torch.utils.checkpoint import (flax_msgpack_bytes,
                                                         read_flax_msgpack)
    from impersonator_tpu_torch.utils.precision import full_fp32
    from impersonator_tpu_torch.utils.video import frames_to_mp4, have_ffmpeg
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp_s:
        tmp = Path(tmp_s)
        inp = tool_inputs(tmp, assets)
        root = Path(__file__).resolve().parent
        t = "impersonator_tpu_torch.tools."
        cuda = ["--device", dev.type]
        jobs = {
            "convert_weights": [t + "convert_weights", "gen", inp["gen"],
                                str(tmp / "gen.msgpack")],
            "make_prior_poses": [t + "make_prior_poses", "--img_dir",
                                 inp["frames"], "--out",
                                 str(tmp / "priors.pkl"), "--hmr_ckpt",
                                 inp["hmr"], "--itv", "1", "--batch",
                                 str(TOOL_FRAMES), *cuda],
            "visual_iper": [t + "visual_iper", "--frames_dir", inp["frames"],
                            "--smpl_pkl", str(tmp / "pose_shape.pkl"),
                            "--out_dir", str(tmp / "qa"), "--image_size",
                            str(GEOM["s"]), "--batch", str(TOOL_FRAMES),
                            *inp["smpl"], *cuda],
            "parity_harness_fp32": [t + "parity_harness",
                                    *harness_args(inp, inp["frames"]),
                                    "--compute_dtype", "float32", *cuda],
            "parity_harness": [t + "parity_harness",
                               *harness_args(inp, inp["frames"]), *cuda],
            "posttune_artifact": [t + "posttune_artifact", *TOOL_POSTTUNE,
                                  *inp["smpl"], "--out",
                                  str(tmp / "pt.json"), *cuda],
            "trainconv_artifact": [t + "trainconv_artifact",
                                   *TOOL_TRAINCONV, *inp["smpl"], "--out",
                                   str(tmp / "tc.json"), *cuda],
        }
        ffmpeg = have_ffmpeg()
        if ffmpeg:
            (tmp / "videos").mkdir()
            frames_to_mp4(smooth_frames(TOOL_FRAMES, GEOM["s"], 64),
                          str(tmp / "videos" / "001_1_1.mp4"))
            jobs["prepare_iper"] = [t + "prepare_iper", "--video_dir",
                                    str(tmp / "videos"), "--out_dir",
                                    str(tmp / "iper")]
        cpu_run = {}
        cpu_thread = threading.Thread(target=cpu_harness, daemon=True,
                                      args=(inp, native, cpu_run))
        procs = start_modules(jobs, root)
        everything = dict(procs)
        # TF32 off for the whole of it: the two threads' own full_fp32
        # blocks then leave the flags as they find them
        with full_fp32():
            cpu_thread.start()
            res = finish_modules({"make_prior_poses":
                                  procs.pop("make_prior_poses")})
            # the prior poses into the imitator's post-tune, on the card
            procs.update(start_modules({"run_imitator_post_tune": [
                "impersonator_tpu_torch.cli.run_imitator", "--src_path",
                inp["src"], "--tgt_path", inp["frames"], "--post_tune",
                "--prior_poses", str(tmp / "priors.pkl"), "--image_size",
                str(GEOM["s"]), "--output_dir", str(tmp / "imit"),
                "--checkpoints_dir", str(tmp / "ckpt"), *inp["smpl"],
                *cuda]}, root))
            everything.update(procs)
            try:
                # while the card runs the rest, the checks whose inputs
                # are there
                artifact_first_steps(dev)
                prior_poses_checks(inp, native, str(tmp / "priors.pkl"))
                res.update(finish_modules({"visual_iper":
                                           procs.pop("visual_iper")}))
                visual_checks(cr, inp, str(tmp / "qa"), dev)
                res.update(finish_modules(procs))
            finally:
                for proc in everything.values():
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
            cpu_thread.join()
        if "error" in cpu_run:
            raise cpu_run["error"]
        by_path = {f"tool_{k}": v[1] for k, v in res.items()}
        n_flow = math.ceil(TOOL_FRAMES / 8)     # Imitator.inference's batch
        tool_launches("convert_weights", by_path["tool_convert_weights"], 0,
                      0)
        tool_launches("make_prior_poses", by_path["tool_make_prior_poses"],
                      0, 0)
        tool_launches("visual_iper", by_path["tool_visual_iper"], 1, 0)
        for k in ("parity_harness", "parity_harness_fp32"):
            tool_launches(k, by_path[f"tool_{k}"], 1, n_flow)
        tool_launches("posttune_artifact", by_path["tool_posttune_artifact"],
                      *POSTTUNE_LAUNCHES)
        tool_launches("trainconv_artifact",
                      by_path["tool_trainconv_artifact"], *TRAINCONV_LAUNCHES)
        tool_launches("run_imitator --post_tune --prior_poses",
                      by_path["tool_run_imitator_post_tune"],
                      *RUN_IMITATOR_PT_LAUNCHES)
        with open(tmp / "priors.pkl", "rb") as f:
            n_priors = len(pickle.load(f)["cams"])
        check(n_priors == TOOL_FRAMES and len(list(
            (tmp / "imit").glob("pred_*"))) == TOOL_FRAMES,
            f"run_imitator --post_tune on {n_priors} priors: preds")

        want = flax_msgpack_bytes(C.generator_to_jax(inp["gen_sd"]))
        got = (tmp / "gen.msgpack").read_bytes()
        back = C.generator_state_dict_from_jax(
            read_flax_msgpack(str(tmp / "gen.msgpack")))
        check(got == want and all(torch.equal(back[k], v)
                                  for k, v in inp["gen_sd"].items()),
              "convert_weights gen: bytes or leaves differ")
        harness = {}
        for k in ("parity_harness", "parity_harness_fp32"):
            text = res[k][0][:res[k][0].index("LAUNCHES ")]
            harness[k] = json.loads(text[text.index("{"):])
        harness_checks(cpu_run["json"], harness["parity_harness_fp32"],
                       harness["parity_harness"])
        pt_json = json.loads((tmp / "pt.json").read_text())
        tc_json = json.loads((tmp / "tc.json").read_text())
        cyc = pt_json["cycle_loss_per_epoch"]
        rows = tc_json["per_epoch"]
        check(len(cyc) == 2 and all(np.isfinite(cyc)) and all(
            np.isfinite(v) for part in ("before", "after")
            for v in pt_json[part].values()), f"posttune artifact {pt_json}")
        check(len(rows) == 2 and all(np.isfinite(r[k]) for r in rows
                                     for k in r) and
              tc_json["trend"]["lr_decay_kicked_in"],
              f"trainconv artifact {rows}")
        print(f"posttune_artifact on the card ({' '.join(TOOL_POSTTUNE)}): "
              f"cycle loss per epoch {cyc}, after {pt_json['after']}; "
              f"trainconv_artifact ({' '.join(TOOL_TRAINCONV)}): "
              f"{[{k: r[k] for k in ('g_total', 'd_loss', 'eval_ssim')} for r in rows]}",
              flush=True)

        if ffmpeg:
            iper = tmp / "iper" / "001" / "1" / "1"
            n = len(list(iper.glob("frame_*.png"))) if iper.is_dir() else 0
            check(n == TOOL_FRAMES, f"prepare_iper wrote {n} frames")
            print(f"prepare_iper: {TOOL_FRAMES}-frame mp4 -> {n} frames "
                  f"under 001/1/1", flush=True)
        else:
            print("prepare_iper: NOT RUN, this host has no ffmpeg "
                  "(utils.video.have_ffmpeg() is false)", flush=True)

    print(f"tools phase: the tools as {len(res)} subprocesses, "
          f"make_prior_poses' pickle then into run_imitator --post_tune "
          f"--prior_poses; launches "
          f"{ {k: [v['zbuffer_bucket_rows'], v['zbuffer_bucket_flow']] for k, v in by_path.items()} } "
          f"(rows, flow)", flush=True)
    return by_path


def main():
    import numpy as np
    import torch

    # -- phase 1: the card -------------------------------------------------
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    from impersonator_tpu_torch.assets import bench_assets, synthetic_assets
    from impersonator_tpu_torch.config import TestConfig
    from impersonator_tpu_torch.ops import cuda_raster as cr
    from impersonator_tpu_torch.ops import rasterizer as rast
    from impersonator_tpu_torch.ops import smpl as smpl_ops
    from impersonator_tpu_torch.tasks import imitator as imi
    from impersonator_tpu_torch.tasks.renderer import SMPLRenderer
    from impersonator_tpu_torch.scenes import degenerate_scene
    count_twin_on_card()

    dev = torch.device("cuda")
    smi = gpu_line()
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; nvidia-smi: {smi}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- phase 2: build ----------------------------------------------------
    from concurrent.futures import ThreadPoolExecutor
    from impersonator_tpu_torch.data import native
    from impersonator_tpu_torch.ops import cuda_warp
    from impersonator_tpu_torch.utils import native_build
    with ThreadPoolExecutor(1) as pool:     # the codec builds meanwhile
        codec = pool.submit(native.load, dev)
        log = native_build.build_kernels()
        for source, table in (("zbuffer_bucket.cu", cr.BUCKET_SYMBOLS),
                              ("zbuffer_tiles.cu", cr.TILES_SYMBOLS),
                              ("warp_bilinear.cu", cuda_warp.SYMBOLS)):
            native_build.kernel(source, table)
        codec_kind = codec.result().kind
    for line in log.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill")):
            print("ptxas:", line.strip())
    print(f"build: the kernels built and loaded; the {codec_kind} image "
          f"codec (nvJPEG) built beside it", flush=True)

    # -- phase 3: kernels vs plain twins -----------------------------------
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

    verts, starts = body_in[0], body_in[3]
    masks, pos = cr.bucket_warp_masks_plain(verts, starts, GEOM["s"],
                                            GEOM["tile"], GEOM["span"])
    n_warps = (GEOM["tile"] // cr.WARP_W) * (GEOM["tile"] // cr.WARP_H)
    kept = sum(int(((masks >> w) & 1).sum()) for w in range(n_warps))
    keep_share = kept / (int((pos >= 0).sum()) * n_warps)
    print(f"warp cull on the 16 bodies: keeps {kept} of "
          f"{int((pos >= 0).sum()) * n_warps} (warp, face) pairs, "
          f"{keep_share:.4f}", flush=True)

    # -- phase 3b: zbuffer_tiles vs its plain twin -------------------------
    check(renderer.tile_params() == TILES,
          f"renderer tile_params {renderer.tile_params()}")
    tile8, cap, tspan = TILES
    (fim_tk, _), err_tb, cov_tb, _ = tiles_vs_plain(cr, rast, fv, cap)
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

    # -- phase 3c: the renderer's tiled route (nf > 60,000) ----------------
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
    (fim_bk, wim_bk), err_big, cov_big, _ = tiles_vs_plain(
        cr, rast, f2v_big, tcap, tb, tsp)
    check(torch.equal(fim_big, fim_bk) and torch.equal(wim_big, wim_bk),
          "tiled route differs from zbuffer_tiles on its slots")
    _, err_bt, cov_bt, _ = slots_vs_plain(cr, rast, tie_slots(
        dev, tb, 16 + tcap, 16), tb)
    check(cov_bt > 0.05, f"tie scene coverage {cov_bt}")
    errs["zbuffer_tiles"] = max(errs["zbuffer_tiles"], err_big, err_bt)
    check(cov_big > 0.02, f"63k-face bodies cover {cov_big}")
    st_big = {k: v.tolist() for k, v in r_big.tile_stats(f2v_big).items()}
    print(f"tiled route: {big.nf} faces, 16 poses, tile_params "
          f"{r_big.tile_params()}, launches {tiled_launches}, fim equal to "
          f"the twin's, max |dw| {err_big}, coverage {cov_big:.4f}; "
          f"tile_stats max_tile_occupancy {st_big['max_tile_occupancy']}, "
          f"dropped_pairs {st_big['dropped_pairs']}; tie scene (16 items, "
          f"{16 + tcap} slots): fim equal, max |dw| {err_bt}", flush=True)

    # -- phase 3d: the warp kernel vs its plain twin ------------------------
    # the 16 bodies' flow T, as phase 3's kernel computed it
    body_flow = cr.zbuffer_bucket_flow(*body_in[:4], *body_in[4])[1]
    warp_err = warp_kernel_phase(dev, body_flow)

    # -- phase 4: the slice at full width ----------------------------------
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
    src_info = imit.personalize(src_img, src_smpl=thetas[0])
    rows_after_pers = cr.zbuffer_bucket_rows.launches
    warps_after_pers = read_counts(cr)["warp_bilinear"]
    preds = imit.inference_by_smpls(req_thetas, batch=16)
    launches = read_counts(cr)
    check(rows_after_pers >= 1, "personalize launched no rows kernel")
    check(launches["zbuffer_bucket_flow"] == 4,
          f"flow kernel launches {launches['zbuffer_bucket_flow']} != 4")
    # 5 warps a batch of 16: the source image's and the generator's 4
    check(launches["warp_bilinear"] - warps_after_pers == 4 * 5,
          f"warp launches {launches} ({warps_after_pers} in personalize), "
          f"expected 20 in 4 batches")
    check(tuple(preds.shape) == (64, GEOM["s"], GEOM["s"], 3),
          f"preds shape {tuple(preds.shape)}")
    check(bool(torch.isfinite(preds).all()), "non-finite preds")
    src_cov = float((src_info["fim"] >= 0).float().mean())
    check(src_cov > 0.02, f"source body covers {src_cov}")
    master_same = all(
        v.dtype == torch.float32 and torch.equal(v.cpu(), master_sd[k])
        for k, v in master.generator.state_dict().items())
    check(master_same, "the bf16 Imitator changed its float32 master")
    check(imit.compute_nets.generator.tsf_model.img_reg[0].weight.dtype
          == torch.bfloat16, "the compute copy is not bf16")
    print(f"slice: personalize and a 64-frame request at batch 16, bf16, "
          f"256^2; launches {launches}, source coverage {src_cov:.4f}; the "
          f"float32 master weights given to the bf16 Imitator are bit-"
          f"identical after the phase ({len(master_sd)} tensors)",
          flush=True)

    # -- phase 4b: the image-driven leg at full width -----------------------
    imit_h = imi.Imitator(cfg, assets=assets, device=dev)   # HMR included
    tgt_imgs = torch.from_numpy(target_images(64, 1)).to(dev)
    reset_counts(cr)
    src_h = imit_h.personalize(src_img)                # θ from HMR
    rows_after_pers_h = cr.zbuffer_bucket_rows.launches
    preds_h = imit_h.inference(tgt_imgs, batch=16)
    launches_h = read_counts(cr)
    check(rows_after_pers_h >= 1, "personalize(src_img) launched no rows")
    check(launches_h["zbuffer_bucket_flow"] == 4,
          f"full leg flow launches {launches_h['zbuffer_bucket_flow']}")
    check(tuple(preds_h.shape) == (64, GEOM["s"], GEOM["s"], 3),
          f"full leg preds shape {tuple(preds_h.shape)}")
    check(bool(torch.isfinite(preds_h).all()), "non-finite full leg preds")
    src_cov_h = float((src_h["fim"] >= 0).float().mean())
    check(src_cov_h > 0.02, f"HMR source body covers {src_cov_h}")
    mean_theta = torch.from_numpy(assets.mean_theta).to(dev)
    dev_theta = float((src_h["theta"] - mean_theta).abs().max())
    print(f"full leg: personalize(src_img) and a 64-frame request at batch "
          f"16 (HMR fp32 + generator bf16), 256^2; launches {launches_h}, "
          f"source coverage "
          f"{src_cov_h:.4f}, source max |theta - mean_theta| {dev_theta:.4f}",
          flush=True)


    # -- phase 7: appearance transfer at full width -------------------------
    from impersonator_tpu_torch.ops.projection import euler_to_matrix
    from impersonator_tpu_torch.tasks import swapper as swp
    from impersonator_tpu_torch.tasks import viewer as vwr
    s = GEOM["s"]
    tgt_img = np.ascontiguousarray(-src_img[:, ::-1])
    swapper = swp.Swapper(cfg, assets=assets, device=dev)
    reset_counts(cr)
    swapper.swap_setup(src_img, tgt_img, thetas[0], thetas[1])
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
    # the appearance-transfer chain: personalise the swapped image, then
    # drive it through a motion
    comp_state = swapper.personalize(swaps["body"][0].cpu().numpy(),
                                     thetas[0])
    reset_counts(cr)
    preds_w = swapper.imitate_by_smpls(comp_state, req_thetas, batch=16)
    launches_swap = read_counts(cr)
    check(launches_swap["zbuffer_bucket_flow"] == 4,
          f"swapped imitation flow launches {launches_swap}")
    check(tuple(preds_w.shape) == (64, s, s, 3) and
          bool(torch.isfinite(preds_w).all()), "swapped imitation preds")
    print(f"swap: swap_setup (2 personalisations), launches "
          f"{launches_setup}; the kept head covers {n_kept} px, of which "
          f"{differ:.4f} differ between 'body' and 'all' (max "
          f"{float(diff.max()):.4f}); swapped imitation of 64 frames at "
          f"batch 16, launches {launches_swap}, bf16, 256^2", flush=True)

    # -- phase 8: novel view at full width ----------------------------------
    viewer = vwr.Viewer(cfg, assets=assets, device=dev)
    reset_counts(cr)
    viewer.personalize(src_img, thetas[0])
    launches_pv = read_counts(cr)
    check(launches_pv["zbuffer_bucket_rows"] == 1,
          f"viewer personalize launches {launches_pv}")
    yaws = [22.5 * i for i in range(16)]
    reset_counts(cr)
    sweep = viewer.view_sweep(yaws)
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
    preds_v = viewer.view_by_smpls(view_thetas, batch=16)
    launches_view = read_counts(cr)
    check(launches_view["zbuffer_bucket_flow"] == 4,
          f"view_by_smpls launches {launches_view}")
    check(tuple(preds_v.shape) == (64, s, s, 3) and
          bool(torch.isfinite(preds_v).all()), "view_by_smpls preds")
    print(f"view: personalize, launches {launches_pv}; view_sweep of 16 "
          f"yaws, launches {launches_sweep}, coverage at yaw 0 / 90 "
          f"{covs[0]:.4f} / {covs[1]:.4f}; view_by_smpls of 64 views at "
          f"batch 16, launches {launches_view}, bf16, 256^2", flush=True)

    # -- phase 8b: DeepFill background, front warp ---------------------------
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
    src_bg = imit_bg.personalize(src_img, src_smpl=th_face)
    preds_bg = imit_bg.inference_by_smpls(face_thetas, batch=16)
    launches_bg = read_counts(cr)
    check(launches_bg["zbuffer_bucket_rows"] == 1 and
          launches_bg["zbuffer_bucket_flow"] == 4,
          f"DeepFill leg launches {launches_bg}")
    check(bool(torch.isfinite(src_bg["bg"]).all()), "non-finite background")
    check(bool(torch.isfinite(preds_bg).all()), "non-finite DeepFill preds")
    print(f"DeepFill + front warp: personalize (DeepFill fp32), background "
          f"mean |x| {float(src_bg['bg'].abs().mean()):.4f}; one 64-frame "
          f"request at batch 16, launches {launches_bg}, 256^2", flush=True)

    # -- phase 10: test-time post-tune at full width ------------------------
    (pt_launches, pt_sw_launches) = post_tune_phase(
        cr, imi, swapper, assets, cfg, src_img, thetas, req_thetas, dev)

    # -- phase 11: the adversarial trainer at full width --------------------
    train_launches, w_tr, t_tr = train_phase(cr, smpl_ops, assets, dev)
    errs["zbuffer_bucket_rows"] = max(errs["zbuffer_bucket_rows"], w_tr)
    errs["zbuffer_bucket_flow"] = max(errs["zbuffer_bucket_flow"], t_tr)

    # -- phase 12: host and device IO, serve and the CLIs -------------------
    io_launches = host_io_phase(cr, imi, imit_h, assets, cfg, src_img,
                                thetas, req_thetas, dev)

    # -- phase 13: the remaining trainers at full width ---------------------
    trainer_launches = remaining_trainers_phase(cr, smpl_ops, assets, dev)

    # -- phase 14: the evaluation suite ---------------------------------------
    eval_launches = evaluation_phase(cr, native, dev)

    # -- phase 15: the multi-card code paths on one card --------------------
    print(f"process state before phase 15: {process_state()}", flush=True)
    mc_launches = multi_card_phase(cr, imi, assets, cfg, imit_h, src_img,
                                   thetas, req_thetas, tgt_imgs, dev)
    print(f"process state after phase 15: {process_state()}", flush=True)

    # -- phase 16: the repository's tools on the port -----------------------
    tool_launches_by_path = tools_phase(cr, native, assets, dev)
    print(f"process state after phase 16: {process_state()}", flush=True)

    # -- phase 9: fp32 (TF32 off) card vs CPU: swap, view, DeepFill ----------
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
    print(f"process state at phase 5: {process_state()}", flush=True)
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
    print(f"process state at phase 5b: {process_state()}", flush=True)
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
               **io_launches, **trainer_launches, **eval_launches,
               **mc_launches, **tool_launches_by_path}
    record = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"impersonator_tpu_torch/csrc/{src}",
         "replaces": f"impersonator_tpu/ops/pallas_raster.py:{line}",
         "launches": path_launches[name],
         "launches_by_path": {p: c[name] for p, c in by_path.items()},
         "max_abs_err": errs[name]}
        for name, src, line in (
            ("zbuffer_bucket_rows", "zbuffer_bucket.cu", 365),
            ("zbuffer_bucket_flow", "zbuffer_bucket.cu", 413),
            ("zbuffer_tiles", "zbuffer_tiles.cu", 146))]}
    # the warp kernel replaces no TPU kernel; its launches on the full leg
    # (4b) and on each in-process path, where no CUDA warp ran the twin
    warp_paths = {p: c for p, c in by_path.items() if "warp_bilinear" in c}
    check(all(c["warp_twin_on_card"] == 0 for c in warp_paths.values()),
          f"a path ran the warp's twin on the card: {warp_paths}")
    record["kernels"].append({
        "name": "warp_bilinear", "route": "cuda",
        "source": "impersonator_tpu_torch/csrc/warp_bilinear.cu",
        "replaces": None, "launches": launches_h["warp_bilinear"],
        "launches_by_path": {p: c["warp_bilinear"]
                             for p, c in warp_paths.items()},
        "max_abs_err": warp_err})
    check(all(k["launches"] > 0 for k in record["kernels"]),
          f"a kernel never launched on its path: {path_launches}")
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
