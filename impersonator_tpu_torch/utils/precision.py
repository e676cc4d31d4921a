"""Full float32 precision for a block of code.

On Ampere and later cards float32 matmuls and cuDNN convolutions may run
in TF32 (a 10-bit mantissa), depending on two process-wide flags. The
geometry (SMPL skinning, the flow blend) and HMR, whose θ feeds that
geometry, need full float32, as the JAX package runs them at HIGHEST
precision. :func:`full_fp32` turns TF32 off inside its block only and
restores both flags on exit, so the rest of the process keeps its own
settings. :func:`without_cudnn` puts PyTorch's own CUDA kernels in place
of cuDNN's for a block, where cuDNN's float32 engines are slow.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32():
    """Float32 matmuls and cuDNN convolutions without TF32 inside the
    block; the previous flags come back on exit."""
    matmul = torch.backends.cuda.matmul
    cudnn = torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = False
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


@contextlib.contextmanager
def without_cudnn():
    """PyTorch's own CUDA kernels in place of cuDNN's inside the block
    (convolutions by im2col and a cuBLAS GEMM, norms and the sampler
    native); the previous flag comes back on exit. On an H100 80GB HBM3
    (torch 2.11, CUDA 12.8) cuDNN's float32 engine, TF32 off, for the
    generator's 256 -> 128 3×3 skip convolution at 128², batch 4, took
    ~380 ms a call against 1.4 ms this way, in every cuDNN mode
    (heuristics, benchmark, deterministic): a post-tune step 1.05 s
    against 0.26 s."""
    cudnn = torch.backends.cudnn
    saved = cudnn.enabled
    cudnn.enabled = False
    try:
        yield
    finally:
        cudnn.enabled = saved
