"""Full float32 precision for a block of code.

On Ampere and later cards float32 matmuls and cuDNN convolutions may run
in TF32 (a 10-bit mantissa), depending on two process-wide flags. The
geometry (SMPL skinning, the flow blend) and HMR, whose θ feeds that
geometry, need full float32, as the JAX package runs them at HIGHEST
precision. :func:`full_fp32` turns TF32 off inside its block only and
restores both flags on exit, so the rest of the process keeps its own
settings. (Where cuDNN's float32 engines are slow for some shapes,
``ops.conv_route.float32_convs`` picks the backend per convolution.)
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
