"""Evaluation metrics (torch port of ``impersonator_tpu/metrics``)."""

from impersonator_tpu_torch.metrics.metrics import (  # noqa: F401
    ssim,
    psnr,
    perceptual_distance,
    TYPES_QUALITIES,
    PairedMetricRunner,
)
from impersonator_tpu_torch.metrics.unpaired import (  # noqa: F401
    UnpairedMetricRunner,
    frechet_distance,
    frechet_distance_of,
    inception_score,
    gaussian_stats,
)
