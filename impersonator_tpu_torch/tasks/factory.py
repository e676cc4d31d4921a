"""Task registry (torch port of ``impersonator_tpu/tasks/factory.py:14-26``).

The inference tasks and the single-card adversarial trainer are ported;
the augmented trainer and the ablation baselines come with ``ROADMAP.md``
Queue 1 items 10b-ii and 10c and raise until then.
"""

from __future__ import annotations

_NOT_PORTED = {
    "impersonator_trainer_aug": "10b-ii (trainer_aug)",
    "concat": "10c (ablation baselines)",
    "texture_warping": "10c (ablation baselines)",
    "feature_warping": "10c (ablation baselines)",
}


def get_by_name(name: str, cfg, device="cuda", **kwargs):
    """The task ``name`` on ``device`` (default CUDA). A trainer name
    returns the trainer (``tasks.trainer.Trainer``) of a TrainConfig."""
    if name == "imitator":
        from impersonator_tpu_torch.tasks.imitator import Imitator as cls
    elif name == "swapper":
        from impersonator_tpu_torch.tasks.swapper import Swapper as cls
    elif name == "viewer":
        from impersonator_tpu_torch.tasks.viewer import Viewer as cls
    elif name == "animator":
        from impersonator_tpu_torch.tasks.animator import Animator as cls
    elif name == "impersonator_trainer":
        from impersonator_tpu_torch.tasks.trainer import build_trainer
        return build_trainer(cfg, device=device, **kwargs)
    elif name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP.md Queue 1 item "
            f"{_NOT_PORTED[name]})")
    else:
        raise ValueError(f"Model {name} not recognized.")
    return cls(cfg, device=device, **kwargs)
