"""Task registry (torch port of ``impersonator_tpu/tasks/factory.py:14-37``):
the inference drivers, and the trainer of each training model name — the
base trainer, the background-augmented one and the three ablation
baselines."""

from __future__ import annotations


def get_by_name(name: str, cfg, device="cuda", **kwargs):
    """The task ``name`` on ``device`` (default CUDA). A trainer name
    returns the trainer (``tasks.trainer.Trainer`` or its subclass) of a
    TrainConfig."""
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
    elif name == "impersonator_trainer_aug":
        from impersonator_tpu_torch.tasks.trainer_aug import \
            build_aug_trainer
        return build_aug_trainer(cfg, device=device, **kwargs)
    elif name in ("concat", "texture_warping", "feature_warping"):
        from impersonator_tpu_torch.tasks.trainer_baseline import \
            build_baseline_trainer
        return build_baseline_trainer(cfg, device=device, **kwargs)
    else:
        raise ValueError(f"Model {name} not recognized.")
    return cls(cfg, device=device, **kwargs)
