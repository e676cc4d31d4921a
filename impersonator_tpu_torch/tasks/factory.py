"""Task registry (torch port of ``impersonator_tpu/tasks/factory.py:14-26``).

The inference tasks are ported; the trainers and the ablation
baselines come with the training slice (``ROADMAP.md`` Queue 1 items 10b
and 10c) and raise until then.
"""

from __future__ import annotations

_TRAINERS = ("impersonator_trainer", "impersonator_trainer_aug", "concat",
             "texture_warping", "feature_warping")


def get_by_name(name: str, cfg, device="cuda", **kwargs):
    """The task ``name`` on ``device`` (default CUDA)."""
    if name == "imitator":
        from impersonator_tpu_torch.tasks.imitator import Imitator as cls
    elif name == "swapper":
        from impersonator_tpu_torch.tasks.swapper import Swapper as cls
    elif name == "viewer":
        from impersonator_tpu_torch.tasks.viewer import Viewer as cls
    elif name == "animator":
        from impersonator_tpu_torch.tasks.animator import Animator as cls
    elif name in _TRAINERS:
        raise NotImplementedError(
            f"{name}: the trainers and baselines are not ported yet "
            "(ROADMAP.md Queue 1 items 10b-10c, the training slice)")
    else:
        raise ValueError(f"Model {name} not recognized.")
    return cls(cfg, device=device, **kwargs)
