"""body_flow_ms: ``tasks.trainer.body_recovery_flow`` on a ring batch,
CUDA events, median of 20, after the window."""


def read(rec):
    return rec.get("body_flow_ms")
