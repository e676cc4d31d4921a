"""hmr_ms: ``Imitator.regress_smpl`` on a staged batch of crops, CUDA
events, median of 20, after the window."""


def read(rec):
    return rec.get("hmr_ms")
