"""frames_per_s: every frame delivered to the host in the window over
the window's seconds (padding not counted)."""


def read(rec):
    if "jobs" not in rec or not rec["jobs"]:
        return None
    return sum(r[1] for r in rec["jobs"]) / rec["window_s"]
