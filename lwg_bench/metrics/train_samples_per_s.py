"""train_samples_per_s: the samples of every G + D step of the window
over the window's seconds, synchronised only at its ends."""


def read(rec):
    if not rec.get("steps"):
        return None
    return rec["steps"] * rec["batch"] / rec["window_s"]
