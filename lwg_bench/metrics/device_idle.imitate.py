"""device_idle.imitate: the share of the traced stretch's wall time in
which no operation ran on the device (1 minus the union of the device
intervals over the wall), in percent."""


def read(rec):
    prof = rec.get("profile")
    if not prof or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
