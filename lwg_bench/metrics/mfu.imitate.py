"""mfu.imitate: the least time of the window's useful work (delivered
frames, each job's personalisation, HMR on regressed sources and
targets; FLOPs counted over the reference, bfloat16 over 989 TFLOP/s,
float32 over 67 TFLOP/s) over the window's measured seconds, in
percent."""


def read(rec):
    flops = rec.get("useful_flops")
    if not flops:
        return None
    peak = rec["peak"]
    least = sum(v / peak[k] for k, v in flops.items())
    return 100.0 * least / rec["window_s"]
