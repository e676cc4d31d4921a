"""mfu.posttune: the least time of the window's useful work (delivered
frames and each job's two personalisations as ``mfu.imitate`` counts
them, bfloat16 over 989 TFLOP/s and float32 over 67 TFLOP/s; each job's
pair batch and each tune step the program took, counted over the
reference in float32, over 67 TFLOP/s) over the window's measured
seconds, in percent."""


def read(rec):
    flops = rec.get("useful_flops")
    if not flops:
        return None
    peak = rec["peak"]
    return 100.0 * sum(v / peak[k] for k, v in flops.items()) \
        / rec["window_s"]
