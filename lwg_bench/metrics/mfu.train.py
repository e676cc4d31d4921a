"""mfu.train: the least time of the window's samples (one step's FLOPs
counted over the reference's step, the generator's, the
discriminator's and VGG's in bfloat16 over 989 TFLOP/s, the face net's
and the geometry's in float32 over 67 TFLOP/s) over the window's
measured seconds, in percent."""


def read(rec):
    flops = rec.get("useful_flops")
    if not flops:
        return None
    peak = rec["peak"]
    return 100.0 * sum(v / peak[k] for k, v in flops.items()) \
        / rec["window_s"]
