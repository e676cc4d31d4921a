"""setup_s: seconds from the process's start to the measured window:
imports, CUDA start, the kernels' load (and build, in a fresh checkout),
the body, the weights, the inputs, the program and its warm-up."""


def read(rec):
    return rec["setup_s"]
