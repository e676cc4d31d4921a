"""allreduce_ms: device ms a step of the program's ``train.allreduce``
span on rank 0 (``parallel.distributed.all_reduce_mean_`` of the
gradients and the metrics in ``step_nets``), from the span table of
steps traced after the window with the host's ops; nothing where the
program has no such span."""


def read(rec):
    return rec.get("allreduce_ms")
