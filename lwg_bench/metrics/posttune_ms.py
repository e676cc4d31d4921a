"""posttune_ms: device ms of the program's ``posttune`` span a job (the
whole ``adaptive_personalize``: pair batch, tune steps, refresh and
second personalise), from the span table of one job traced after the
window with the host's ops; nothing where the program has no such
span."""


def read(rec):
    return rec.get("posttune_ms")
