"""personalize_ms: mean over the traced stretch's jobs of
``Imitator.personalize``, host clock from the call to a synchronise
after it."""


def read(rec):
    ms = rec.get("personalize_ms")
    return sum(ms) / len(ms) if ms else None
