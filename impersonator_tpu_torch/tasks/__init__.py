"""Task orchestration (torch; the names of
``impersonator_tpu/tasks/__init__.py``)."""

_EXPORTS = {
    "SMPLRenderer": "renderer",
    "Imitator": "imitator",
    "Swapper": "swapper",
    "Viewer": "viewer",
}


def __getattr__(name):
    # imported at first use: ``import impersonator_tpu_torch.tasks``
    # loads no task module
    if name in _EXPORTS:
        import importlib
        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = sorted(_EXPORTS)
