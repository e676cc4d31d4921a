"""Datasets and the batch loader of the trainer (torch; the names of
``impersonator_tpu/data/__init__.py``)."""

_EXPORTS = {
    "ImPerDataset": "datasets",
    "PlaceDataset": "datasets",
    "FashionPairDataset": "datasets",
    "ImPerPlaceDataset": "datasets",
    "ImPerFashionPlaceDataset": "datasets",
    "SyntheticPairDataset": "datasets",
    "dataset_by_name": "datasets",
    "DataLoader": "loader",
}


def __getattr__(name):
    # imported at first use: ``import impersonator_tpu_torch.data``
    # loads no dataset module (nor the codec)
    if name in _EXPORTS:
        import importlib
        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = sorted(_EXPORTS)
