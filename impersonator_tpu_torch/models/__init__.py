"""Networks (torch nn.Modules, NCHW) and their registry (torch port of
``impersonator_tpu/models/__init__.py``, with its names)."""

_EXPORTS = {
    "ImpersonatorGenerator": "generator",
    "ResUnetGenerator": "generator",
    "ResNetGenerator": "generator",
    "PatchDiscriminator": "discriminator",
    "GlobalLocalDiscriminator": "discriminator",
    "MultiScaleDiscriminator": "discriminator",
    "InpaintSANet": "inpaintor",
    "HumanModelRecovery": "hmr",
}


def get_by_name(network_name: str, **kwargs):
    """The network ``network_name`` built with ``kwargs`` (the reference's
    NetworksFactory names)."""
    if network_name == "impersonator":
        from impersonator_tpu_torch.models.generator import \
            ImpersonatorGenerator as cls
    elif network_name == "deepfillv2":
        from impersonator_tpu_torch.models.inpaintor import \
            InpaintSANet as cls
    elif network_name == "discriminator_patch_gan":
        from impersonator_tpu_torch.models.discriminator import \
            PatchDiscriminator as cls
    elif network_name == "global_local":
        from impersonator_tpu_torch.models.discriminator import \
            GlobalLocalDiscriminator as cls
    elif network_name == "multi_scale":
        from impersonator_tpu_torch.models.discriminator import \
            MultiScaleDiscriminator as cls
    elif network_name == "hmr":
        from impersonator_tpu_torch.models.hmr import \
            HumanModelRecovery as cls
    else:
        raise ValueError(f"Network {network_name} not recognized.")
    return cls(**kwargs)


def __getattr__(name):
    # imported at first use: ``import impersonator_tpu_torch.models``
    # loads no network module
    if name in _EXPORTS:
        import importlib
        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = sorted(_EXPORTS) + ["get_by_name"]
