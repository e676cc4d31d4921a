"""Device-side geometry and image ops (torch; the names of
``impersonator_tpu/ops/__init__.py``)."""

_EXPORTS = {
    "batch_rodrigues": "smpl",
    "batch_orth_proj_idrot": "smpl",
    "smpl_forward": "smpl",
    "SMPLParams": "smpl",
    "orthographic_proj_withz_idrot": "projection",
    "look_at": "projection",
    "euler_to_matrix": "projection",
    "DEFAULT_EYE_Z": "projection",
    "rasterize_fim_wim": "rasterizer",
    "project_to_raster_space": "rasterizer",
    "correspondence_flow": "flow",
    "visible_f2pts": "flow",
    "null_visible_f2pts": "flow",
    "encode_fim": "flow",
    "grid_sample": "sampler",
    "resize_bilinear_align": "sampler",
    "resize_flow": "sampler",
    "morph": "morphology",
    "rgb_to_i420": "colorspace",
    "i420_to_rgb": "colorspace",
}


def __getattr__(name):
    # imported at first use: ``import impersonator_tpu_torch.ops``
    # loads no op module
    if name in _EXPORTS:
        import importlib
        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = sorted(_EXPORTS)
