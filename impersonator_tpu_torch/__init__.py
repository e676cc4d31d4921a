"""impersonator_tpu_torch — the PyTorch / CUDA port of impersonator_tpu.

The JAX package ``impersonator_tpu`` stays the reference; this package
mirrors its module names (``ops``, ``models``, ``tasks``, ``utils``) in
PyTorch idiom and replaces its Pallas TPU kernels with kernels written
by hand for NVIDIA Hopper (``csrc/``, built by nvcc at first use into
``_build/``). It imports torch and never jax, and nothing of the JAX
package: ``assets`` and ``config`` are its own copies of the JAX
package's framework-free modules.

Ported so far: motion imitation — ``tasks.imitator.Imitator.personalize``
(from a given θ or from HMR, ``models.hmr``), ``inference_by_smpls`` and
``inference`` (HMR on each target image) — with all three z-buffer
kernels: ``ops.cuda_raster.zbuffer_bucket_rows`` and
``zbuffer_bucket_flow`` on the bucket path, ``zbuffer_tiles`` on the
fixed-slot tiled path that the renderer takes for meshes over 60,000
faces. Appearance transfer (``tasks.swapper.Swapper``), novel view
(``tasks.viewer.Viewer``) and the animator run on the same kernels, with
the DeepFill background net (``models.inpaintor``) when ``bg_model`` is
not ORIGINAL; ``tasks.factory.get_by_name`` builds any of these tasks.
``utils.convert`` carries generator, HMR and DeepFill weights over from
the JAX param trees.
"""
