"""impersonator_tpu_torch — the PyTorch / CUDA port of impersonator_tpu.

The JAX package ``impersonator_tpu`` stays the reference; this package
mirrors its module names and public names in PyTorch idiom and replaces
its Pallas TPU kernels with kernels written by hand for NVIDIA Hopper
(``csrc/``, built by nvcc at first use into ``_build/``). It imports
torch and never jax, and nothing of the JAX package: ``assets`` and
``config`` are its own copies of the JAX package's framework-free
modules. Entry points run on CUDA unless the caller asks for the CPU.

Layout
------
- ``ops``       SMPL, projection and cameras, the fim/wim rasterizer with
                its three hand-written z-buffer kernels
                (``ops.cuda_raster``: ``zbuffer_bucket_rows``,
                ``zbuffer_bucket_flow``, ``zbuffer_tiles``), flows,
                warping, morphology, the soft silhouette, colour spaces.
- ``models``    the LWB generator, DeepFill, the discriminators, HMR, the
                loss and face nets, the ablation baselines.
- ``tasks``     motion imitation (``Imitator``, also on a device mesh),
                appearance transfer (``Swapper``), novel view
                (``Viewer``), the animator, test-time post-tune, the base,
                augmented and baseline trainers.
- ``parallel``  device meshes (``Imitator(mesh=...)``) and multi-process
                training on ``torch.distributed``.
- ``data``      the datasets, the loader, the image codec (nvJPEG on the
                card, libjpeg on the CPU).
- ``metrics``   paired and unpaired metrics, LPIPS / Inception / face /
                re-id nets, MTCNN and YOLO.
- ``utils``     checkpoints, the JAX weight bridge (``utils.convert``,
                ``utils.checkpoint.read_flax_msgpack``), IO, video,
                profiling, precision scopes, person masks
                (``utils.detectors``).
- ``cli``       train, run_imitator, run_swap, run_view, serve, demos,
                evaluate.
"""
