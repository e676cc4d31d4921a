"""Device meshes, placement and multi-process training (torch port of
``impersonator_tpu/parallel``)."""

from impersonator_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    make_data_mesh,
    shard_batch,
    replicate,
    data_sharding,
)
