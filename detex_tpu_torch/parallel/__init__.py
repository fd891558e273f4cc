"""Process groups, device meshes and the port's collectives
(counterpart of detex_tpu/parallel/)."""

from detex_tpu_torch.parallel.mesh import (make_mesh, replicated,
                                           shard_batch)

__all__ = ["make_mesh", "shard_batch", "replicated"]
