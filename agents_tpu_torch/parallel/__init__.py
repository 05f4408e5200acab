from agents_tpu_torch.parallel.mesh_utils import (Mesh, batch_sharded,
                                                  create_mesh, replicated,
                                                  shard_loop_state)

__all__ = ["Mesh", "batch_sharded", "create_mesh", "replicated",
           "shard_loop_state"]
