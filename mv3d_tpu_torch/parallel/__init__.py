"""Data parallelism over a device mesh: meshes, batch sharding, sharded
train and inference steps (``torch.distributed``)."""

from .mesh import (make_mesh, replicate, shard_batch,  # noqa: F401
                   make_sharded_train_step, make_sharded_infer_step)
