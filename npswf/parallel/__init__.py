from npswf.parallel.mesh import (
    make_mesh,
    make_sharded_pipeline,
    shard_calibration,
    shard_event_batch,
)

__all__ = ["make_mesh", "make_sharded_pipeline", "shard_calibration",
           "shard_event_batch"]
