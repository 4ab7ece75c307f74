"""Distribution substrate of the port: logical-axis sharding rules and
DTensor placements on a DeviceMesh, compressed collectives, and pipeline
parallelism.

  sharding     ShardingRules (logical->mesh axis tables), NamedSharding and
               the placements of a spec, the mesh context, and shard_act
               activation constraints.
  collectives  int8-quantized DP all-reduce with error feedback.
  pipeline     GPipe-style microbatch pipeline over a mesh axis.
"""
from . import collectives, pipeline, sharding  # noqa: F401
