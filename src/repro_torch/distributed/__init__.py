from .sharding import (DEFAULT_RULES, Mesh, NamedSharding, P, PartitionSpec,
                       ShardingRules, active_mesh, constrain, logical_spec,
                       named_sharding, sharding_ctx)

__all__ = ["ShardingRules", "DEFAULT_RULES", "sharding_ctx", "constrain",
           "active_mesh", "logical_spec", "named_sharding", "Mesh",
           "NamedSharding", "PartitionSpec", "P"]
