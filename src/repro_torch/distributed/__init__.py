"""Model parallelism: the sharding rules and the mesh context."""
