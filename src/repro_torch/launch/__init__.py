"""Launch-side helpers of the port: the analytic FLOP and byte models
(`flops`, a copy of the JAX package's). The JAX package's mesh and sharding
specs (`launch/mesh.py`, `launch/specs.py`) and its XLA-only tools belong to
the distributed slice and are not ported yet."""
