"""Launch-side helpers of the port: the analytic FLOP and byte models
(`flops`, a copy of the JAX package's) and the mesh functions over
`torch.distributed` (`mesh`). The JAX package's abstract specs
(`launch/specs.py`) and its XLA-only tools are not ported yet (ROADMAP.md
Queue 1)."""
