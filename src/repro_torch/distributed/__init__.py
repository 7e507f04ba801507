"""The port's distributed side (counterpart of `repro.distributed`): the
sharding rules and a rank's view of a serving mesh (`sharding`),
sequence-sharded decode (`decode`), pod-axis int8 gradient sync
(`compression`), the GPipe pipeline (`pipeline`) and straggler mitigation
(`straggler`, a copy of the JAX package's). Each rank is its own process on
a `DeviceMesh` (`launch.mesh`); the collectives that GSPMD inserts in the
JAX package are explicit `torch.distributed` calls here."""
