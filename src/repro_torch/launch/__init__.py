"""Launch-side helpers of the port: the analytic FLOP and byte models
(`flops`, a copy of the JAX package's), the mesh functions over
`torch.distributed` (`mesh`) and the abstract specs on the meta device
(`specs`). The JAX package's XLA-only tools (`dryrun`, `hlo_analysis`,
`compile_cache`) are not ported yet (ROADMAP.md Queue 1).

`specs` imports the models, the sharding rules and the optimizers, which
import `launch.mesh`; so its names are exported lazily (PEP 562), and
importing `launch.mesh` does not import them."""
import importlib

_SPECS = ("Abstract", "abstract_cache", "abstract_cache_ws2d", "abstract_opt_state",
          "abstract_params", "default_microbatch", "default_opt_cfg", "input_specs")

__all__ = list(_SPECS) + ["specs"]


def __getattr__(name):
    if name == "specs" or name in _SPECS:
        specs = importlib.import_module(f"{__name__}.specs")
        return specs if name == "specs" else getattr(specs, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
