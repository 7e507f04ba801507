"""Launch-side helpers of the port: the analytic FLOP and byte models
(`flops`, a copy of the JAX package's), the mesh functions over
`torch.distributed` (`mesh`), the abstract specs on the meta device
(`specs`), and the counterparts of the JAX package's XLA tools: the kernel
library's persistent cache (`compile_cache`, for `compile_cache.py`), the
collective, memory and flop accounting of a step counted while it runs
(`comm_analysis`, for `hlo_analysis.py`) and the production dry run
(`dryrun`, run as `python -m repro_torch.launch.dryrun`).

`specs` imports the models, the sharding rules and the optimizers, which
import `launch.mesh`; so its names and the other tools' are exported
lazily (PEP 562), and importing `launch.mesh` does not import them."""
import importlib

_SPECS = ("Abstract", "abstract_cache", "abstract_cache_ws2d", "abstract_opt_state",
          "abstract_params", "default_microbatch", "default_opt_cfg", "input_specs")
_TOOLS = {"enable_compilation_cache": "compile_cache",
          "compilation_cache_dir": "compile_cache",
          "record_step": "comm_analysis", "collective_bytes": "comm_analysis",
          "collective_bytes_by_site": "comm_analysis",
          "memory_analysis_dict": "comm_analysis", "cost_analysis_dict": "comm_analysis",
          "probe_config": "dryrun", "run_cell": "dryrun", "build_step": "dryrun"}
_MODULES = ("specs", "compile_cache", "comm_analysis", "dryrun")

__all__ = list(_SPECS) + list(_TOOLS) + list(_MODULES)


def __getattr__(name):
    if name in _MODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name in _SPECS or name in _TOOLS:
        module = importlib.import_module(f"{__name__}.{_TOOLS.get(name, 'specs')}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
