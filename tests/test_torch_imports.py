"""Package rules of the port: importing `repro_torch` and every one of its
modules (the training, launch and distributed packages, `launch.mesh`,
`launch.specs`, `launch.compile_cache`, `launch.comm_analysis` and
`launch.dryrun` among them) loads no `jax` and no module of the JAX package
`repro`; the jax-free modules it keeps as copies stay verbatim copies, and those copied
with named edits differ from their originals in those lines only; the config
registry serves qwen2.5-3b, qwen3-32b, nemotron-4-15b, deepseek-67b,
llava-next-mistral-7b, falcon-mamba-7b, deepseek-v2-lite-16b, grok-1-314b,
zamba2-2.7b and whisper-medium -- every id of the JAX registry -- and
refuses an unknown one."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"

# modules the port keeps as copies of the JAX package's jax-free modules
COPIES = ["core/__init__.py", "core/difficulty.py", "core/executor.py",
          "core/expr.py", "core/ledger.py", "core/ordering.py",
          "core/scheduler.py", "core/session.py", "core/stats.py",
          "obs/__init__.py", "obs/metrics.py", "obs/report.py", "obs/trace.py",
          "data/tokens.py", "data/lm_data.py", "data/corpus.py",
          "index/segmenter.py", "extract/oracle.py", "models/config.py",
          "configs/qwen2_5_3b.py", "configs/falcon_mamba_7b.py",
          "configs/deepseek_v2_lite_16b.py", "configs/qwen3_32b.py",
          "configs/nemotron_4_15b.py", "configs/deepseek_67b.py",
          "configs/llava_next_mistral_7b.py", "configs/grok_1_314b.py",
          "configs/zamba2_2_7b.py", "configs/whisper_medium.py",
          "serving/prefix_cache.py", "serving/frontend.py",
          "extract/cascade.py", "extract/__init__.py",
          "live/__init__.py", "live/log.py", "live/corpus.py",
          "live/invalidate.py", "live/session.py",
          "configs/shapes.py", "launch/flops.py", "distributed/straggler.py"]

# modules copied with a few named lines changed: (JAX lines dropped, port
# lines added), import rewrites aside
EDITED = {
    "serving/costs.py": (
        ["PEAK_FLOPS = 197e12      # bf16 / chip",
         "HBM_BW = 819e9           # bytes/s / chip"],
        ["# published dense peaks of one H100 SXM: bf16 flop/s and HBM bytes/s",
         "PEAK_FLOPS = 989e12      # bf16 / card",
         "HBM_BW = 3.35e12         # bytes/s / card"]),
    "serving/replicas.py": (
        ["import jax",
         "",
         "                 share_kv_pool: bool = True, **engine_kwargs):",
         "            shared_alloc = PageAllocator(cfg, num_pages, page_size)",
         "            # shard once; each engine's device_put of already-sharded",
         "            # params is then a no-op instead of R host->device transfers",
         "            from repro.distributed.sharding import param_shardings",
         "            params = jax.device_put(params,",
         "                                    param_shardings(cfg, params, mesh))",
         "                **engine_kwargs)"],
        ["from repro_torch.distributed.sharding import shard_params",
         "from repro_torch.launch.mesh import mesh_device",
         "                 share_kv_pool: bool = True, device=None, **engine_kwargs):",
         "        device: where the shared pool and every replica run (None = the",
         "        CUDA device; on a mesh the rank's device, and device must be None).",
         "        alloc_device = device if mesh is None else mesh_device(mesh)",
         "            shared_alloc = PageAllocator(cfg, num_pages, page_size,",
         "                                         device=alloc_device)",
         "            # shard once: every engine takes the same shards as they are",
         "            params = shard_params(cfg, params, mesh, device=alloc_device)",
         "                device=device, **engine_kwargs)"]),
    "live/index.py": (
        ["    clone = HashedEmbedder(dim=base.dim)",
         "    clone._proj = base._proj           # immutable device array: share",
         "        cached = CachedEmbedder(embedder)",
         "            refit_idf=False)"],
        ["    clone = HashedEmbedder(dim=base.dim, device=base.device)",
         "    clone._proj = base._proj           # never written in place: share",
         "        cached = CachedEmbedder(embedder or HashedEmbedder(device=kwargs.get(\"device\")))",
         "            refit_idf=False, device=self.device)"]),
}


def _modules():
    for f in sorted(PORT.rglob("*.py")):
        parts = f.relative_to(SRC).with_suffix("").parts
        yield ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def test_port_imports_no_jax_and_no_repro():
    modules = list(_modules())
    for package in ("repro_torch.training", "repro_torch.launch", "repro_torch.distributed"):
        assert package in modules and any(m.startswith(package + ".") for m in modules)
    for name in ("mesh", "specs", "compile_cache", "comm_analysis", "dryrun"):
        assert f"repro_torch.launch.{name}" in modules, name
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
        "sys.exit(f'loaded: {bad}' if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(SRC)},
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) >= len(COPIES)


@pytest.mark.parametrize("rel", COPIES)
def test_copied_modules_stay_verbatim(rel):
    """A copy differs from its JAX original only in `repro.` -> `repro_torch.`
    on its import lines."""
    ours = (PORT / rel).read_text().splitlines()
    theirs = (SRC / "repro" / rel).read_text().splitlines()
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        if a != b:
            stripped = b.lstrip()
            assert stripped.startswith(("from repro.", "import repro.")), (rel, b)
            assert a == b.replace("repro.", "repro_torch.", 1), (rel, a)


@pytest.mark.parametrize("rel", sorted(EDITED))
def test_edited_copies_differ_only_in_named_lines(rel):
    """A copy with named edits: after the `repro.` -> `repro_torch.` import
    rewrite, the lines it drops from the JAX original and the lines it adds
    are exactly the named ones, in order."""
    import difflib
    ours = (PORT / rel).read_text().splitlines()
    theirs = []
    for b in (SRC / "repro" / rel).read_text().splitlines():
        if b.lstrip().startswith(("from repro.", "import repro.")) and \
                "distributed" not in b:
            b = b.replace("repro.", "repro_torch.", 1)
        theirs.append(b)
    dropped, added = [], []
    for op, i1, i2, j1, j2 in difflib.SequenceMatcher(
            None, theirs, ours, autojunk=False).get_opcodes():
        if op != "equal":
            dropped += theirs[i1:i2]
            added += ours[j1:j2]
    assert (dropped, added) == (EDITED[rel][0], EDITED[rel][1])


def test_config_registry():
    from repro.configs import get_config as jax_get_config
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    from repro_torch.configs import NOT_YET_PORTED, get_config, get_smoke_config

    import repro.configs.deepseek_67b as jd67
    import repro.configs.deepseek_v2_lite_16b as jd
    import repro.configs.falcon_mamba_7b as jf
    import repro.configs.grok_1_314b as jg
    import repro.configs.llava_next_mistral_7b as jl
    import repro.configs.nemotron_4_15b as jn
    import repro.configs.qwen2_5_3b as jq
    import repro.configs.qwen3_32b as jq3
    import repro.configs.whisper_medium as jw
    import repro.configs.zamba2_2_7b as jz
    ported = (("qwen2.5-3b", jq), ("falcon-mamba-7b", jf), ("deepseek-v2-lite-16b", jd),
              ("qwen3-32b", jq3), ("nemotron-4-15b", jn), ("deepseek-67b", jd67),
              ("llava-next-mistral-7b", jl), ("grok-1-314b", jg), ("zamba2-2.7b", jz),
              ("whisper-medium", jw))
    for arch, mod in ported:
        for get in ("CONFIG", "SMOKE"):
            ours = (get_config if get == "CONFIG" else get_smoke_config)(arch)
            assert vars(ours) == vars(getattr(mod, get))
    assert NOT_YET_PORTED == []
    assert sorted(a for a, _ in ported) == sorted(JAX_ARCH_IDS)
    for arch, _ in ported:
        jax_get_config(arch)                     # known to the reference
    with pytest.raises(KeyError):
        get_config("no-such-model")
