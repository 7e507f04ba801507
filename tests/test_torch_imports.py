"""Package rules of the port: importing `repro_torch` and every one of its
modules loads no `jax` and no module of the JAX package `repro`; the
jax-free modules it keeps as copies stay verbatim copies; the config
registry serves qwen2.5-3b, falcon-mamba-7b and deepseek-v2-lite-16b and
refuses the families not yet ported."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

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
          "configs/deepseek_v2_lite_16b.py",
          "serving/prefix_cache.py"]


def _modules():
    for f in sorted(PORT.rglob("*.py")):
        parts = f.relative_to(SRC).with_suffix("").parts
        yield ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def test_port_imports_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {list(_modules())!r}:\n"
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


def test_config_registry():
    from repro.configs import get_config as jax_get_config
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    from repro_torch.configs import NOT_YET_PORTED, get_config, get_smoke_config

    import repro.configs.deepseek_v2_lite_16b as jd
    import repro.configs.falcon_mamba_7b as jf
    import repro.configs.qwen2_5_3b as jq
    ported = (("qwen2.5-3b", jq), ("falcon-mamba-7b", jf), ("deepseek-v2-lite-16b", jd))
    for arch, mod in ported:
        for get in ("CONFIG", "SMOKE"):
            ours = (get_config if get == "CONFIG" else get_smoke_config)(arch)
            assert vars(ours) == vars(getattr(mod, get))
    assert sorted(NOT_YET_PORTED + [a for a, _ in ported]) == sorted(JAX_ARCH_IDS)
    for arch in NOT_YET_PORTED:
        jax_get_config(arch)                     # known to the reference
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
            get_config(arch)
    with pytest.raises(KeyError):
        get_config("no-such-model")
