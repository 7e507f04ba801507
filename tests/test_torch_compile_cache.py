"""`repro_torch.launch.compile_cache` against the JAX package's: the same two
functions, the directory made when missing, idempotent per directory, a
second directory re-pointing the cache; the kernel library then loaded from
that directory without nvcc (a file named by the sources' digest stands in
for the library where no CUDA toolkit is installed); and
`ServingEngine(compilation_cache_dir=)`, which the JAX engine takes, on
the CPU."""
import inspect

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401

from repro.launch import compile_cache as jax_cache  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import compile_cache  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402


@pytest.fixture
def fresh(monkeypatch):
    """The module's state and the build directory, restored after the test."""
    monkeypatch.setattr(compile_cache, "_enabled_dir", None)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(_build, "build_info", {})
    return compile_cache


def test_signatures_match_jax():
    for name in ("enable_compilation_cache", "compilation_cache_dir"):
        assert inspect.signature(getattr(compile_cache, name)) == \
            inspect.signature(getattr(jax_cache, name))
    mine = inspect.signature(ServingEngine).parameters["compilation_cache_dir"]
    theirs = inspect.signature(JaxEngine).parameters["compilation_cache_dir"]
    assert mine.default is theirs.default is None


def test_enable_creates_repoints_and_is_idempotent(fresh, tmp_path):
    assert fresh.compilation_cache_dir() is None
    first = tmp_path / "a" / "kernels"
    assert fresh.enable_compilation_cache(str(first)) is True
    assert first.is_dir()
    assert fresh.compilation_cache_dir() == str(first)
    assert _build.BUILD_DIR == first
    assert fresh.enable_compilation_cache(str(first), min_entry_size_bytes=1 << 20,
                                          min_compile_time_secs=5.0) is True
    assert fresh.compilation_cache_dir() == str(first)
    second = tmp_path / "b"
    assert fresh.enable_compilation_cache(str(second)) is True
    assert second.is_dir() and _build.BUILD_DIR == second
    assert fresh.compilation_cache_dir() == str(second)
    blocked = tmp_path / "file"
    blocked.write_text("")
    assert fresh.enable_compilation_cache(str(blocked / "sub")) is False
    assert fresh.compilation_cache_dir() == str(second)


def test_cached_library_loads_without_nvcc(fresh, tmp_path, monkeypatch):
    """A library named by the digest of the sources in the directory is
    returned as it is, with `cached` true, and nvcc is never looked for;
    with no such file the build needs nvcc."""
    def no_nvcc():
        raise AssertionError("nvcc started")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    fresh.enable_compilation_cache(str(tmp_path))
    lib = tmp_path / f"librepro_kernels-{_build._digest()}.so"
    lib.write_bytes(b"\x7fELF")
    (lib.with_suffix(".ptxas.txt")).write_text("ptxas info : Used 32 registers")
    assert _build.build() == lib
    assert _build.build_info["cached"] is True and _build.build_info["seconds"] == 0.0
    assert "32 registers" in _build.build_info["ptxas"]
    lib.unlink()
    with pytest.raises(AssertionError, match="nvcc started"):
        _build.build()


def test_engine_takes_the_cache_dir(fresh, tmp_path):
    cfg = get_smoke_config("qwen2.5-3b")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServingEngine(cfg, params, slots=2, max_len=64, device="cpu",
                        compilation_cache_dir=str(tmp_path / "cache"))
    assert fresh.compilation_cache_dir() == str(tmp_path / "cache")
    assert _build.BUILD_DIR == tmp_path / "cache"
    eng.submit(Request(rid=0, prompt=[5, 6, 7, 8], max_new=3, eos_id=-1))
    assert len(eng.run()[0].out) == 3
