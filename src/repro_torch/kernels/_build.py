"""Build and load the port's CUDA kernels (sources under `csrc/`).

Every `.cu` file is compiled by its own `nvcc` process, all started
together, for `sm_90a`; the objects are linked into one shared library with
a plain C interface, loaded with ctypes. The build happens at first use,
from the repository's sources only, into `build/repro_torch/` at the
repository root, keyed on a hash of the sources and flags, so an edited
kernel is rebuilt and an unchanged one is loaded as it is. A failed build
raises with nvcc's output. Nothing here runs at import time: this module
is imported on machines without a CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

# dtype codes of the C interface (csrc/common.cuh)
DTYPE_CODES = {"float32": 0, "bfloat16": 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "repro_topk_l2": [_P] * 4 + [_I] * 7 + [_P],
    "repro_paged_decode_attention": [_P] * 7 + [_I] * 10 + [_P],
    "repro_chunk_prefill_attention": [_P] * 6 + [_I] * 11 + [_P],
    "repro_paged_verify_attention": [_P] * 7 + [_I] * 11 + [_P],
    "repro_dense_decode_attention": [_P] * 6 + [_I] * 9 + [_P],
    "repro_dense_decode_attention_stats": [_P] * 7 + [_I] * 10 + [_P],
    "repro_bidirectional_attention": [_P] * 5 + [_I] * 11 + [_P],
    "repro_bidirectional_attention_sm90": [_P] * 4 + [_I] * 7 + [_P],
    "repro_ssm_scan": [_P] * 10 + [_I] * 7 + [_P],
    "repro_moe_gating": [_P, _I] + [_P] * 4 + [_I] * 8 + [_P],
}

_lib = None
build_info: dict = {}      # seconds, cached, ptxas report of the last load (kept
                           # beside the library, so a cached load reports it too)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or /usr/local/cuda/bin)")
    return path


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    out = BUILD_DIR / f"librepro_kernels-{_digest()}.so"
    log = out.with_suffix(".ptxas.txt")
    if out.exists():
        build_info.update(seconds=0.0, cached=True,
                          ptxas=log.read_text() if log.exists() else "")
        return out
    nvcc = _nvcc()
    work = BUILD_DIR / f"obj-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in _sources():
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _obj, p in procs:
        text, _ = p.communicate()
        logs.append(f"== {src.name}\n{text}")
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp = work / out.name
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                           *[str(obj) for _s, obj, _p in procs]],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    log.write_text("\n".join(logs))
    os.replace(tmp, out)
    shutil.rmtree(work, ignore_errors=True)
    build_info.update(seconds=time.perf_counter() - t0, cached=False,
                      ptxas="\n".join(logs))
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if rc != 0:
        msg = library().repro_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
