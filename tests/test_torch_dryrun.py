"""The port's dry run (`repro_torch.launch.dryrun`, with
`launch.comm_analysis`) against the JAX package's, on the CPU:

- in a child process (the fake backend's default group must not meet a
  test worker's), decode cells of qwen2.5-3b, falcon-mamba-7b,
  zamba2-2.7b, deepseek-v2-lite-16b and whisper-medium at SMOKE on a fake
  2x4 mesh, and a train and a prefill cell, all "ok", with JAX's record
  keys; `main`'s `--out`, its skip of a cached key and `--force`; and the
  refusal to replace a default group someone else started;
- the counter is the same whether the collectives move data or not: on a
  fake 2x2 mesh (meta tensors) and on rank 0 of a real gloo 2x2 run (CPU
  tensors, `test_torch_distributed.run_ranks`) of the same SMOKE steps,
  the same collective kinds, counts, bytes and sites, and the same flops
  (a train step's FSDP gradient is a reduce-scatter on the fake backend,
  which stands for NCCL, and an all-reduce of the same operand on gloo);
- the skip records of all 40 cells equal `repro.configs.shapes.applicable`;
- `probe_config` and `VARIANT_OVERRIDES` equal JAX's, compared in a child
  process: `repro.launch.dryrun` sets XLA_FLAGS to 512 host devices when
  it is imported.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.shapes import applicable as jax_applicable  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs.shapes import SHAPE_ORDER  # noqa: E402
from test_torch_distributed import run_ranks  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
DECODE_ARCHS = ["qwen2.5-3b", "falcon-mamba-7b", "zamba2-2.7b", "deepseek-v2-lite-16b",
                "whisper-medium"]
RECORD_KEYS = {"arch", "shape", "mesh", "probe", "variant", "status", "run_s", "rank",
               "n_devices", "memory", "cost", "collectives", "model_flops",
               "attention_flops", "ssm_scan_flops", "param_count", "param_count_active"}
# the steps held to a real gloo run: SMOKE qwen2.5-3b at small shapes
SMALL = {"decode": (64, 4), "prefill": (32, 4), "train": (16, 4)}


def _child(code: str, tmp_path: Path, timeout: int = 600) -> list:
    """Run `code` in a fresh interpreter (one torch thread); returns the
    JSON objects it printed on lines starting with RESULT."""
    prog = "import json, sys, torch\ntorch.set_num_threads(1)\n" + \
        "def emit(x):\n    print('RESULT ' + json.dumps(x), flush=True)\n" + \
        textwrap.dedent(code)
    env = {"PYTHONPATH": str(REPO / "src") + os.pathsep + str(REPO / "tests"),
           "PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "OMP_NUM_THREADS": "1",
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         env=env, timeout=timeout, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(line[len("RESULT "):]) for line in out.stdout.splitlines()
            if line.startswith("RESULT ")]


@pytest.fixture(scope="module")
def smoke_cells(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    return tmp, _child("""
    import io, contextlib
    import torch.distributed as dist
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun

    dryrun.get_config = get_smoke_config
    dryrun.MESH_SHAPES["single"] = (2, 4)
    cells = [(a, "decode_32k") for a in %(archs)r] + \\
        [("qwen2.5-3b", "train_4k"), ("llava-next-mistral-7b", "prefill_32k")]
    for arch, shape in cells:
        emit(dryrun.run_cell(arch, shape, "single"))
    out = "results.json"
    for argv in (["--arch", "qwen2.5-3b", "--shape", "decode_32k"],
                 ["--arch", "qwen2.5-3b", "--shape", "decode_32k"],
                 ["--arch", "qwen2.5-3b", "--shape", "decode_32k", "--force"],
                 ["--arch", "qwen2.5-3b", "--shape", "long_500k"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            dryrun.main(argv + ["--out", out])
        emit({"argv": argv, "printed": buf.getvalue(),
              "keys": sorted(json.load(open(out))), "initialized": dist.is_initialized()})
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        dryrun.run_cell("qwen2.5-3b", "decode_32k", "single")
    except RuntimeError as e:
        emit({"refused": str(e)})
    """ % {"archs": DECODE_ARCHS}, tmp)


def test_smoke_cells_ok(smoke_cells):
    _, results = smoke_cells
    cells = [r for r in results if isinstance(r, list)]
    assert len(cells) == len(DECODE_ARCHS) + 2
    for key, rec in cells:
        assert rec["status"] == "ok", (key, rec.get("error"), rec.get("traceback"))
        assert key == f"{rec['arch']}|{rec['shape']}|single"
        assert RECORD_KEYS <= set(rec), key
        assert rec["n_devices"] == 8 and rec["rank"] == 0
        mem = rec["memory"]
        assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes",
                            "temp_size_in_bytes"}
        assert min(mem.values()) > 0, key
        assert set(rec["cost"]) == {"flops"} and rec["cost"]["flops"] > 0
        coll = rec["collectives"]
        assert coll["_total"] == sum(v for k, v in coll.items() if not k.startswith("_")) > 0
        assert set(coll["_counts"]) == {k for k in coll if not k.startswith("_")}
        assert set(coll["_counts"]) <= {"all-gather", "all-reduce", "reduce-scatter",
                                        "all-to-all", "collective-permute"}
        if rec["shape"] == "train_4k":
            assert rec["opt"] == "adamw" and coll["_counts"]["reduce-scatter"] > 0


def test_main_out_cache_and_force(smoke_cells):
    _, results = smoke_cells
    runs = [r for r in results if isinstance(r, dict) and "argv" in r]
    assert "[run] qwen2.5-3b|decode_32k|single" in runs[0]["printed"]
    assert "ok run=" in runs[0]["printed"]
    assert "[skip-cached] qwen2.5-3b|decode_32k|single" in runs[1]["printed"]
    assert "[run]" in runs[2]["printed"] and "[skip-cached]" not in runs[2]["printed"]
    assert "skipped" in runs[3]["printed"]
    assert runs[3]["keys"] == ["qwen2.5-3b|decode_32k|single", "qwen2.5-3b|long_500k|single"]
    assert not any(r["initialized"] for r in runs)       # main stops its group


def test_refuses_a_started_default_group(smoke_cells):
    _, results = smoke_cells
    refused = [r["refused"] for r in results if isinstance(r, dict) and "refused" in r]
    assert refused and "already started" in refused[0]


STEP = """
sys.path.insert(0, %(tests)r)
from repro_torch.configs import get_smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import comm_analysis as ca
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh

mesh = make_test_mesh(2, 2, device="cpu")
cfg = get_smoke_config("qwen2.5-3b")
for kind, (seq, batch) in %(small)r.items():
    shape = ShapeSpec(kind, kind, seq, batch)
    name = {"decode": "decode_32k", "prefill": "prefill_32k", "train": "train_4k"}[kind]
    _, _, fn, args, arg_bytes, _ = dryrun.build_step("qwen2.5-3b", name, mesh, cfg=cfg,
                                                     shape=shape, device=%(device)r)
    rec = ca.record_step(fn, *args, argument_bytes=arg_bytes)
    sites = sorted([list(s) for s in rec.collectives])
    emit(**{kind: {"bytes": ca.collective_bytes(rec), "flops": rec.flops, "sites": sites}})
"""


def test_fake_counts_equal_a_real_gloo_run(tmp_path):
    tests = str(Path(__file__).resolve().parent)
    real = run_ranks(STEP % {"tests": tests, "small": SMALL, "device": "cpu"}, 4, tmp_path)
    fake = _child(textwrap.dedent("""
    from repro_torch.launch import dryrun
    dryrun.start_fake_world(4)

    def emit(**kw):
        print("RESULT " + json.dumps(kw), flush=True)
    """) + STEP % {"tests": tests, "small": SMALL, "device": "meta"}, tmp_path)
    fake = {k: v for r in fake for k, v in r.items()}
    for kind in SMALL:
        want, got = real[0][kind], fake[kind]
        assert got["flops"] == want["flops"] > 0, kind
        sites = want["sites"]
        if kind == "train":
            # gloo has no reduce-scatter: the FSDP gradient's sum is an
            # all-reduce of the same (n, numel) operand there
            sites = sorted([b, "reduce-scatter" if s == "sharding._Gather.backward"
                            and k == "all-reduce" else k, d, s] for b, k, d, s in sites)
            assert any(s[1] == "reduce-scatter" for s in sites)
        assert got["sites"] == sites, kind
        assert got["bytes"]["_total"] == want["bytes"]["_total"] > 0, kind


def test_skip_records_equal_jax_applicable(tmp_path):
    """Every (arch, shape) cell: a skip where JAX's `applicable` skips, with
    its reason (run_cell returns before it starts any group), and none where
    JAX runs the cell."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import applicable
    from repro_torch.launch import dryrun
    n = 0
    for arch in ARCH_IDS:
        for shape in SHAPE_ORDER:
            ok, reason = jax_applicable(jax_get_config(arch), shape)
            assert applicable(get_config(arch), shape) == (ok, reason)
            if not ok:
                key, rec = dryrun.run_cell(arch, shape, "single")
                assert key == f"{arch}|{shape}|single"
                assert rec == {"arch": arch, "shape": shape, "mesh": "single", "probe": 0,
                               "variant": "baseline", "status": "skipped", "reason": reason}
            n += 1
    assert n == 40


def test_probe_config_and_overrides_equal_jax(tmp_path):
    out = _child("""
    import dataclasses
    from repro.launch import dryrun as jd
    from repro.configs import ARCH_IDS, get_config as jget
    from repro_torch.configs import get_config as tget
    from repro_torch.launch import dryrun as td
    assert td.VARIANT_OVERRIDES == jd.VARIANT_OVERRIDES
    for arch in ARCH_IDS:
        for n in (1, 2, 3):
            a = dataclasses.asdict(jd.probe_config(jget(arch), n))
            b = dataclasses.asdict(td.probe_config(tget(arch), n))
            assert a == b, (arch, n)
            emit([arch, n])
    """, tmp_path)
    assert len(out) == 3 * len(ARCH_IDS)
