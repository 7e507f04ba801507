"""The port's distributed primitives on gloo process groups on the CPU, one
child process per rank (`run_ranks`: `python -c` children that meet at a
`FileStore` under the test's tmp_path, one torch thread each), held to the
JAX package run single-device in the parent:

- sequence-sharded decode (`distributed.decode`): JAX
  `tests/test_distributed.py`'s case (B 4, S 64, Hkv 2, G 2, hd 16,
  lengths [17, 64, 33, 1]) on a 2x2 mesh with the cache sharded (data,
  model) and on the tuple axis ("data", "model"), against JAX
  `layers.decode_attention` at atol 1e-5; length-0 rows give zeros;
- int8 pod gradient sync (`distributed.compression`) on a pod axis of 2:
  the dequantized payload bit-identical to JAX's `_q8`/`_dq8` per pod, the
  mean error within 2.1 x scale, the pods in agreement, and no transform
  without a `pod` axis;
- the GPipe pipeline (`distributed.pipeline`): 4 stages, 6 microbatches
  against the sequential reference (JAX's tanh gelu) at atol 1e-5;
- `launch.mesh.make_serving_mesh`'s launch recipe when the world size is
  not the product of the shape.

The four-rank group runs once (`four_ranks`) and each test reads its part.
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401

REPO = Path(__file__).resolve().parents[1]

CHILD_PRELUDE = """
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD = int(os.environ["MESH_RANK"]), int(os.environ["MESH_WORLD"])
OUT = os.environ["MESH_OUT"]
dist.init_process_group("gloo", store=dist.FileStore(os.environ["MESH_STORE"], WORLD),
                        rank=RANK, world_size=WORLD)

def emit(**kw):
    print("RESULT " + json.dumps(kw), flush=True)
"""


def run_ranks(code: str, world: int, tmp_path: Path, timeout: int = 300) -> list:
    """Run `code` in `world` gloo ranks (the prelude starts the default
    process group; `OUT` is tmp_path, `emit(**kw)` reports). Returns each
    rank's merged `emit` dict, rank order."""
    prog = CHILD_PRELUDE + textwrap.dedent(code) + "\ndist.destroy_process_group()\n"
    store = tmp_path / "store"
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path), "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu",
           "MESH_WORLD": str(world), "MESH_STORE": str(store), "MESH_OUT": str(tmp_path)}
    procs = [subprocess.Popen([sys.executable, "-c", prog], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env={**env, "MESH_RANK": str(r)}) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {r} STDOUT:\n{out}\nSTDERR:\n{err[-3000:]}"
    results = []
    for _, out, _ in outs:
        merged = {}
        for line in out.splitlines():
            if line.startswith("RESULT "):
                merged.update(json.loads(line[len("RESULT "):]))
        results.append(merged)
    return results


B, S, HKV, G, HD = 4, 64, 2, 2, 16
LENGTHS = [17, 64, 33, 1]
ZERO_LENGTHS = [0, 64, 0, 9]
N_STAGES, N_MICRO, MB, D = 4, 6, 3, 8


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("four_ranks")
    rng = np.random.default_rng(0)
    np.savez(tmp / "inputs.npz",
             q=rng.standard_normal((B, 1, HKV, G, HD)).astype(np.float32),
             k=rng.standard_normal((B, S, HKV, HD)).astype(np.float32),
             v=rng.standard_normal((B, S, HKV, HD)).astype(np.float32),
             w_pod=rng.standard_normal((2, 512)).astype(np.float32),
             b=rng.standard_normal((8,)).astype(np.float32),
             g_pod=rng.standard_normal((2, 4, 512)).astype(np.float32),
             W=(rng.standard_normal((N_STAGES, D, D)) * 0.3).astype(np.float32),
             x=rng.standard_normal((N_MICRO, MB, D)).astype(np.float32))
    results = run_ranks("""
    import torch.nn.functional as F
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.compression import compressed_pod_mean, make_pod_grad_sync
    from repro_torch.distributed.decode import make_seq_sharded_decode_attn
    from repro_torch.distributed.pipeline import bubble_fraction, pipeline_forward
    from repro_torch.launch.mesh import axis_rank, make_serving_mesh, make_test_mesh

    inp = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(OUT, "inputs.npz")).items()}
    q, k, v = inp["q"], inp["k"], inp["v"]

    # sequence-sharded decode: (data, model) shards, then S over both axes
    mesh = make_test_mesh(2, 2, device="cpu")
    d, m = axis_rank(mesh, "data"), axis_rank(mesh, "model")
    rows, seq = slice(2 * d, 2 * d + 2), slice(32 * m, 32 * m + 32)
    attn = make_seq_sharded_decode_attn(mesh)
    for name, lengths in (("dm", %(lengths)r), ("dm0", %(zero)r)):
        out = attn(q[rows], k[rows, seq], v[rows, seq], torch.tensor(lengths)[rows])
        np.save(os.path.join(OUT, f"{name}_{RANK}.npy"), out.numpy())
    attn2 = make_seq_sharded_decode_attn(mesh, axis=("data", "model"))
    i = 2 * d + m
    seq2 = slice(16 * i, 16 * i + 16)
    for name, lengths in (("ws", %(lengths)r), ("ws0", %(zero)r)):
        out = attn2(q, k[:, seq2], v[:, seq2], torch.tensor(lengths))
        np.save(os.path.join(OUT, f"{name}_{RANK}.npy"), out.numpy())

    # int8 pod sync on a (pod 2, data 2, model 1) mesh
    pmesh = make_test_mesh(2, 1, multi_pod=True, device="cpu")
    pod = axis_rank(pmesh, "pod")
    grads = {"w": inp["w_pod"][pod:pod + 1].clone(), "b": inp["b"].clone(),
             "g": inp["g_pod"][pod].clone()}
    mean, resid = compressed_pod_mean(grads, pmesh.get_group("pod"))
    synced = make_pod_grad_sync(pmesh)(grads)
    for key in mean:
        np.save(os.path.join(OUT, f"mean_{key}_{RANK}.npy"), mean[key].numpy())
        assert torch.equal(synced[key], mean[key]), key
    np.save(os.path.join(OUT, f"resid_g_{RANK}.npy"), resid["g"].numpy())
    emit(no_pod=make_pod_grad_sync(mesh) is None,
         no_pod_plain=make_pod_grad_sync(mesh, compress=False) is None)

    # GPipe over a pod axis of 4 stages
    smesh = init_device_mesh("cpu", (4,), mesh_dim_names=("pod",))
    fwd = pipeline_forward(smesh, lambda w, x: F.gelu(x @ w, approximate="tanh"), %(n_micro)d)
    np.save(os.path.join(OUT, f"pipe_{RANK}.npy"), fwd(inp["W"], inp["x"]).numpy())
    emit(bubble=bubble_fraction(4, 6))

    try:
        make_serving_mesh((4, 4), device="cpu")
        emit(recipe="")
    except RuntimeError as e:
        emit(recipe=str(e))
    """ % {"lengths": LENGTHS, "zero": ZERO_LENGTHS, "n_micro": N_MICRO}, 4, tmp)
    return tmp, results


def _load(tmp, name, ranks=range(4)):
    return [np.load(tmp / f"{name}_{r}.npy") for r in ranks]


def _jax_decode(q, k, v, lengths):
    import jax.numpy as jnp
    from repro.models.layers import decode_attention
    return np.asarray(decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(lengths)))


def test_seq_sharded_decode_matches_jax(four_ranks):
    tmp, _ = four_ranks
    inp = np.load(tmp / "inputs.npz")
    want = _jax_decode(inp["q"], inp["k"], inp["v"], np.asarray(LENGTHS))
    dm = _load(tmp, "dm")
    # (data, model): data rank d holds rows 2d..2d+1; both model ranks agree
    for r in range(4):
        d = r // 2
        np.testing.assert_allclose(dm[r], want[2 * d:2 * d + 2], atol=1e-5)
    # S over (data, model): batch replicated, every rank holds every row
    for out in _load(tmp, "ws"):
        np.testing.assert_allclose(out, want, atol=1e-5)


def test_seq_sharded_decode_zero_length_rows(four_ranks):
    tmp, _ = four_ranks
    inp = np.load(tmp / "inputs.npz")
    want = _jax_decode(inp["q"], inp["k"], inp["v"], np.asarray(ZERO_LENGTHS))
    live = np.asarray(ZERO_LENGTHS) > 0
    full = np.concatenate([_load(tmp, "dm0")[0], _load(tmp, "dm0")[2]])
    for out in (full, *_load(tmp, "ws0")):
        assert np.all(out[~live] == 0)
        np.testing.assert_allclose(out[live], want[live], atol=1e-5)


def test_compressed_pod_mean_matches_jax_q8(four_ranks):
    import jax.numpy as jnp
    from repro.training.optim import _dq8, _q8
    tmp, _ = four_ranks
    inp = np.load(tmp / "inputs.npz")
    # ranks 0, 1 are pod 0 and ranks 2, 3 pod 1 (pod is the major axis)
    dq = [np.asarray(_dq8(*_q8(jnp.asarray(inp["g_pod"][p]), 256), 256)) for p in (0, 1)]
    want = (dq[0] + dq[1]) / np.float32(2)
    for r, got in enumerate(_load(tmp, "mean_g")):
        assert np.array_equal(got, want), r
    for r, res in enumerate(_load(tmp, "resid_g")):
        assert np.array_equal(res, inp["g_pod"][r // 2] - dq[r // 2]), r
    exact = inp["g_pod"].mean(axis=0)
    scale = np.abs(inp["g_pod"]).max() / 127
    for got in _load(tmp, "mean_g"):
        assert np.abs(got - exact).max() <= 2.1 * scale


def test_compressed_pod_mean_exempt_leaves_and_agreement(four_ranks):
    """JAX's case: a (1, 512) pod shard and an (8,) bias are below 4
    blocks and go in float32; the pods agree to 1e-7."""
    tmp, results = four_ranks
    inp = np.load(tmp / "inputs.npz")
    w = _load(tmp, "mean_w")
    want = (inp["w_pod"][0] + inp["w_pod"][1]) / 2
    scale = np.abs(inp["w_pod"]).max() / 127
    assert np.abs(w[0][0] - want).max() <= 2.1 * scale
    for key in ("w", "g", "b"):
        outs = _load(tmp, f"mean_{key}")
        for out in outs[1:]:
            np.testing.assert_allclose(out, outs[0], atol=1e-7)
    np.testing.assert_allclose(_load(tmp, "mean_b")[0], inp["b"], atol=1e-7)
    assert all(r["no_pod"] and r["no_pod_plain"] for r in results)


def test_pipeline_matches_sequential(four_ranks):
    import jax
    import jax.numpy as jnp
    tmp, results = four_ranks
    inp = np.load(tmp / "inputs.npz")
    want = jnp.asarray(inp["x"])
    for s in range(N_STAGES):
        want = jax.nn.gelu(want @ jnp.asarray(inp["W"][s]))
    for got in _load(tmp, "pipe"):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    assert all(abs(r["bubble"] - 3 / 9) < 1e-9 for r in results)


def test_make_serving_mesh_gives_the_launch_recipe(four_ranks):
    _, results = four_ranks
    for r in results:
        assert "needs 16 ranks" in r["recipe"] and "world_size=16" in r["recipe"], r
    from repro_torch.launch.mesh import make_serving_mesh
    if not torch.distributed.is_initialized():
        with pytest.raises(RuntimeError, match="init_process_group"):
            make_serving_mesh((2, 2), device="cpu")
