"""The slab KV layout on the port against the JAX package: K5's plain
version against `decode_attention_pallas` in interpret mode and its jnp
references; the slab cache surgery and model functions (`prefill`, slab
decode and verify) on bridged SMOKE qwen2.5-3b weights; and the slab
engine, whose tokens, every `stats` counter (kv_bytes_peak included) and
bucketed prefill lengths must equal the JAX engine's."""
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.decode_attention import decode_attention_pallas  # noqa: E402
from repro.models import cache_ops as jops  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_decode_cache as jax_init_decode_cache  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models import verify_chunk as jax_verify_chunk  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.kernels import decode_attention as k5  # noqa: E402
from repro_torch.kernels import flash_attention as k2  # noqa: E402
from repro_torch.kernels import verify_attention as k4  # noqa: E402
from repro_torch.models import (decode_step_slab, init_decode_cache,  # noqa: E402
                                prefill, verify_chunk_slab)
from repro_torch.models import cache_ops as tops  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from test_torch_serving import weights  # noqa: E402,F401

F32_TOL = 2e-5
TOL = 2e-5
MAX_LEN = 64
SHARED = [7, 3, 9, 4, 2, 8, 1, 6, 5, 7, 3, 2]


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------ K5 plain version ---


@pytest.mark.parametrize("B,S,H,Hkv,D,length", [
    (2, 512, 4, 2, 64, 317),
    (1, 1024, 8, 8, 128, 1024),
    (3, 256, 2, 1, 64, 19),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_decode_plain_matches_pallas(B, S, H, Hkv, D, length, dtype):
    """The shapes of the JAX package's own K5 test (`tests/test_kernels.py`),
    a scalar length broadcast by the wrapper."""
    rng = np.random.default_rng(0)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jargs = [jnp.asarray(_rand(rng, shape)).astype(jdt)
             for shape in ((B, H, D), (B, S, Hkv, D), (B, S, Hkv, D))]
    want = np.asarray(decode_attention_pallas(*jargs, length, bk=128, interpret=True),
                      np.float32)
    want_ref = np.asarray(ref.decode_attention_ref(*jargs, length), np.float32)
    targs = [_t(np.array(a, np.float32)).to(tdt) for a in jargs]
    got = k5.decode_attention(*targs, length)
    assert got.shape == (B, H, D) and got.dtype == tdt
    tol = F32_TOL if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    np.testing.assert_allclose(got.float().numpy(), want_ref, atol=tol, rtol=tol)
    assert k5.dense_launches == 0        # a CPU tensor never reaches the kernel


def test_dense_decode_plain_per_row_lengths():
    """Per-row lengths, as the slab engine passes them (pos + 1), against
    the jnp `layers.decode_attention` the JAX model runs: length 1, S, one
    past S (a slot that is not live, whose walk is bounded by S), and a
    zero length, which gives zeros."""
    rng = np.random.default_rng(1)
    B, S, H, Hkv, D = 4, 48, 4, 2, 16
    q = _rand(rng, (B, H, D))
    kc = _rand(rng, (B, S, Hkv, D))
    vc = _rand(rng, (B, S, Hkv, D))
    lengths = np.asarray([1, S, S + 1, 0], np.int32)
    got = k5.decode_attention(_t(q), _t(kc), _t(vc), _t(lengths)).numpy()
    want = np.asarray(jl.decode_attention(
        jnp.asarray(q).reshape(B, 1, Hkv, H // Hkv, D), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(lengths))).reshape(B, H, D)
    np.testing.assert_allclose(got[:3], want[:3], atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_array_equal(got[3], np.zeros((H, D), np.float32))
    scalar = k5.decode_attention(_t(q), _t(kc), _t(vc), torch.tensor(17, dtype=torch.int32))
    want17 = np.asarray(ref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), 17))
    np.testing.assert_allclose(scalar.numpy(), want17, atol=F32_TOL, rtol=F32_TOL)


def test_dense_decode_no_silent_cpu_fallback():
    with pytest.raises(ValueError):
        k5.decode_attention(torch.empty((1, 2, 8), device="meta"), None, None, 1)


# ------------------------------------------------------ slab cache ops -----


def test_cache_write_drops_out_of_bounds_rows():
    """Per-row writes: a row at or past Smax is dropped (as the JAX
    scatter drops it), a scalar position is clamped (as
    `dynamic_update_slice` clamps it); the per-row chunk write drops the
    tail past the bound and never clamps it backward over valid K/V."""
    rng = np.random.default_rng(2)
    B, S, Hkv, D, C = 3, 8, 2, 4, 4
    cache = _rand(rng, (B, S, Hkv, D))
    new1 = _rand(rng, (B, 1, Hkv, D))
    newc = _rand(rng, (B, C, Hkv, D))
    for pos in (np.asarray([2, 8, 11], np.int32), np.asarray(9, np.int32)):
        want = np.asarray(jl.cache_write(jnp.asarray(cache), jnp.asarray(new1),
                                         jnp.asarray(pos)))
        got = tl.cache_write(_t(cache.copy()), _t(new1), torch.tensor(pos)).numpy()
        np.testing.assert_array_equal(got, want)
    for start in (np.asarray([0, 6, 8], np.int32), 6):
        want = np.asarray(jl.cache_write_chunk(jnp.asarray(cache), jnp.asarray(newc),
                                               jnp.asarray(start, jnp.int32)))
        got = tl.cache_write_chunk(_t(cache.copy()), _t(newc),
                                   _t(start) if isinstance(start, np.ndarray) else start)
        np.testing.assert_array_equal(got.numpy(), want)


def _assert_cache_close(tcache, jcache, upto=None):
    for k in ("k", "v"):
        a = tcache[k].numpy()[:, :, :upto]
        b = np.asarray(jcache[k])[:, :, :upto]
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL, err_msg=k)
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))


def test_slab_snapshot_ops_and_nbytes(weights):
    """write_slot / slot_cache / prefix_snapshot / expand_snapshot against
    the JAX functions, byte counts included (they enter kv_bytes_peak and
    PrefixCache.nbytes)."""
    jcfg, _, tcfg, _, _ = weights
    rng = np.random.default_rng(3)
    jc = jax_init_decode_cache(jcfg, 3, MAX_LEN)
    jc["pos"] = jnp.zeros((3,), jnp.int32)
    tc = init_decode_cache(tcfg, 3, MAX_LEN, device="cpu")
    tc["pos"] = torch.zeros((3,), dtype=torch.int32)
    assert tops.cache_nbytes(tc) == jops.cache_nbytes(jc)
    sub_np = {"pos": np.asarray(21, np.int32),
              "k": _rand(rng, jc["k"][:, :1].shape), "v": _rand(rng, jc["v"][:, :1].shape)}
    jc = jops.write_slot(jc, {k: jnp.asarray(v) for k, v in sub_np.items()}, 1)
    tops.write_slot(tc, {k: _t(v) for k, v in sub_np.items()}, 1)
    _assert_cache_close(tc, jc)
    jsnap = jops.prefix_snapshot(jops.slot_cache(jc, 1), 21)
    tsnap = tops.prefix_snapshot(tops.slot_cache(tc, 1), 21)
    assert tops.cache_nbytes(tsnap) == jops.cache_nbytes(jsnap)
    _assert_cache_close(tsnap, jsnap)
    tops.write_slot(tc, {k: torch.zeros_like(v) for k, v in tops.slot_cache(tc, 1).items()}, 1)
    assert float(tsnap["k"].abs().sum()) > 0          # the snapshot is a copy
    jexp, texp = jops.expand_snapshot(jsnap, MAX_LEN), tops.expand_snapshot(tsnap, MAX_LEN)
    assert tops.cache_nbytes(texp) == jops.cache_nbytes(jexp)
    _assert_cache_close(texp, jexp)


# ---------------------------------------------------- slab model forward ---


def test_slab_prefill_decode_verify_match_jax(weights):
    """Bucketed prefill (logits at the true length, the whole cache),
    scalar-pos decode of a B=1 sub-cache, then a batched cache: per-row
    decode with a row that is not live past max_len, and a verify chunk
    whose padded tail crosses the bound."""
    jcfg, jparams, tcfg, tparams, _ = weights
    rng = np.random.default_rng(4)
    n, bucket = 23, 30
    toks = [int(t) for t in rng.integers(0, 256, size=n)] + [0] * (bucket - n)
    jlog, jc = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray([toks])}, MAX_LEN,
                           length=jnp.asarray(n, jnp.int32))
    tlog, tc = prefill(tcfg, tparams, torch.as_tensor([toks]), MAX_LEN, length=n)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL, rtol=TOL)
    _assert_cache_close(tc, jc)
    assert tc["pos"].ndim == 0 and int(tc["pos"]) == n
    for t in (5, 9, 200):                               # scalar-pos decode
        jlog, jc = jax_decode_step(jcfg, jparams, jnp.asarray([[t]]), jc)
        tlog, tc = decode_step_slab(tcfg, tparams, torch.as_tensor([[t]]), tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL, rtol=TOL)
    _assert_cache_close(tc, jc)

    # batched: row 0 holds the sequence, row 1 is a free slot past max_len,
    # row 2 sits near the bound
    jb = jax_init_decode_cache(jcfg, 3, MAX_LEN)
    jb = jops.write_slot(jb, jc, 0)
    jb["pos"] = jnp.asarray([int(jc["pos"]), MAX_LEN + 5, MAX_LEN - 3], jnp.int32)
    tb = init_decode_cache(tcfg, 3, MAX_LEN, device="cpu")
    tops.write_slot(tb, tc, 0)
    tb["pos"] = torch.as_tensor([int(tc["pos"]), MAX_LEN + 5, MAX_LEN - 3], dtype=torch.int32)
    for step in range(3):
        tok = [[11 + step], [0], [42]]
        jlog, jb = jax_decode_step(jcfg, jparams, jnp.asarray(tok), jb)
        tlog, tb = decode_step_slab(tcfg, tparams, torch.as_tensor(tok), tb)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL, rtol=TOL)
    _assert_cache_close(tb, jb)
    cand = [[3, 4, 5, 6, 7], [0, 0, 0, 0, 0], [8, 9, 10, 0, 0]]
    jlog, jb, _ = jax_verify_chunk(jcfg, jparams, {"tokens": jnp.asarray(cand)}, jb)
    tlog, tb = verify_chunk_slab(tcfg, tparams, torch.as_tensor(cand), tb)
    np.testing.assert_allclose(tlog.numpy()[[0, 2]], np.asarray(jlog)[[0, 2]],
                               atol=TOL, rtol=TOL)
    _assert_cache_close(tb, jb)
    assert k5.dense_launches == k2.launches == k4.launches == 0


# ------------------------------------------------------ slab engine --------


def _run_pair(weights, prompts, *, max_new=4, shared=0, **kw):
    """The same requests through the JAX engine and the port's, slab layout."""
    jcfg, jparams, tcfg, tparams, _ = weights
    base = dict(slots=2, max_len=MAX_LEN, prefix_min_len=4, page_size=8, chunk_size=5,
                kv_layout="slab")
    base.update(kw)
    out = []
    for Eng, Req, cfg, params, dev in ((JaxEngine, JaxRequest, jcfg, jparams, {}),
                                       (ServingEngine, Request, tcfg, tparams,
                                        {"device": "cpu"})):
        eng = Eng(cfg, params, **base, **dev)
        for i, p in enumerate(prompts):
            eng.submit(Req(rid=i, prompt=p, max_new=max_new, eos_id=-1, shared_len=shared))
        done = eng.run()
        out.append((eng, {i: done[i].out for i in range(len(prompts)) if i in done}))
    (je, jo), (te, to) = out
    assert to == jo
    assert dict(te.stats) == dict(je.stats)
    return out


@pytest.mark.parametrize("pc", [False, True])
def test_slab_engine_matches_reference(weights, pc):
    """The dense case of `tests/test_paged_kv.py`'s layout parity: three
    requests sharing a 12-token template, prefix cache off and on; tokens
    equal the paged layout's, and with the cache on the suffixes decode
    token by token after an expanded snapshot."""
    prompts = [SHARED + [10 + i, 20 + i, 30 + i] for i in range(3)]
    (je, jo), (te, to) = _run_pair(weights, prompts, shared=len(SHARED), prefix_cache=pc)
    paged = ServingEngine(weights[2], weights[3], slots=2, max_len=MAX_LEN, page_size=8,
                          chunk_size=5, device="cpu")
    for i, p in enumerate(prompts):
        paged.submit(Request(rid=i, prompt=p, max_new=4, eos_id=-1))
    assert {i: r.out for i, r in paged.run().items()} == to
    assert te.stats["kv_bytes_peak"] > 0
    if pc:
        assert te.stats["prefix_hits"] == 2 and te.stats["prefix_inserts"] == 1
        assert te.prefix_cache.nbytes == je.prefix_cache.nbytes
    assert te.estimate_pages(20, 4) == je.estimate_pages(20, 4) == 0


def test_slab_prompt_lookup_matches_reference(weights):
    """Slab + prompt lookup (`tests/test_spec_decode.py`): verify rounds on
    the slab with rollback by position reset, identical to speculation off."""
    prompts = [[7, 3, 9, 4, 2, 8, 1, 6, 5, 10 + i] for i in range(3)]
    _, (_, off) = _run_pair(weights, prompts, max_new=8)
    _, (te, on) = _run_pair(weights, prompts, max_new=8, spec_decode="prompt_lookup")
    assert on == off
    assert te.stats["spec_rounds"] == te.stats["decode_steps"] > 0


def test_slab_verify_near_max_len(weights):
    """A verify chunk whose padded tail crosses max_len drops the writes
    past the bound instead of clamping them over the prompt's K/V."""
    prompt = list(range(1, 62))                       # 61 tokens, max_len 64
    _, (_, off) = _run_pair(weights, [prompt], max_new=8)
    _, (te, on) = _run_pair(weights, [prompt], max_new=8, spec_decode="prompt_lookup")
    assert on == off and te.stats["spec_rounds"] > 0


def test_slab_prefill_buckets(weights):
    """Prompt lengths inside one chunk_size bucket share one prefill length
    (the JAX engine's one jit signature), and padding never changes the
    output."""
    prompts = [list(range(1, n + 1)) for n in (9, 12, 15)]
    outs = {}
    for cs in (16, 1):
        (je, jo), (te, to) = _run_pair(weights, prompts, chunk_size=cs)
        assert len(te._prefill_buckets) == len(je._prefill_cache)
        outs[cs] = to
    assert outs[16] == outs[1]


def test_slab_free_slot_runs_past_max_len(weights):
    """A slot that finished near the bound keeps stepping while the other
    decodes: its position passes max_len, its writes are dropped and its
    K5 walk is bounded by max_len; then a new request reuses the slot, and
    a drained slot is reinserted from its prompt."""
    prompts = [list(range(1, 59)), [7, 3, 9, 4, 2, 8, 1, 6, 5, 10]]
    (je, jo), (te, to) = _run_pair(weights, prompts, max_new=30)
    assert int(te._pos_h.max()) > MAX_LEN
    assert te.cache["pos"].tolist() == np.asarray(je.cache["pos"]).tolist()
    for eng, Req in ((je, JaxRequest), (te, Request)):
        eng.submit(Req(rid=9, prompt=[5, 6, 7, 8], max_new=6, eos_id=-1))
        eng.step()
        eng.drain_slot(next(iter(eng.active)))
        eng.run()
    assert te.finished[9].out == je.finished[9].out
    assert dict(te.stats) == dict(je.stats) and te.stats["evictions"] == 1
