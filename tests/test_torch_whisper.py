"""whisper-medium (the encoder-decoder family: LayerNorm, an encoder over
the stub frontend's frames, a decoder with learned positions that
cross-attends the encoder's K/V) on the port against the JAX package, at
SMOKE size (2 + 2 layers, d 64, 4 heads, encoder_seq 16, max_position
256, float32) with bridged parameters.

Every LayerNorm's weight and bias is seeded away from (1, 0), so a norm
that drops its bias or reads another's shows. LayerNorm alone in float32
and bf16; the parameters' layout and the published count; the cross K/V
of `encode_cross_kv`; the logits of each path the engine runs -- chunks,
decode steps and verify rounds on the page pool, the slab `prefill` (the
encoder on every call), slab decode and verify; the three ways the JAX
model reads positions past `max_position` (a chunk's clip, a scalar
decode position's clamp, a per-row decode position's NaN); and the
engine in {slab, paged} x {prefix cache off, on} x {spec off, prompt
lookup}, whose tokens, every `stats` counter and every slot's cross K/V
must equal the JAX engine's."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.data import lm_data  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import encode_cross_kv as jax_encode_cross_kv  # noqa: E402
from repro.models import init_decode_cache as jax_init_decode_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models import prefill_chunk as jax_prefill_chunk  # noqa: E402
from repro.models import verify_chunk as jax_verify_chunk  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import decode_attention as k15  # noqa: E402
from repro_torch.kernels import flash_attention as k2  # noqa: E402
from repro_torch.models import (decode_step, decode_step_slab,  # noqa: E402
                                encode_cross_kv, init_params, init_state_cache,
                                param_count, prefill, prefill_chunk, verify_chunk,
                                verify_chunk_slab)
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.cache_ops import PageAllocator  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

ARCH = "whisper-medium"
F32_TOL = 2e-5
MAX_LEN, PS, CHUNK = 320, 8, 16      # the pool covers positions past max_position (256)
SHARED = [7, 3, 9, 4, 2, 8, 1, 6, 5, 7, 3, 2]      # tests/test_paged_kv.py
jax_decode = jax.jit(jax_decode_step, static_argnums=0)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))         # a writable copy


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_config(ARCH).replace(vocab_size=lm_data.VOCAB)
    tcfg = get_smoke_config(ARCH).replace(vocab_size=lm_data.VOCAB)
    assert jcfg == jcfg.replace(**tcfg.__dict__)       # field-for-field
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def seed_norms(t):
        for k, v in t.items():
            if isinstance(v, dict) and set(v) == {"w", "b"}:
                v["w"] = (1 + _rand(rng, v["w"].shape, 0.2)).astype(np.float32)
                v["b"] = _rand(rng, v["b"].shape, 0.1)
            elif isinstance(v, dict):
                seed_norms(v)
    seed_norms(tree)
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            params_from_numpy(tcfg, tree, device="cpu"), tree)


def _frames(cfg, seed):
    return _rand(np.random.default_rng(seed), (1, cfg.encoder_seq, cfg.d_model))


# ------------------------------------------------------------- layers ---


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    """float32 mean and variance, rsqrt, weight and bias in float32, the
    result cast back to the input's dtype."""
    rng = np.random.default_rng(1)
    x, w, b = _rand(rng, (3, 5, 64), 3.0), 1 + _rand(rng, (64,), 0.2), _rand(rng, (64,), 0.1)
    jx = jnp.asarray(x).astype(dtype)
    want = jlayers.layer_norm(jx, jnp.asarray(w), jnp.asarray(b), 1e-5)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = tlayers.layer_norm(tx, _t(w), _t(b), 1e-5)
    assert got.dtype == tx.dtype
    tol = F32_TOL if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_params_match_jax_layout_and_published_count(weights):
    """`init_params` draws every tensor of the JAX tree (the encoder and
    decoder stacks, cross_norm and cross_attn, LayerNorm biases, dec_pos,
    enc_final_norm) in its shape; the bridge carries them; the meta device
    counts the published model."""
    jcfg, jparams, tcfg, tparams, tree = weights
    mine = init_params(tcfg, torch.Generator().manual_seed(1), device="cpu")
    assert mine.keys() == tparams.keys() == tree.keys()
    assert len(tparams["enc_layers"]) == tcfg.n_encoder_layers
    assert len(tparams["dec_layers"]) == tcfg.num_layers
    assert set(tparams["dec_layers"][0]) == set(tree["dec_layers"])
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(tparams)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert tparams["dec_pos"].shape == (tcfg.max_position, tcfg.d_model)
    assert abs(float(mine["dec_pos"].std()) - 0.02) < 0.002
    assert float(mine["final_norm"]["b"].abs().max()) == 0.0
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jparams))
    assert param_count(tparams) == param_count(mine) == n
    np.testing.assert_array_equal(tparams["dec_layers"][1]["cross_norm"]["b"].numpy(),
                                  tree["dec_layers"]["cross_norm"]["b"][1])
    np.testing.assert_array_equal(tparams["enc_final_norm"]["b"].numpy(),
                                  tree["enc_final_norm"]["b"])
    assert param_count(init_params(get_config(ARCH), device="meta")) == 844_666_880


def test_encode_cross_kv_matches_jax(weights):
    jcfg, jparams, tcfg, tparams, _ = weights
    frames = _frames(tcfg, 2)
    jck, jcv = jax_encode_cross_kv(jcfg, jparams, jnp.asarray(frames))
    tck, tcv = encode_cross_kv(tcfg, tparams, _t(frames))
    assert tck.shape == (tcfg.num_layers, 1, tcfg.encoder_seq, tcfg.n_kv_heads,
                         tcfg.resolved_head_dim)
    np.testing.assert_allclose(tck.numpy(), np.asarray(jck), atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(tcv.numpy(), np.asarray(jcv), atol=F32_TOL, rtol=F32_TOL)
    assert k2.bidirectional_launches == 0        # a CPU tensor never reaches the kernel


# -------------------------------------------------------------- model ---


def _paged(tcfg, rng, B=1):
    """A page pool with B scattered page tables of MAX_LEN positions."""
    nb = MAX_LEN // PS
    alloc = PageAllocator(tcfg, B * nb + 2, PS, device="cpu")
    pages = alloc.alloc(B * nb)
    rng.shuffle(pages)
    return alloc.pools, torch.as_tensor(np.asarray(pages, np.int32).reshape(B, nb))


def _cross_state(weights, seed, B=1):
    """The cross K/V of seeded frames on both sides, B rows each: the JAX
    decode cache's "ck"/"cv" and the port's state."""
    jcfg, jparams, tcfg, tparams, _ = weights
    frames = np.concatenate([_frames(tcfg, seed + b) for b in range(B)])
    jck, jcv = jax_encode_cross_kv(jcfg, jparams, jnp.asarray(frames))
    tck, tcv = encode_cross_kv(tcfg, tparams, _t(frames))
    return (jck, jcv), {"ck": tck, "cv": tcv}


def test_paged_chunk_decode_and_verify_logits_match_jax(weights):
    """Chunk-prefill a prompt (a padded last chunk) on the page pool, 6
    teacher-forced decode steps, then a verify round of two rows at their
    own positions: every logit within F32_TOL of the JAX dense cache's."""
    jcfg, jparams, tcfg, tparams, _ = weights
    rng = np.random.default_rng(3)
    pools, tables = _paged(tcfg, rng, B=2)
    (jck, jcv), state = _cross_state(weights, 10, B=2)
    cache = jax_init_decode_cache(jcfg, 2, MAX_LEN)
    cache["ck"], cache["cv"] = jck, jcv
    prompt = [int(t) for t in rng.integers(0, 256, size=37)]
    pos = 0
    row0 = {k: v[:, :1] for k, v in state.items()}
    jrow = {**{k: v[:, :1] for k, v in cache.items() if k != "pos"},
            "pos": jnp.zeros((), jnp.int32)}
    for i in range(0, len(prompt), CHUNK):
        real = prompt[i:i + CHUNK]
        chunk = real + [0] * (CHUNK - len(real))
        jl, jrow = jax_prefill_chunk(jcfg, jparams, {"tokens": jnp.asarray([chunk])}, jrow,
                                     length=jnp.asarray(len(real)))
        tl = prefill_chunk(tcfg, tparams, torch.as_tensor([chunk]), pos, len(real), pools,
                           tables[0], state=row0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_TOL, rtol=F32_TOL)
        pos += len(real)
    for t in [int(x) for x in rng.integers(0, 256, size=6)]:
        jl, jrow = jax_decode(jcfg, jparams, jnp.asarray([[t]]), jrow)
        tl = decode_step(tcfg, tparams, torch.as_tensor([[t]]),
                         torch.as_tensor([pos], dtype=torch.int32), pools,
                         tables[:1], tables[0, pos // PS].reshape(1), state=row0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_TOL, rtol=F32_TOL)
        pos += 1
    # a verify round: row 0 continues the sequence, row 1 sits at 200 over
    # its own pages; the JAX cache carries row 0's K/V
    cache = {**cache, "k": cache["k"].at[:, :1].set(jrow["k"]),
             "v": cache["v"].at[:, :1].set(jrow["v"])}
    starts = np.asarray([pos, 200], np.int32)
    cache["pos"] = jnp.asarray(starts)
    toks = rng.integers(0, 256, size=(2, 5))
    jl, _, _ = jax_verify_chunk(jcfg, jparams, {"tokens": jnp.asarray(toks)}, cache)
    cpos = starts[:, None] + np.arange(5)[None]
    wp = tables.numpy()[np.arange(2)[:, None], cpos // PS]
    tl = verify_chunk(tcfg, tparams, torch.as_tensor(toks), torch.as_tensor(starts), pools,
                      tables, torch.as_tensor(wp), torch.as_tensor(cpos % PS), state=state)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_TOL, rtol=F32_TOL)


def test_slab_prefill_decode_and_verify_match_jax(weights):
    """The slab `prefill` with seeded frames (the encoder inside, its cross
    K/V written to the cache), then slab decode steps and a verify round at
    per-row positions: logits and the cache's cross K/V."""
    jcfg, jparams, tcfg, tparams, _ = weights
    frames = _frames(tcfg, 20)
    prompt = [int(t) for t in np.random.default_rng(5).integers(0, 256, size=19)]
    toks = prompt + [0] * 5
    jl, jc = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray([toks]),
                                         "frames": jnp.asarray(frames)},
                         64, length=jnp.asarray(len(prompt)))
    tl, tc = prefill(tcfg, tparams, torch.as_tensor([toks]), 64, length=len(prompt),
                     frames=_t(frames))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_TOL, rtol=F32_TOL)
    for key in ("ck", "cv"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), atol=F32_TOL,
                                   rtol=F32_TOL)
    assert int(tc["pos"]) == int(jc["pos"]) == len(prompt)
    for t in (5, 17, 33):
        jl, jc = jax_decode(jcfg, jparams, jnp.asarray([[t]]), jc)
        tl, tc = decode_step_slab(tcfg, tparams, torch.as_tensor([[t]]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_TOL, rtol=F32_TOL)
    jc["pos"] = jnp.asarray([int(jc["pos"])], jnp.int32)
    tc["pos"] = torch.as_tensor([int(tc["pos"])], dtype=torch.int32)
    cand = np.asarray([[9, 8, 7, 6, 5]])
    jl, jc, _ = jax_verify_chunk(jcfg, jparams, {"tokens": jnp.asarray(cand)}, jc)
    tl, tc = verify_chunk_slab(tcfg, tparams, torch.as_tensor(cand), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_TOL, rtol=F32_TOL)
    with pytest.raises(ValueError, match="frames"):
        prefill(tcfg, tparams, torch.as_tensor([toks]), 64)
    with pytest.raises(ValueError, match="position table"):
        prefill(tcfg, tparams, torch.zeros((1, 288), dtype=torch.int64), 320,
                frames=_t(frames))


def test_positions_past_max_position_match_jax(weights):
    """Past the 256-row position table the JAX model reads three ways: a
    chunk clips its positions, a scalar decode position clamps (the
    dynamic slice), a per-row decode position reads NaN (`jnp.take`'s
    fill). Each case's logits equal JAX's, NaN where JAX's are."""
    jcfg, jparams, tcfg, tparams, _ = weights
    P = tcfg.max_position
    rng = np.random.default_rng(7)
    (jck, jcv), state = _cross_state(weights, 30)
    pools, tables = _paged(tcfg, rng)
    # a chunk at [250, 266): positions past 255 read row 255
    cache = jax_init_decode_cache(jcfg, 1, MAX_LEN)
    cache["ck"], cache["cv"] = jck, jcv
    cache["pos"] = jnp.asarray(250, jnp.int32)
    chunk = [int(t) for t in rng.integers(0, 256, size=CHUNK)]
    jl, _ = jax_prefill_chunk(jcfg, jparams, {"tokens": jnp.asarray([chunk])}, cache,
                              length=jnp.asarray(CHUNK))
    tl = prefill_chunk(tcfg, tparams, torch.as_tensor([chunk]), 250, CHUNK, pools, tables[0],
                       state=state)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_TOL, rtol=F32_TOL)
    assert np.isfinite(tl.numpy()).all()
    # a scalar decode position (a B=1 slab sub-cache) at 300: row 255
    jl, jc = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray([chunk]),
                                         "frames": jnp.asarray(_frames(tcfg, 30))}, MAX_LEN)
    tl, tc = prefill(tcfg, tparams, torch.as_tensor([chunk]), MAX_LEN, frames=_t(
        _frames(tcfg, 30)))
    jc["pos"] = jnp.asarray(300, jnp.int32)
    tc["pos"] = torch.tensor(300, dtype=torch.int32)
    jl, jc = jax_decode(jcfg, jparams, jnp.asarray([[4]]), jc)
    tl, tc = decode_step_slab(tcfg, tparams, torch.as_tensor([[4]]), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_TOL, rtol=F32_TOL)
    assert np.isfinite(tl.numpy()).all()
    # per-row decode positions, one inside the table and one past it: the
    # second row's logits are NaN on both sides, the first row's equal
    for key in ("k", "v", "ck", "cv"):
        jc[key] = jnp.concatenate([jc[key], jc[key]], axis=1)
        tc[key] = torch.cat([tc[key], tc[key]], dim=1)
    jc["pos"] = jnp.asarray([40, P + 20], jnp.int32)
    tc["pos"] = torch.as_tensor([40, P + 20], dtype=torch.int32)
    jl, jc = jax_decode(jcfg, jparams, jnp.asarray([[4], [4]]), jc)
    tl, tc = decode_step_slab(tcfg, tparams, torch.as_tensor([[4], [4]]), tc)
    want = np.asarray(jl)
    assert np.isnan(want[1]).all() and np.isfinite(want[0]).all()
    np.testing.assert_allclose(tl.numpy(), want, atol=F32_TOL, rtol=F32_TOL)   # NaN == NaN
    # the same on the page pool: the engine's decode step passes per-row positions
    pools, tables = _paged(tcfg, rng, B=2)
    pos = torch.as_tensor([40, P + 20], dtype=torch.int32)
    two = {k: torch.cat([v, v], dim=1) for k, v in state.items()}
    tl = decode_step(tcfg, tparams, torch.as_tensor([[4], [4]]), pos, pools, tables,
                     tables[torch.arange(2), pos.long() // PS], state=two)
    assert np.isnan(tl[1].numpy()).all() and np.isfinite(tl[0].numpy()).all()


# ------------------------------------------------------------- engine ---


def _run_pair(weights, prompts, *, shared=0, max_new=4, **kw):
    """The same requests through the JAX engine and the port's (slots=2,
    max_len=64, chunk_size=5, as `tests/test_paged_kv.py`'s layout parity):
    tokens, every counter and every slot's cross K/V must be equal."""
    jcfg, jparams, tcfg, tparams, _ = weights
    base = dict(slots=2, max_len=64, prefix_min_len=4, chunk_size=5)
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
    assert to == jo and len(to) == len(prompts)
    assert dict(te.stats) == dict(je.stats)
    assert te._extra == je._extra == 0               # the frames take no position
    for key in ("ck", "cv"):
        np.testing.assert_allclose(te.cache[key].numpy(), np.asarray(je.cache[key]),
                                   atol=F32_TOL, rtol=F32_TOL)
    return out


@pytest.mark.parametrize("spec", ["off", "prompt_lookup"])
@pytest.mark.parametrize("pc", [False, True])
@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_engine_matches_reference(weights, layout, pc, spec):
    """`tests/test_paged_kv.py`'s shared-prefix prompts (`tests/
    test_spec_decode.py`'s with prompt lookup): the cross K/V in every
    slot, whole in every prefix entry (so the entries' byte sizes and
    kv_bytes_peak count it, as the JAX engine's)."""
    prompts = [SHARED + [10 + i, 20 + i, 30 + i] for i in range(3)]
    (je, jo), (te, to) = _run_pair(weights, prompts, shared=len(SHARED), prefix_cache=pc,
                                   kv_layout=layout, page_size=8, spec_decode=spec)
    tcfg = weights[2]
    ckv = 2 * tcfg.num_layers * tcfg.encoder_seq * tcfg.n_kv_heads * tcfg.resolved_head_dim * 4
    assert te.stats["kv_bytes_peak"] >= 2 * ckv      # both slots' cross K/V
    if pc:
        assert te.stats["prefix_hits"] == 2 and te.stats["prefix_inserts"] == 1
        (entry,) = te.prefix_cache._entries.values()
        (jentry,) = je.prefix_cache._entries.values()
        assert entry.nbytes == jentry.nbytes >= ckv
        np.testing.assert_allclose(entry.cache["ck"].numpy(), np.asarray(jentry.cache["ck"]),
                                   atol=F32_TOL, rtol=F32_TOL)
    if layout == "paged":
        assert te.alloc.refcount == je.alloc.refcount
        assert set(te.alloc.pools) == {"k", "v"}     # the cross K/V is not pooled


def test_state_cache_holds_the_cross_kv(weights):
    """The per-slot state of the encdec family is its cross K/V, zeros
    until a request's insert writes the frames' encoding; the engine
    encodes the frames once and every request's state shares it."""
    _, _, tcfg, tparams, _ = weights
    st = init_state_cache(tcfg, 3, device="cpu")
    assert set(st) == {"ck", "cv"} and st["ck"].shape == (
        tcfg.num_layers, 3, tcfg.encoder_seq, tcfg.n_kv_heads, tcfg.resolved_head_dim)
    eng = ServingEngine(tcfg, tparams, slots=2, max_len=64, device="cpu")
    a, b = eng._init_state_sub(), eng._init_state_sub()
    assert a["ck"] is b["ck"] and a["ck"].shape[1] == 1
    ck, _ = encode_cross_kv(tcfg, tparams, torch.zeros((1, tcfg.encoder_seq, tcfg.d_model)))
    np.testing.assert_array_equal(a["ck"].numpy(), ck.numpy())
    assert k15.dense_launches == k2.bidirectional_launches == 0
