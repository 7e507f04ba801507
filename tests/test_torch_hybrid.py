"""zamba2-2.7b (the hybrid family: a Mamba2 trunk and two shared attention
blocks with a LoRA adapter per application) on the port against the JAX
package, at SMOKE size with bridged parameters.

Mamba2 one function at a time (the SSD matrix form with a carried state
and a padded last chunk, the sequential recurrence with every state, the
block's decode step, chunk with a true length and chunk with states), the
adapters with seeded non-zero b_* (`lora_init` zeros them, which would
hide a wrong delta), the model on the page pool and on the slab, and the
engine in both layouts with the prefix cache and prompt lookup, and with
scripted drafts rejected in part so that the Mamba2 state rolls back from
a checkpoint. Tokens and every counter must be identical, and the state
itself close: with random SMOKE weights a wrong state seldom changes a
token. States are held to F32_TOL of their largest value (the SMOKE
trunk's states are ~1e-4)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.data import lm_data  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_decode_cache as jax_init_decode_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models import prefill_chunk as jax_prefill_chunk  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import verify_chunk as jax_verify_chunk  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import (decode_step, decode_step_slab,  # noqa: E402
                                init_decode_cache, init_params, init_state_cache,
                                init_verify_ckpts, param_count, prefill,
                                prefill_chunk, verify_chunk, verify_chunk_slab)
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.cache_ops import PAGE_SINK, PageAllocator  # noqa: E402
from repro_torch.models.model import n_applications  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from test_torch_ssm_serving import Scripted  # noqa: E402

ARCH = "zamba2-2.7b"
F32_TOL = 2e-5        # float32 at SMOKE size; states relative to their largest value
MAX_LEN, PS, CHUNK = 64, 8, 16
SHARED = [7, 3, 9, 4, 2, 8, 1, 6, 5, 7, 3, 2]
PROMPTS = [SHARED + [10 + i, 20 + i, 30 + i] + list(range(40, 40 + 3 * i)) for i in range(5)]
MAX_NEW = [4 + 3 * i for i in range(5)]


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))         # a writable copy


def _close(got, want, tol=F32_TOL, msg=""):
    """Within tol of the reference, absolutely on tol x its largest value."""
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=tol * scale,
                               rtol=tol, err_msg=msg)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_config(ARCH).replace(vocab_size=lm_data.VOCAB)
    tcfg = get_smoke_config(ARCH).replace(vocab_size=lm_data.VOCAB)
    assert jcfg == jcfg.replace(**tcfg.__dict__)       # field-for-field
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for name, b in tree["lora"].items():        # non-zero deltas on q, k, v and out
        if name.startswith("b_"):
            tree["lora"][name] = _rand(rng, b.shape, 0.05)
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            params_from_numpy(tcfg, tree, device="cpu"), tree)


def _layer(weights, i=0):
    """Mamba2 layer i's parameters on both sides (JAX's cast to the model
    dtype as its model functions cast them)."""
    jcfg, jparams, _, tparams, _ = weights
    jp = jax.tree.map(lambda a: a[i].astype(jcfg.dtype), jparams["layers"]["mamba"])
    return jp, tparams["layers"][i]["mamba"]


def _ssd_inputs(rng, B, S, H, P, N):
    x = _rand(rng, (B, S, H, P), 0.5)
    dt = np.log1p(np.exp(_rand(rng, (B, S, H)) - 1.0)).astype(np.float32)
    A = -np.exp(_rand(rng, (H,), 0.3))
    return x, dt, A, _rand(rng, (B, S, N), 0.5), _rand(rng, (B, S, N), 0.5), \
        np.ones((H,), np.float32)


# ------------------------------------------------------ Mamba2 functions --


@pytest.mark.parametrize("S,chunk,with_h0", [(16, 8, False), (13, 8, True), (5, 8, True),
                                             (24, 6, True)])
def test_mamba2_ssd_matches_jax(S, chunk, with_h0):
    """The SSD matrix form: several chunks, a zero-padded last chunk (S not
    a multiple of chunk), a sequence shorter than one chunk, from a carried
    state or zeros: y and the final state."""
    rng = np.random.default_rng(S)
    args = _ssd_inputs(rng, 2, S, 3, 4, 5)
    h0 = _rand(rng, (2, 3, 4, 5), 0.5) if with_h0 else None
    jy, jh = jssm.mamba2_ssd_ref(*[jnp.asarray(a) for a in args], chunk=chunk,
                                 h0=None if h0 is None else jnp.asarray(h0))
    ty, th = tssm.mamba2_ssd(*[_t(a) for a in args], chunk=chunk,
                             h0=None if h0 is None else _t(h0))
    assert ty.shape == (2, S, 3, 4) and th.shape == (2, 3, 4, 5) and th.dtype == torch.float32
    _close(ty.numpy(), jy, msg="y")
    _close(th.numpy(), jh, msg="h")


def test_mamba2_scan_states_match_jax_and_the_ssd_form():
    """The sequential recurrence: y and the state after every position
    against JAX's; its last state against the SSD form's final state."""
    rng = np.random.default_rng(7)
    args = _ssd_inputs(rng, 2, 9, 3, 4, 5)
    h0 = _rand(rng, (2, 3, 4, 5), 0.5)
    jy, jhs = jssm.mamba2_scan_states(*[jnp.asarray(a) for a in args], h0=jnp.asarray(h0))
    ty, ths = tssm.mamba2_scan_states(*[_t(a) for a in args], h0=_t(h0))
    assert ths.shape == (2, 9, 3, 4, 5)
    _close(ty.numpy(), jy, msg="y")
    _close(ths.numpy(), jhs, msg="states")
    _, h = tssm.mamba2_ssd(*[_t(a) for a in args], chunk=4, h0=_t(h0))
    _close(ths[:, -1].numpy(), h.numpy(), tol=1e-4, msg="ssd final state")


def test_mamba2_block_functions_match_jax(weights):
    """`mamba2_decode`, `mamba2_chunk` (all real, and right-padded with a
    true length: the state kept past it, the conv tail cut at it) and
    `mamba2_chunk_states`, one SMOKE layer from a carried conv window and
    state; the verify states equal sequential decode's to 1e-6."""
    jcfg, _, tcfg, _, _ = weights
    jp, tp = _layer(weights, 1)
    rng = np.random.default_rng(4)
    d, K = jcfg.d_model, jcfg.ssm_conv
    cw = jcfg.d_inner + 2 * jcfg.ssm_state
    H, P, N = jcfg.n_ssm_heads, jcfg.mamba_headdim, jcfg.ssm_state
    conv, st = _rand(rng, (2, K - 1, cw)), _rand(rng, (2, H, P, N), 0.3)
    x1 = _rand(rng, (2, 1, d))
    jo, jconv, jst = jssm.mamba2_decode(jcfg, jp, jnp.asarray(x1), conv_state=jnp.asarray(conv),
                                        ssm_state=jnp.asarray(st))
    to, tconv, tst = tssm.mamba2_decode(tcfg, tp, _t(x1), conv_state=_t(conv), ssm_state=_t(st))
    for a, b, m in ((to, jo, "out"), (tconv, jconv, "conv"), (tst, jst, "ssm")):
        _close(a.numpy(), b, msg=m)
    x = _rand(rng, (2, 11, d))
    for length in (None, 7, 1):
        jo, jtail, jh = jssm.mamba2_chunk(jcfg, jp, jnp.asarray(x), conv_state=jnp.asarray(conv),
                                          ssm_state=jnp.asarray(st), length=length)
        to, ttail, th = tssm.mamba2_chunk(tcfg, tp, _t(x), conv_state=_t(conv),
                                          ssm_state=_t(st), length=length)
        n = 11 if length is None else length
        _close(to[:, :n].numpy(), np.asarray(jo)[:, :n], msg=f"out {length}")
        _close(ttail.numpy(), jtail, msg=f"tail {length}")
        _close(th.numpy(), jh, msg=f"state {length}")
    xv = x[:, :5]
    jo, jcat, jhs = jssm.mamba2_chunk_states(jcfg, jp, jnp.asarray(xv),
                                             conv_state=jnp.asarray(conv),
                                             ssm_state=jnp.asarray(st))
    to, tcat, ths = tssm.mamba2_chunk_states(tcfg, tp, _t(xv), conv_state=_t(conv),
                                             ssm_state=_t(st))
    for a, b, m in ((to, jo, "out"), (tcat, jcat, "conv history"), (ths, jhs, "states")):
        _close(a.numpy(), b, msg=m)
    # the rollback contract: j decode steps give checkpoint j (the same
    # step arithmetic; only the projections' products see other shapes)
    c, s = _t(conv), _t(st)
    for j in range(5):
        _, c, s = tssm.mamba2_decode(tcfg, tp, _t(xv[:, j:j + 1]), conv_state=c, ssm_state=s)
        _close(s.numpy(), ths[:, j].numpy(), 1e-6, msg=f"state {j}")
        _close(c.numpy(), tcat[:, j + 1:j + K].numpy(), 1e-6, msg=f"conv {j}")


# ------------------------------------------------------------- the model --


def test_params_match_jax_layout_and_published_count(weights):
    """54 Mamba2 layers, 2 shared blocks and 9 adapters at full width
    (2,551,125,920 parameters on the meta device); at SMOKE size the init's
    names and shapes are the JAX tree's and the bridge carries every leaf;
    caches and checkpoints are shaped as the JAX engine's."""
    jcfg, _, tcfg, tparams, tree = weights
    full = get_config(ARCH)
    meta = init_params(full, device="meta")
    assert (len(meta["layers"]), len(meta["shared_blocks"]), len(meta["lora"])) == (54, 2, 9)
    assert param_count(meta) == 2_551_125_920
    mine = init_params(tcfg, torch.Generator().manual_seed(1), device="cpu")
    assert mine.keys() == tparams.keys() == tree.keys()
    assert len(mine["lora"]) == n_applications(tcfg) == 2
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(tparams)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert not any(bool(b.any()) for lo in mine["lora"] for k, b in lo.items() if k[0] == "b")
    assert param_count(tparams) == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))
    want = jax.tree.map(np.shape, dict(jax_init_decode_cache(jcfg, 3, MAX_LEN)))
    assert {k: tuple(v.shape) for k, v in init_decode_cache(tcfg, 3, MAX_LEN,
                                                            device="cpu").items()} == want
    assert {k: tuple(v.shape) for k, v in init_state_cache(tcfg, 3, device="cpu").items()} == \
        {k: want[k] for k in ("conv", "ssm")}
    ck = init_verify_ckpts(tcfg, 3, 5, device="cpu")
    assert ck["ssm"].shape == (4, 3, 5) + want["ssm"][2:]
    assert ck["conv"].shape == (4, 3, 3 + 5, want["conv"][3])


def _paged(tcfg):
    alloc = PageAllocator(tcfg, MAX_LEN // PS + 2, PS, device="cpu")
    pages = alloc.alloc(MAX_LEN // PS)
    np.random.default_rng(0).shuffle(pages)
    return alloc.pools, torch.as_tensor(np.asarray(pages, np.int32))


def test_paged_model_matches_reference(weights):
    """Chunked prefill, decode steps (beside a dead row whose table is all
    sink) and a verify round on the page pool with the per-slot state,
    against the JAX model on its dense cache: logits, the Mamba2 state and
    the verify checkpoints."""
    jcfg, jparams, tcfg, tparams, _ = weights
    rng = np.random.default_rng(1)
    pools, ctx = _paged(tcfg)
    assert pools["k"].shape[0] == n_applications(tcfg)
    state = init_state_cache(tcfg, 1, device="cpu")
    cache = jax_init_decode_cache(jcfg, 1, MAX_LEN)
    prompt = [int(t) for t in rng.integers(0, 256, size=37)]
    pos = 0
    for i in range(0, len(prompt), CHUNK):
        real = prompt[i:i + CHUNK]
        chunk = real + [0] * (CHUNK - len(real))
        jl, cache = jax_prefill_chunk(jcfg, jparams, {"tokens": jnp.asarray([chunk])}, cache,
                                      length=jnp.asarray(len(real)))
        tl = prefill_chunk(tcfg, tparams, torch.as_tensor([chunk]), pos, len(real), pools,
                           ctx, state=state)
        _close(tl.numpy(), jl, msg=f"chunk {i}")
        pos += len(real)
    for k in ("conv", "ssm"):
        _close(state[k].numpy(), cache[k], msg=k)
    # decode: row 1 is a dead slot (all-sink table, its own state)
    state2 = {k: torch.cat([a, torch.zeros_like(a)], dim=1) for k, a in state.items()}
    table = torch.stack([ctx, torch.full_like(ctx, PAGE_SINK)])
    for t in [int(x) for x in rng.integers(0, 256, size=4)]:
        jl, cache = jax_decode_step(jcfg, jparams, jnp.asarray([[t]]), cache)
        wp = torch.stack([ctx[pos // PS], torch.tensor(PAGE_SINK, dtype=torch.int32)])
        tl = decode_step(tcfg, tparams, torch.as_tensor([[t], [0]]),
                         torch.as_tensor([pos, 5], dtype=torch.int32), pools, table, wp,
                         state=state2)
        _close(tl[:1].numpy(), jl, msg="decode")
        pos += 1
    for k in ("conv", "ssm"):
        _close(state2[k][:, :1].numpy(), cache[k], msg=k)
    C = 5
    state = {k: a[:, :1].clone() for k, a in state2.items()}
    toks = rng.integers(0, 256, size=(1, C))
    cache["pos"] = jnp.asarray([pos], jnp.int32)
    jl, jcache, jck = jax_verify_chunk(jcfg, jparams, {"tokens": jnp.asarray(toks)}, cache)
    ck = init_verify_ckpts(tcfg, 1, C, device="cpu")
    cpos = torch.as_tensor(pos + np.arange(C))
    tl = verify_chunk(tcfg, tparams, torch.as_tensor(toks),
                      torch.as_tensor([pos], dtype=torch.int32), pools, ctx[None],
                      ctx[cpos // PS][None], (cpos % PS)[None], state=state, ckpts=ck)
    _close(tl.numpy(), jl, msg="verify")
    for k in ("conv", "ssm"):
        _close(ck[k].numpy(), jck[k], msg=f"ckpt {k}")
        _close(state[k].numpy(), jcache[k], msg=f"state after verify {k}")


def test_slab_model_matches_reference(weights):
    """A bucketed whole-prompt prefill (SSD from the zero state), a slab
    decode step and a slab verify round: logits, K/V and the state."""
    jcfg, jparams, tcfg, tparams, _ = weights
    rng = np.random.default_rng(2)
    prompt = [int(t) for t in rng.integers(0, 256, size=19)]
    toks = prompt + [0] * 5
    jl, jc = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray([toks])}, MAX_LEN,
                         length=jnp.asarray(len(prompt)))
    tl, tc = prefill(tcfg, tparams, torch.as_tensor([toks]), MAX_LEN, length=len(prompt))
    _close(tl.numpy(), jl, msg="prefill")
    for k in ("k", "v", "conv", "ssm"):
        _close(tc[k].numpy(), jc[k], msg=f"prefill {k}")
    t = int(rng.integers(0, 256))
    jl, jc = jax_decode_step(jcfg, jparams, jnp.asarray([[t]]), jc)
    tl, tc = decode_step_slab(tcfg, tparams, torch.as_tensor([[t]]), tc)
    _close(tl.numpy(), jl, msg="decode")
    jc["pos"] = jnp.asarray([int(jc["pos"])], jnp.int32)
    tc["pos"] = tc["pos"].reshape(1)
    vt = rng.integers(0, 256, size=(1, 5))
    jl, jc, jck = jax_verify_chunk(jcfg, jparams, {"tokens": jnp.asarray(vt)}, jc)
    ck = init_verify_ckpts(tcfg, 1, 5, device="cpu")
    tl, tc = verify_chunk_slab(tcfg, tparams, torch.as_tensor(vt), tc, ckpts=ck)
    _close(tl.numpy(), jl, msg="verify")
    for k in ("k", "v", "conv", "ssm"):
        _close(tc[k].numpy(), jc[k], msg=f"verify {k}")
    for k in ("conv", "ssm"):
        _close(ck[k].numpy(), jck[k], msg=f"ckpt {k}")


# ------------------------------------------------------------ the engine --


def _pair(weights, jax_kw=None, port_kw=None, **kw):
    """The same staggered requests (five on four slots) through the JAX
    engine and the port's: tokens, every counter, the prefix entries, the
    per-slot state and (paged) the pools with the sink page must agree."""
    jcfg, jparams, tcfg, tparams, _ = weights
    engines = []
    for Eng, Req, cfg, params, extra in ((JaxEngine, JaxRequest, jcfg, jparams, jax_kw or {}),
                                         (ServingEngine, Request, tcfg, tparams,
                                          {"device": "cpu", **(port_kw or {})})):
        eng = Eng(cfg, params, slots=4, max_len=MAX_LEN, prefix_min_len=4, chunk_size=5,
                  **kw, **extra)
        for i, p in enumerate(PROMPTS):
            eng.submit(Req(rid=i, prompt=p, max_new=MAX_NEW[i], eos_id=-1,
                           shared_len=len(SHARED)))
        eng.run()
        engines.append(eng)
    je, te = engines
    assert {r: q.out for r, q in te.finished.items()} == \
        {r: q.out for r, q in je.finished.items()}
    assert len(te.finished) == len(PROMPTS)
    assert dict(te.stats) == dict(je.stats)
    for k in ("conv", "ssm"):
        _close(te.cache[k].numpy(), je.cache[k], msg=k)
    if te.prefix_cache is not None:
        assert te.prefix_cache.stats.snapshot() == je.prefix_cache.stats.snapshot()
        assert te.prefix_cache.nbytes == je.prefix_cache.nbytes > 0
    if te.paged:
        assert te.alloc.refcount == je.alloc.refcount
        n = je.alloc.num_pages
        for k in ("k", "v"):
            assert te.alloc.pools[k].shape[0] == n_applications(te.cfg)
            np.testing.assert_allclose(te.alloc.pools[k][:, :n].numpy(),
                                       np.asarray(je.alloc.pools[k]), atol=1e-5, rtol=1e-5,
                                       err_msg=k)
    return je, te


@pytest.mark.parametrize("layout,ps", [("paged", 8), ("paged", 32), ("slab", 8)])
def test_engine_prompt_lookup_and_prefix_cache_match_reference(weights, layout, ps):
    """Prompt lookup and the prefix cache (entries carry the exact Mamba2
    state beside their pages), at page sizes 8 and 32 (32: the whole
    prompt and the CoW tail in one page) and on the slab."""
    _, te = _pair(weights, kv_layout=layout, page_size=ps, prefix_cache=True,
                  spec_decode="prompt_lookup")
    assert te.stats["prefix_hits"] > 0 and te.stats["spec_rounds"] > 0


@pytest.mark.parametrize("layout", ["paged", "slab"])
def test_engine_rolls_rejected_drafts_back(weights, layout):
    """Scripted drafts of which the first two of four are the greedy
    continuation: each verify round rolls the Mamba2 state back to a
    checkpoint past its first position (and the pages back on the pool);
    the state after the run equals the JAX engine's."""
    jcfg, jparams, *_ = weights
    ref = JaxEngine(jcfg, jparams, slots=4, max_len=MAX_LEN, chunk_size=5)
    for i, p in enumerate(PROMPTS):
        ref.submit(JaxRequest(rid=i, prompt=p, max_new=MAX_NEW[i], eos_id=-1))
    truth = {r: q.out for r, q in ref.run().items()}
    _, te = _pair(weights, jax_kw={"spec_decode": Scripted(truth, 2, lm_data.VOCAB)},
                  port_kw={"spec_decode": Scripted(truth, 2, lm_data.VOCAB)},
                  kv_layout=layout, page_size=PS, prefix_cache=True, spec_k=4)
    st = te.stats
    assert 0 < st["accepted_tokens"] < st["draft_tokens"] and st["prefix_hits"] > 0
    assert {r: q.out for r, q in te.finished.items()} == truth
