"""The port's dense model on the page pool against the JAX model on its
dense cache: bridged SMOKE qwen2.5-3b parameters, chunked prefill and
decode logits teacher-forced, then greedy decoding token for token."""
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.data import lm_data  # noqa: E402
from repro.models import decode_step, init_decode_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import prefill_chunk as jax_prefill_chunk  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import init_params, prefill_chunk  # noqa: E402
from repro_torch.models import decode_step as torch_decode_step  # noqa: E402
from repro_torch.models.cache_ops import PAGE_SINK, PageAllocator  # noqa: E402

TOL = 2e-5
jax_decode_step = jax.jit(decode_step, static_argnums=0)
MAX_LEN, PS, CHUNK = 128, 8, 16


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config("qwen2.5-3b").replace(vocab_size=lm_data.VOCAB)
    tcfg = get_smoke_config("qwen2.5-3b").replace(vocab_size=lm_data.VOCAB)
    assert jcfg == jcfg.replace(**tcfg.__dict__)       # field-for-field
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    # non-zero QKV biases, so the bias path is exercised
    rng = np.random.default_rng(0)
    for name in ("bq", "bk", "bv"):
        b = tree["layers"]["attn"][name]
        tree["layers"]["attn"][name] = (rng.standard_normal(b.shape) * 0.1).astype(b.dtype)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_numpy(tcfg, tree, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _pool(tcfg, rng):
    alloc = PageAllocator(tcfg, MAX_LEN // PS + 2, PS, device="cpu")
    pages = alloc.alloc(MAX_LEN // PS)
    rng.shuffle(pages)                                   # scattered pages
    return alloc.pools, torch.as_tensor(np.asarray(pages, np.int32))


def _prefill(jcfg, jparams, tcfg, tparams, prompt, pools, ctx):
    """Chunk-prefill `prompt` on both sides; returns the JAX cache and the
    per-chunk (jax, torch) last-position logits."""
    cache = init_decode_cache(jcfg, 1, MAX_LEN)
    pos, pairs = 0, []
    for i in range(0, len(prompt), CHUNK):
        real = prompt[i:i + CHUNK]
        chunk = real + [0] * (CHUNK - len(real))
        jl, cache = jax_prefill_chunk(jcfg, jparams, {"tokens": jnp.asarray([chunk])},
                                      cache, length=jnp.asarray(len(real)))
        tl = prefill_chunk(tcfg, tparams, torch.as_tensor([chunk]), pos, len(real),
                           pools, ctx)
        pairs.append((np.asarray(jl), tl.numpy()))
        pos += len(real)
    return cache, pos, pairs


def test_init_params_matches_jax_layout(models):
    jcfg, jparams, tcfg, tparams = models
    mine = init_params(tcfg, torch.Generator().manual_seed(1), device="cpu")
    assert mine.keys() == tparams.keys()
    assert len(mine["layers"]) == tcfg.num_layers
    for a, b in zip(jax.tree.leaves(mine["layers"][0]),
                    jax.tree.leaves(tparams["layers"][0])):
        assert a.shape == b.shape and a.dtype == b.dtype
    w = mine["layers"][0]["attn"]["wq"]
    assert abs(float(w.std()) - 0.02) < 0.004


def test_prefill_and_decode_logits_teacher_forced(models):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(1)
    pools, ctx = _pool(tcfg, rng)
    prompt = [int(t) for t in rng.integers(0, 256, size=41)]
    cache, pos, pairs = _prefill(jcfg, jparams, tcfg, tparams, prompt, pools, ctx)
    assert len(pairs) == 3
    for jl, tl in pairs:
        np.testing.assert_allclose(tl, jl, atol=TOL, rtol=TOL)
    # teacher-forced decode; row 1 of the port's batch is a dead slot whose
    # position runs past its all-sink table
    table = torch.stack([ctx, torch.full_like(ctx, PAGE_SINK)])
    dead_pos = 3 * MAX_LEN
    for t in [int(x) for x in rng.integers(0, 256, size=12)]:
        jl, cache = jax_decode_step(jcfg, jparams, jnp.asarray([[t]]), cache)
        p = torch.as_tensor([pos, dead_pos], dtype=torch.int32)
        wp = torch.stack([ctx[pos // PS], torch.tensor(PAGE_SINK, dtype=torch.int32)])
        tl = torch_decode_step(tcfg, tparams, torch.as_tensor([[t], [0]]), p, pools, table, wp)
        np.testing.assert_allclose(tl[:1].numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
        assert torch.isfinite(tl[1]).all()
        pos += 1
        dead_pos += 1


def test_greedy_tokens_identical(models):
    """Greedy decoding after a chunked prefill: 40 steps, every token equal."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(2)
    pools, ctx = _pool(tcfg, rng)
    prompt = list(lm_data.encode("Task: report the court. Evidence: heard at "))
    cache, pos, pairs = _prefill(jcfg, jparams, tcfg, tparams, prompt, pools, ctx)
    jtok = ttok = int(np.argmax(pairs[-1][0][0, -1]))
    assert ttok == int(np.argmax(pairs[-1][1][0, -1]))
    jout, tout = [], []
    for _ in range(40):
        jl, cache = jax_decode_step(jcfg, jparams, jnp.asarray([[jtok]]), cache)
        tl = torch_decode_step(tcfg, tparams, torch.as_tensor([[ttok]]),
                         torch.as_tensor([pos], dtype=torch.int32), pools,
                         ctx[None], ctx[pos // PS].reshape(1))
        jtok, ttok = int(jnp.argmax(jl[0, -1])), int(torch.argmax(tl[0, -1]))
        jout.append(jtok)
        tout.append(ttok)
        pos += 1
    assert tout == jout
