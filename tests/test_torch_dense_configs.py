"""The three other dense configs on the port against the JAX package, at
SMOKE size with bridged parameters: qwen3-32b (qk-norm, with random norm
weights so the branch is seen), nemotron-4-15b (ungated squared-ReLU MLP)
and deepseek-67b (plain GQA, three SMOKE layers). The model on the page
pool -- parameter layout, teacher-forced chunk-prefill and decode logits,
40 greedy tokens -- and the engine in both KV layouts with the prefix
cache and prompt lookup, whose tokens and every `stats` counter must
equal the JAX engine's."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.data import lm_data  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import init_params, param_count  # noqa: E402
from repro_torch.models import decode_step as torch_decode_step  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from test_torch_model import PS, TOL, _pool, _prefill, jax_decode_step  # noqa: E402

ARCHS = ["qwen3-32b", "nemotron-4-15b", "deepseek-67b"]
SHARED = [7, 3, 9, 4, 2, 8, 1, 6, 5, 7, 3, 2]      # tests/test_paged_kv.py


def _weights(arch):
    jcfg = jax_smoke_config(arch).replace(vocab_size=lm_data.VOCAB)
    tcfg = get_smoke_config(arch).replace(vocab_size=lm_data.VOCAB)
    assert jcfg == jcfg.replace(**tcfg.__dict__)       # field-for-field
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    if jcfg.qk_norm:          # ones would hide a norm applied to the wrong axis
        rng = np.random.default_rng(0)
        for name in ("q_norm", "k_norm"):
            w = tree["layers"]["attn"][name]
            tree["layers"]["attn"][name] = (1 + 0.5 * rng.standard_normal(w.shape)
                                            ).astype(w.dtype)
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            params_from_numpy(tcfg, tree, device="cpu"))


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    return _weights(request.param)


def test_model_matches_reference(weights):
    """Layouts (and the full-width count on the meta device), every
    chunk's logits and 12 teacher-forced decode steps within 2e-5, then 40
    greedy tokens equal."""
    jcfg, jparams, tcfg, tparams = weights
    mine = init_params(tcfg, torch.Generator().manual_seed(1), device="cpu")
    assert mine.keys() == tparams.keys()
    assert len(mine["layers"]) == tcfg.num_layers
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(tparams)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert ("w_gate" in mine["layers"][0]["mlp"]) == tcfg.gated_mlp
    assert ("q_norm" in mine["layers"][0]["attn"]) == tcfg.qk_norm
    assert param_count(tparams) == sum(int(np.prod(a.shape))
                                       for a in jax.tree.leaves(jparams))
    full = get_config(tcfg.name)
    assert param_count(init_params(full, device="meta")) > 15e9

    rng = np.random.default_rng(1)
    pools, ctx = _pool(tcfg, rng)
    prompt = [int(t) for t in rng.integers(0, 256, size=41)]
    cache, pos, pairs = _prefill(jcfg, jparams, tcfg, tparams, prompt, pools, ctx)
    for jl, tl in pairs:
        np.testing.assert_allclose(tl, jl, atol=TOL, rtol=TOL)
    for t in [int(x) for x in rng.integers(0, 256, size=12)]:
        jl, cache = jax_decode_step(jcfg, jparams, jnp.asarray([[t]]), cache)
        tl = torch_decode_step(tcfg, tparams, torch.as_tensor([[t]]),
                               torch.as_tensor([pos], dtype=torch.int32), pools,
                               ctx[None], ctx[pos // PS].reshape(1))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
        pos += 1

    pools, ctx = _pool(tcfg, np.random.default_rng(2))
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


@pytest.mark.parametrize("layout", ["paged", "slab"])
def test_engine_matches_reference(weights, layout):
    """`tests/test_paged_kv.py`'s shared-prefix prompts with the prefix
    cache and prompt lookup (the served settings): tokens, every counter,
    the pool's reference counts and the prefix entries equal the JAX
    engine's."""
    jcfg, jparams, tcfg, tparams = weights
    prompts = [SHARED + [10 + i, 20 + i, 30 + i] for i in range(3)]
    kw = dict(slots=2, max_len=64, prefix_min_len=4, page_size=8, chunk_size=5,
              kv_layout=layout, prefix_cache=True, spec_decode="prompt_lookup")
    engines = []
    for Eng, Req, cfg, params, dev in ((JaxEngine, JaxRequest, jcfg, jparams, {}),
                                       (ServingEngine, Request, tcfg, tparams,
                                        {"device": "cpu"})):
        eng = Eng(cfg, params, **kw, **dev)
        for i, p in enumerate(prompts):
            eng.submit(Req(rid=i, prompt=p, max_new=8, eos_id=-1, shared_len=len(SHARED)))
        eng.run()
        engines.append(eng)
    je, te = engines
    assert {r: q.out for r, q in te.finished.items()} == \
        {r: q.out for r, q in je.finished.items()}
    assert dict(te.stats) == dict(je.stats)
    assert te.stats["prefix_hits"] == 2 and te.stats["spec_rounds"] > 0
    assert te.prefix_cache.stats.snapshot() == je.prefix_cache.stats.snapshot()
    if layout == "paged":
        assert te.alloc.refcount == je.alloc.refcount
