"""The image-prefix (vlm) family on the port against the JAX package:
bridged SMOKE llava-next-mistral-7b parameters ("mm_proj" included),
chunked prefill with seeded non-zero image embeddings on the first chunk
and teacher-forced decode on the page pool, the slab `prefill` with the
same images, greedy decoding token for token; then the engine in {slab,
paged} x {prefix cache off, on}, with and without prompt lookup, whose
tokens and every `stats` counter must equal the JAX engine's, the slab
bucket near the cache bound, `estimate_pages`, and the draft-model
drafter's refusal of a vlm model. Zero image embeddings would make the
whole image prefix zeros through every layer, so the model tests use
random ones."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.data import lm_data  # noqa: E402
from repro.models import decode_step, init_decode_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models import prefill_chunk as jax_prefill_chunk  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.spec_decode import DraftModelDrafter as JaxDrafter  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import (decode_step_slab, init_params,  # noqa: E402
                                param_count, prefill, prefill_chunk)
from repro_torch.models import decode_step as torch_decode_step  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.cache_ops import PageAllocator  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.spec_decode import DraftModelDrafter  # noqa: E402

ARCH = "llava-next-mistral-7b"
TOL = 2e-5
jax_decode_step = jax.jit(decode_step, static_argnums=0)
MAX_LEN, PS, CHUNK = 128, 8, 16
SHARED = [7, 3, 9, 4, 2, 8, 1, 6, 5, 7, 3, 2]      # tests/test_paged_kv.py


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config(ARCH).replace(vocab_size=lm_data.VOCAB)
    tcfg = get_smoke_config(ARCH).replace(vocab_size=lm_data.VOCAB)
    assert jcfg == jcfg.replace(**tcfg.__dict__)       # field-for-field
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _images(cfg, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((1, cfg.n_image_tokens, jmodel.VISION_DIM)).astype(np.float32)


def test_init_params_matches_jax_layout(models):
    jcfg, jparams, tcfg, tparams = models
    assert tmodel.VISION_DIM == jmodel.VISION_DIM
    mine = init_params(tcfg, torch.Generator().manual_seed(1), device="cpu")
    assert mine.keys() == tparams.keys() and "mm_proj" in mine
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(tparams)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert mine["mm_proj"]["w1"].shape == (tmodel.VISION_DIM, tcfg.d_model)
    assert mine["mm_proj"]["w2"].shape == (tcfg.d_model, tcfg.d_model)
    assert abs(float(mine["mm_proj"]["w1"].std()) - 0.02) < 0.002
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jparams))
    assert param_count(tparams) == param_count(mine) == n
    meta = init_params(tcfg, device="meta")
    assert param_count(meta) == n
    np.testing.assert_array_equal(tparams["mm_proj"]["w2"].numpy(),
                                  np.asarray(jparams["mm_proj"]["w2"]))


def _pool(tcfg, rng):
    alloc = PageAllocator(tcfg, MAX_LEN // PS + 2, PS, device="cpu")
    pages = alloc.alloc(MAX_LEN // PS)
    rng.shuffle(pages)                                   # scattered pages
    return alloc.pools, torch.as_tensor(np.asarray(pages, np.int32))


def _prefill(models, prompt, images, pools, ctx):
    """Chunk-prefill `prompt` on both sides, the images on the first chunk;
    returns the JAX cache, the position and the per-chunk (jax, torch)
    last-position logits."""
    jcfg, jparams, tcfg, tparams = models
    cache = init_decode_cache(jcfg, 1, MAX_LEN)
    pos, pairs = 0, []
    for i in range(0, len(prompt), CHUNK):
        real = prompt[i:i + CHUNK]
        chunk = real + [0] * (CHUNK - len(real))
        batch = {"tokens": jnp.asarray([chunk])}
        img = None
        if i == 0:
            batch["image_embeds"] = jnp.asarray(images)
            img = torch.from_numpy(images)
        jl, cache = jax_prefill_chunk(jcfg, jparams, batch, cache,
                                      length=jnp.asarray(len(real)))
        tl = prefill_chunk(tcfg, tparams, torch.as_tensor([chunk]), pos, len(real),
                           pools, ctx, image_embeds=img)
        pairs.append((np.asarray(jl), tl.numpy()))
        pos += len(real) + (images.shape[1] if i == 0 else 0)
    assert pos == int(cache["pos"])
    return cache, pos, pairs


def test_prefill_and_decode_logits_teacher_forced(models):
    """Non-zero seeded images on the first chunk: every chunk's logits and
    12 teacher-forced decode steps within 2e-5; the port's logits move when
    the images do, so the projector is on the path."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(1)
    pools, ctx = _pool(tcfg, rng)
    images = _images(tcfg, 11)
    prompt = [int(t) for t in rng.integers(0, 256, size=41)]
    cache, pos, pairs = _prefill(models, prompt, images, pools, ctx)
    assert len(pairs) == 3 and pos == tcfg.n_image_tokens + 41
    for jl, tl in pairs:
        np.testing.assert_allclose(tl, jl, atol=TOL, rtol=TOL)
    for t in [int(x) for x in rng.integers(0, 256, size=12)]:
        jl, cache = jax_decode_step(jcfg, jparams, jnp.asarray([[t]]), cache)
        tl = torch_decode_step(tcfg, tparams, torch.as_tensor([[t]]),
                               torch.as_tensor([pos], dtype=torch.int32), pools,
                               ctx[None], ctx[pos // PS].reshape(1))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
        pos += 1
    other, _ = _pool(tcfg, np.random.default_rng(1))
    moved = prefill_chunk(tcfg, tparams, torch.as_tensor([prompt[:CHUNK]]), 0, CHUNK,
                          other, ctx, image_embeds=torch.from_numpy(images * 0.5))
    assert not np.allclose(moved.numpy(), pairs[0][1], atol=1e-3)


def test_slab_prefill_with_images_matches_jax(models):
    """The slab `prefill` of a bucketed prompt behind the images, then slab
    decode steps at positions past the prefix."""
    jcfg, jparams, tcfg, tparams = models
    images = _images(tcfg, 12)
    prompt = [int(t) for t in np.random.default_rng(3).integers(0, 256, size=19)]
    toks = prompt + [0] * 5
    jl, jc = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray([toks]),
                                         "image_embeds": jnp.asarray(images)},
                         64, length=jnp.asarray(len(prompt)))
    tl, tc = prefill(tcfg, tparams, torch.as_tensor([toks]), 64, length=len(prompt),
                     image_embeds=torch.from_numpy(images))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    assert int(tc["pos"]) == int(jc["pos"]) == tcfg.n_image_tokens + len(prompt)
    for t in (5, 17, 33):
        jl, jc = jax_decode_step(jcfg, jparams, jnp.asarray([[t]]), jc)
        tl, tc = decode_step_slab(tcfg, tparams, torch.as_tensor([[t]]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="image tokens"):
        prefill(tcfg, tparams, torch.zeros((1, 60), dtype=torch.int64), 64,
                image_embeds=torch.from_numpy(images))


def test_greedy_tokens_identical(models):
    """Greedy decoding after a chunked prefill behind the images: 40 steps,
    every token equal."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(2)
    pools, ctx = _pool(tcfg, rng)
    prompt = list(lm_data.encode("Task: report the court. Evidence: heard at "))
    cache, pos, pairs = _prefill(models, prompt, _images(tcfg, 13), pools, ctx)
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


# ----------------------------------------------------------- the engine ---


def _run_pair(models, prompts, *, shared=0, max_new=4, **kw):
    """The same requests through the JAX engine and the port's (slots=2,
    max_len=64, chunk_size=5, as `tests/test_paged_kv.py`'s layout parity);
    tokens and every counter must be equal."""
    jcfg, jparams, tcfg, tparams = models
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
    assert to == jo
    assert dict(te.stats) == dict(je.stats)
    return out


LAYOUTS = [("slab", 8), ("paged", 8), ("paged", 32)]


@pytest.mark.parametrize("spec", ["off", "prompt_lookup"])
@pytest.mark.parametrize("pc", [False, True])
@pytest.mark.parametrize("layout,page_size", LAYOUTS)
def test_engine_matches_reference(models, layout, page_size, pc, spec):
    """`tests/test_paged_kv.py`'s shared-prefix prompts behind the 8 image
    positions. Page size 8 ends the images on a page boundary; 32 ends
    them mid-page, so the prefix entry's copy-on-write tail page holds
    image and text positions."""
    prompts = [SHARED + [10 + i, 20 + i, 30 + i] for i in range(3)]
    (je, jo), (te, to) = _run_pair(models, prompts, shared=len(SHARED), prefix_cache=pc,
                                   kv_layout=layout, page_size=page_size,
                                   spec_decode=spec)
    assert te._extra == je._extra == 8
    if pc:
        assert te.stats["prefix_hits"] == 2 and te.stats["prefix_inserts"] == 1
    if layout == "paged":
        assert te.alloc.refcount == je.alloc.refcount
        if pc:
            (entry,) = te.prefix_cache._entries.values()
            (jentry,) = je.prefix_cache._entries.values()
            assert (entry.pages, entry.tail_page, entry.nbytes) == \
                (jentry.pages, jentry.tail_page, jentry.nbytes)
            # 8 image + 12 text positions: the tail page is page 0 at 32
            assert len(entry.pages) == (0 if page_size == 32 else 2)
    elif pc:
        assert te.prefix_cache.nbytes == je.prefix_cache.nbytes


def test_slab_bucket_respects_image_tokens(models):
    """`tests/test_paged_kv.py`'s near-bound case: a prompt that fits with
    its images exactly, whose chunk_size bucket would round past
    max_len."""
    n = 64 - models[2].n_image_tokens - 1
    (je, jo), (te, to) = _run_pair(models, [list(range(1, n + 1))], max_new=2,
                                   slots=1, kv_layout="slab", chunk_size=32)
    assert len(to[0]) == 2
    assert te._prefill_buckets == {64 - models[2].n_image_tokens}
    eng = ServingEngine(models[2], models[3], slots=1, max_len=64, device="cpu")
    eng.submit(Request(rid=0, prompt=list(range(1, n + 3)), max_new=2))
    with pytest.raises(ValueError, match="image tokens"):
        eng.run()


def test_estimate_pages_matches_reference(models):
    """The admission frontend's page estimate counts the image prefix."""
    jcfg, jparams, tcfg, tparams = models
    for spec in ("off", "prompt_lookup"):
        for ps in (8, 32):
            kw = dict(slots=2, max_len=64, page_size=ps, spec_decode=spec)
            je = JaxEngine(jcfg, jparams, **kw)
            te = ServingEngine(tcfg, tparams, **kw, device="cpu")
            for plen, max_new in ((1, 1), (15, 4), (24, 8), (55, 4)):
                assert te.estimate_pages(plen, max_new) == \
                    je.estimate_pages(plen, max_new)
    assert te.estimate_pages(24, 8) == 1             # 8 + 24 positions, ps 32


def test_draft_model_drafter_refuses_vlm(models):
    jcfg, jparams, tcfg, tparams = models
    with pytest.raises(ValueError, match="dense/moe"):
        JaxDrafter(jcfg, jparams, slots=1, max_len=64)
    with pytest.raises(ValueError, match="dense/moe"):
        DraftModelDrafter(tcfg, tparams, slots=1, max_len=64, device="cpu")
    with pytest.raises(ValueError, match="dense/moe"):
        ServingEngine(tcfg, tparams, device="cpu", spec_decode="draft",
                      draft_model=(tcfg, tparams))
