"""The shared-prefix KV cache on the port against the JAX package: the store
(longest proper prefix, LRU, byte budget) on the same operations, the
paged cache ops it relies on (copy-on-write, rollback scrub, ref release)
on the same pools, and the engine's prefix path -- splice, CoW of the
boundary page, suffix prefill from mid-page, LRU eviction under pool
pressure, chunk budgets across a prefix resume -- against the JAX engine
on the same requests (bridged SMOKE qwen2.5-3b weights)."""
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import cache_ops as jops  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.prefix_cache import PrefixCache as JaxPrefixCache  # noqa: E402
from repro_torch.models import cache_ops as tops  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.prefix_cache import PrefixCache  # noqa: E402
from test_torch_serving import weights  # noqa: E402,F401

SHARED = [7, 3, 9, 4, 2, 8, 1, 6, 5, 7, 3, 2]


# ------------------------------------------------------------ the store ---


def _store_ops(pc, snap, big):
    """One script of store operations; returns what each one observed."""
    seen = []

    def match(prompt):
        e = pc.match(prompt)
        seen.append(None if e is None else e.tokens)

    pc.insert([1, 2], snap(2))
    pc.insert([1, 2, 3, 4], snap(4))
    match([1, 2, 3, 4, 9, 9])
    match([1, 2, 3, 4])                  # an equal entry is not a proper prefix
    match([5, 6, 7])
    pc.insert([1, 2], snap(2))           # refresh, no duplicate
    for t in range(3, 8):
        pc.insert([t], snap(1))
    match([1, 2, 9])
    match([3, 9])                        # evicted by max_entries
    pc.insert([9], big())
    pc.insert([10], big())               # byte budget evicts the LRU
    seen.append((len(pc), pc.nbytes, sorted(pc._entries)))
    seen.append(pc.stats.snapshot())
    return seen


def test_prefix_store_matches_reference():
    want = _store_ops(
        JaxPrefixCache(max_entries=4, max_bytes=1000),
        lambda n: {"pos": jnp.int32(n)},
        lambda: {"k": jnp.zeros((2, 1, 16, 4), jnp.float32)})
    got = _store_ops(
        PrefixCache(max_entries=4, max_bytes=1000),
        lambda n: {"pos": torch.tensor(n, dtype=torch.int32)},
        lambda: {"k": torch.zeros((2, 1, 16, 4), dtype=torch.float32)})
    assert got == want
    assert got[-1]["evictions"] > 0 and got[-1]["hits"] == 2


def test_prefix_store_release_and_lru_pop():
    released = []
    pc = PrefixCache(max_entries=2)
    for t in (1, 2, 3):
        pc.insert([t], {}, pages=(t,), release=lambda t=t: released.append(t))
    assert released == [1] and len(pc) == 2
    pc.insert([2], {}, release=lambda: released.append("dup"))
    assert released == [1, "dup"]            # a refresh drops the new copy
    assert pc.pop_lru().tokens == (3,) and released[-1] == 3
    assert pc.invalidate_docs([5]) == 0
    pc.clear()
    assert released[-1] == 2 and pc.pop_lru() is None


# ------------------------------------------------------------ cache ops ---


def test_page_ops_match_reference(weights):
    """copy_page, truncate_pages (only the positions JAX zeroes, blocks past
    the allocation skipped) and release_trailing_pages, in place on the
    port's pools against the JAX package's functional versions."""
    jcfg, _, tcfg, _, _ = weights
    ja, ta = jops.PageAllocator(jcfg, 9, 8), tops.PageAllocator(tcfg, 9, 8, device="cpu")
    rng = np.random.default_rng(0)
    for k in ta.pools:
        fill = rng.standard_normal(tuple(ta.pools[k].shape)).astype(np.float32)
        ja.pools[k] = jnp.asarray(fill)
        ta.pools[k].copy_(torch.from_numpy(fill))
    assert ta.alloc(3) == ja.alloc(3) == [1, 2, 3]
    assert ta.copy_page(2) == ja.copy_page(2)
    pages = [1, 2, 3]
    for start, end in ((5, 19), (0, 3), (16, 40), (9, 9)):
        ja.pools = jops.truncate_pages(ja.pools, pages, start, end, 8)
        tops.truncate_pages(ta.pools, pages, start, end, 8)
    for k in ta.pools:
        np.testing.assert_array_equal(ta.pools[k].numpy(), np.asarray(ja.pools[k]))
    assert tops.release_trailing_pages(ta, list(pages), 1) == \
        jops.release_trailing_pages(ja, list(pages), 1) == [1]
    assert tops.release_trailing_pages(ta, [1], 4) == [1]
    assert ta.refcount == ja.refcount and ta.free_pages == ja.free_pages


# ----------------------------------------------------------- the engine ---


def _engines(weights, *, engine_kw=None, **kw):
    jcfg, jparams, tcfg, tparams, _ = weights
    base = dict(slots=2, max_len=64, prefix_min_len=4)
    base.update(engine_kw or {})
    return (JaxEngine(jcfg, jparams, **base, **kw),
            ServingEngine(tcfg, tparams, **base, **kw, device="cpu"))


def _submit(pair, prompts, shared, max_new=5):
    for eng, Req in zip(pair, (JaxRequest, Request)):
        for i, p in enumerate(prompts):
            eng.submit(Req(rid=i, prompt=p, max_new=max_new, eos_id=-1,
                           shared_len=shared))


def _outs(eng):
    return {r: q.out for r, q in eng.finished.items()}


def _assert_same(je, te):
    assert _outs(te) == _outs(je)
    assert dict(te.stats) == dict(je.stats)
    assert te.alloc.refcount == je.alloc.refcount
    assert te.prefix_cache.stats.snapshot() == je.prefix_cache.stats.snapshot()
    assert {k: (e.pages, e.tail_page, e.nbytes)
            for k, e in te.prefix_cache._entries.items()} == \
        {k: (e.pages, e.tail_page, e.nbytes)
         for k, e in je.prefix_cache._entries.items()}


@pytest.mark.parametrize("chunk_size,page_size", [(32, 16), (5, 8), (6, 4)])
def test_engine_prefix_cache_matches_reference_and_cache_off(weights, chunk_size,
                                                            page_size):
    """Outputs identical with the cache on and off and to the JAX engine,
    with its counters (`prefix_hits`, `prefix_saved_tokens`,
    `prefix_inserts`, `cow_copies`, `kv_bytes_peak`, ...)."""
    prompts = [SHARED + [10 + i, 20 + i, 30 + i] for i in range(4)]
    je, te = pair = _engines(weights, prefix_cache=True, engine_kw=dict(
        chunk_size=chunk_size, page_size=page_size))
    _submit(pair, prompts, len(SHARED))
    je.run(), te.run()
    _assert_same(je, te)
    assert te.stats["prefix_hits"] == 3
    assert te.stats["prefix_saved_tokens"] == 3 * len(SHARED)
    assert te.stats["prefix_inserts"] == 1
    assert te.stats["cow_copies"] == (4 if len(SHARED) % page_size else 0)
    _, _, tcfg, tparams, _ = weights
    off = ServingEngine(tcfg, tparams, slots=2, max_len=64, prefix_cache=False,
                        chunk_size=chunk_size, page_size=page_size, device="cpu")
    for i, p in enumerate(prompts):
        off.submit(Request(rid=i, prompt=p, max_new=5, eos_id=-1, shared_len=len(SHARED)))
    off.run()
    assert _outs(off) == _outs(te)
    assert te.stats["prefill_tokens"] + te.stats["prefix_saved_tokens"] == \
        off.stats["prefill_tokens"]


def test_engine_prefix_lru_eviction_under_pool_pressure(weights):
    """A pool too small for every prefix entry: admission evicts LRU
    entries (releasing their pages) until the pages fit, identically to
    the JAX engine."""
    prompts = [[g] + SHARED[g:] + SHARED[:g] + [40 + i]
               for g in range(5) for i in range(2)]
    kw = dict(engine_kw=dict(slots=1, page_size=4, chunk_size=6, num_pages=12))
    je, te = pair = _engines(weights, prefix_cache=True, **kw)
    _submit(pair, prompts, len(SHARED) + 1)
    je.run(), te.run()
    _assert_same(je, te)
    assert te.prefix_cache.stats.evictions > 0
    assert te.stats["prefix_hits"] > 0 and len(_outs(te)) == len(prompts)


def test_engine_chunk_budget_across_prefix_resume(weights):
    """`step(max_prefill_chunks=1)`: the insert yields between chunks,
    before the boundary snapshot and after it, and a prefix hit resumes
    from mid-page; every step's counters equal the JAX engine's."""
    prompts = [SHARED + list(range(20, 20 + n)) for n in (9, 3, 14)]
    je, te = pair = _engines(weights, prefix_cache=True,
                             engine_kw=dict(page_size=8, chunk_size=5))
    _submit(pair, prompts, len(SHARED), max_new=6)
    trace = []
    while True:
        more = [eng.step(max_prefill_chunks=1) for eng in pair]
        assert more[0] == more[1]
        trace.append((dict(je.stats), dict(te.stats), sorted(je._inserting),
                       sorted(te._inserting), sorted(je.active), sorted(te.active)))
        if not more[0]:
            break
    for j_stats, t_stats, j_ins, t_ins, j_act, t_act in trace:
        assert t_stats == j_stats and t_ins == j_ins and t_act == j_act
    _assert_same(je, te)
    assert te.stats["prefix_hits"] == 2 and len(trace) > 8
