"""Replica groups (`serving/replicas.py`) on the port against the JAX
package: the single-process cases of `tests/test_sharded_serving.py`, with
its engine settings (`ENGINE_KW`) and workload (a 12-token shared prefix
and per-request tails), each run through both packages' `ReplicaGroup`s
over bridged SMOKE qwen2.5-3b weights. Tokens per rid, the group's
aggregate counters and every replica's own counters must be identical;
two replicas share one `PageAllocator` and one prefix cache."""
import pytest

torch = pytest.importorskip("torch")

from repro.serving import replicas as jrep  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.models.cache_ops import PageAllocator  # noqa: E402
from repro_torch.serving import replicas as trep  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from test_torch_serving import weights  # noqa: E402,F401

SHARED = [7, 3, 9, 4, 2, 8, 1, 6, 5, 7, 3, 2]
ENGINE_KW = dict(slots=2, max_len=64, prefix_cache=True, prefix_min_len=4,
                 page_size=8, chunk_size=5)
SUM_EQUAL_KEYS = ["prefill_tokens", "prefix_hits", "prefix_saved_tokens",
                  "prefix_inserts", "decode_slot_steps", "draft_tokens",
                  "accepted_tokens", "decode_steps_saved"]


def _side(weights, pkg):
    """(make engine, make group, Request) of one package."""
    jcfg, jparams, tcfg, tparams, _ = weights
    if pkg == "jax":
        return (lambda **kw: JaxEngine(jcfg, jparams, **kw),
                lambda **kw: jrep.ReplicaGroup(jcfg, jparams, **kw), JaxRequest)
    return (lambda **kw: ServingEngine(tcfg, tparams, device="cpu", **kw),
            lambda **kw: trep.ReplicaGroup(tcfg, tparams, device="cpu", **kw), Request)


def _reqs(Req, n=8, max_new=6):
    return [Req(rid=i, prompt=SHARED + [10 + i, 20 + i, 30 + i],
                max_new=max_new, eos_id=-1, shared_len=len(SHARED))
            for i in range(n)]


def _group_state(grp):
    return (dict(grp.stats), [dict(e.stats) for e in grp.engines],
            {i: list(r.out) for i, r in grp.finished.items()})


def _rows_match_single(weights, pkg, layout, spec):
    make_eng, make_grp, Req = _side(weights, pkg)
    kw = dict(ENGINE_KW, kv_layout=layout, spec_decode=spec)
    eng = make_eng(**kw)
    eng.submit_many(_reqs(Req))
    ref = {i: list(r.out) for i, r in eng.run().items()}
    grp = make_grp(replicas=2, **kw)
    grp.submit_many(_reqs(Req))
    got = {i: list(r.out) for i, r in grp.run().items()}
    assert got == ref
    return ref, _group_state(grp)


@pytest.mark.parametrize("layout,spec", [("paged", "prompt_lookup"),
                                         ("paged", "off"), ("slab", "off")])
def test_replica_group_rows_match_single_engine(weights, layout, spec):
    assert _rows_match_single(weights, "torch", layout, spec) == \
        _rows_match_single(weights, "jax", layout, spec)


def _stats_sum(weights, pkg):
    make_eng, make_grp, Req = _side(weights, pkg)
    kw = dict(ENGINE_KW, kv_layout="paged", spec_decode="prompt_lookup")
    eng = make_eng(**kw)
    eng.submit_many(_reqs(Req))
    eng.run()
    grp = make_grp(replicas=2, **kw)
    grp.submit_many(_reqs(Req))
    grp.run()
    for k in SUM_EQUAL_KEYS:
        assert grp.stats[k] == eng.stats[k], k
        assert grp.stats[k] == sum(e.stats[k] for e in grp.engines), k
    assert all(e.stats["decode_slot_steps"] > 0 for e in grp.engines)
    return dict(eng.stats), _group_state(grp)


def test_replica_stats_sum_equals_single_engine(weights):
    assert _stats_sum(weights, "torch") == _stats_sum(weights, "jax")


def _live_dict(weights, pkg):
    _, make_grp, Req = _side(weights, pkg)
    grp = make_grp(replicas=2, kv_layout="paged", **ENGINE_KW)
    ref = grp.stats
    grp.submit_many(_reqs(Req, 4))
    grp.run()
    assert ref is grp.stats and ref["runs"] == 1
    before = ref["prefill_tokens"]
    grp.submit_many(_reqs(Req, 4))
    grp.run()
    assert ref is grp.stats and ref["runs"] == 2
    assert ref["prefill_tokens"] > before
    assert all(e.stats["runs"] == 0 for e in grp.engines)
    return _group_state(grp)


def test_replica_stats_live_dict_and_run_accounting(weights):
    assert _live_dict(weights, "torch") == _live_dict(weights, "jax")


def test_aggregate_stats_sums_and_peaks():
    a = {"prefill_tokens": 3, "max_live": 2, "kv_bytes_peak": 100}
    b = {"prefill_tokens": 5, "max_live": 4, "kv_bytes_peak": 70, "extra": 1}
    assert trep.aggregate_stats([a, b]) == jrep.aggregate_stats([a, b])
    assert trep.PEAK_KEYS == jrep.PEAK_KEYS
    into = {"stale": 9}
    out = trep.aggregate_stats([a, b], into=into)
    assert out is into and "stale" not in into and into["max_live"] == 4


def _queue_depth(weights, pkg):
    _, make_grp, Req = _side(weights, pkg)
    grp = make_grp(replicas=2, queue_depth=3, kv_layout="paged", **ENGINE_KW)
    grp.submit_many(_reqs(Req, 3))
    with pytest.raises(RuntimeError, match="queue full"):
        grp.submit(_reqs(Req, 4)[3])
    with pytest.raises(RuntimeError, match="queue full"):
        grp.submit_many(_reqs(Req, 2))
    assert len(grp.queue) == 3
    grp.run()
    assert set(grp.finished) == {0, 1, 2} and grp.failed == {}
    return _group_state(grp)


def test_replica_group_queue_depth_and_failed(weights):
    assert _queue_depth(weights, "torch") == _queue_depth(weights, "jax")


def _shared_pool(weights, pkg):
    _, make_grp, Req = _side(weights, pkg)
    grp = make_grp(replicas=2, kv_layout="paged", **ENGINE_KW)
    assert all(e.alloc is grp.engines[0].alloc for e in grp.engines)
    assert all(e.prefix_cache is grp.prefix_cache for e in grp.engines)
    grp.submit_many(_reqs(Req))
    grp.run()
    assert grp.stats["prefix_inserts"] == 1
    assert grp.stats["prefix_hits"] == 7
    alloc = grp.engines[0].alloc
    entry = next(iter(grp.prefix_cache._entries.values()))
    live = len(entry.pages) + (1 if entry.tail_page is not None else 0)
    assert alloc.used_pages == live
    return _group_state(grp), alloc.used_pages, alloc.free_pages, \
        [list(e.slot_pages) for e in grp.engines]


def test_replica_group_shared_prefix_cache_and_pool(weights):
    assert _shared_pool(weights, "torch") == _shared_pool(weights, "jax")


def test_shared_allocator_checks_and_refusals(weights):
    """The engine takes a shared allocator only at its page size and on its
    device; the group refuses mesh= as the engine does."""
    _, _, tcfg, tparams, _ = weights
    alloc = PageAllocator(tcfg, 9, 16, device="cpu")
    eng = ServingEngine(tcfg, tparams, device="cpu", page_allocator=alloc)
    assert eng.alloc is alloc and eng.pool_free_pages() == 8 and eng.free_slots == 4
    with pytest.raises(AssertionError, match="page_size"):
        ServingEngine(tcfg, tparams, device="cpu", page_size=8, max_len=64,
                      page_allocator=alloc)
    meta = PageAllocator(tcfg, 9, 16, device="meta")
    with pytest.raises(AssertionError, match="pools live on"):
        ServingEngine(tcfg, tparams, device="cpu", page_allocator=meta)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        trep.ReplicaGroup(tcfg, tparams, device="cpu", mesh=object())
