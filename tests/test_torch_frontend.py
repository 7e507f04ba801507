"""The admission frontend (`serving/frontend.py`) on the port against the
JAX package: the same tickets through each package's `ServingFrontend`
over its own engine (bridged SMOKE qwen2.5-3b weights, the frontend
fixture's engine of `tests/test_serve_frontend.py`: 2 slots, max_len 96,
16-token pages, 16 pages). Ticket statuses, generated tokens per rid,
frontend, tenant and engine counters must be identical. Beside the
real-engine cases of that file, an extraction round through
`ServedExtractor(frontend=)` and the session-level cancellation."""
import dataclasses
import time

import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.data import corpus as jcorpus  # noqa: E402
from repro.data import lm_data  # noqa: E402
from repro.extract import OracleExtractor as JaxOracle  # noqa: E402
from repro.extract.served import ServedExtractor as JaxServed  # noqa: E402
from repro.index.retriever import TwoLevelRetriever as JaxRetriever  # noqa: E402
from repro.serving import frontend as jfe  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.data import corpus as tcorpus  # noqa: E402
from repro_torch.extract import OracleExtractor  # noqa: E402
from repro_torch.extract.served import ServedExtractor  # noqa: E402
from repro_torch.index.embedder import HashedEmbedder  # noqa: E402
from repro_torch.index.retriever import TwoLevelRetriever  # noqa: E402
from repro_torch.serving import frontend as tfe  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from test_torch_serving import (LEDGER_COLUMNS, _mini_swde, _swde_query,  # noqa: E402
                                weights)  # noqa: F401

FIXTURE = dict(slots=2, max_len=96, kv_layout="paged", page_size=16, num_pages=16)


def _stack(weights, pkg, **kw):
    """(engine, frontend module, Request) of one package on the fixture's
    engine settings."""
    jcfg, jparams, tcfg, tparams, _ = weights
    kw = {**FIXTURE, **kw}
    if pkg == "jax":
        return JaxEngine(jcfg, jparams, **kw), jfe, JaxRequest
    return ServingEngine(tcfg, tparams, device="cpu", **kw), tfe, Request


def _reqs(Req, n, max_new=5):
    return [Req(rid=i, prompt=lm_data.encode(f"probe {i} value="), max_new=max_new)
            for i in range(n)]


def _state(eng, fe, tickets):
    return ({t.rid: (t.status, t.shed_reason, list(t.req.out)) for t in tickets},
            dict(fe.stats), fe.tenant_snapshot(), dict(eng.stats),
            eng.pool_free_pages())


def _rows_match_serial(weights, pkg):
    eng_s, mod, Req = _stack(weights, pkg)
    serial = {}
    for req in _reqs(Req, 4):
        eng_s.submit(req)
        serial[req.rid] = list(eng_s.run()[req.rid].out)
    eng, mod, Req = _stack(weights, pkg)
    fe = mod.ServingFrontend(eng, max_prefill_chunks=1)
    ts = [fe.submit(req=r, tenant=f"t{r.rid % 2}") for r in _reqs(Req, 4)]
    fe.pump_until_idle()
    assert all(t.status == mod.DONE for t in ts)
    assert {t.rid: list(t.req.out) for t in ts} == serial
    return serial, _state(eng, fe, ts)


def test_real_engine_rows_match_serial(weights):
    assert _rows_match_serial(weights, "torch") == _rows_match_serial(weights, "jax")


def _leak_regression(weights, pkg):
    eng, mod, Req = _stack(weights, pkg, prefix_cache=True)
    fe = mod.ServingFrontend(eng, max_prefill_chunks=1)
    base = eng.pool_free_pages()
    reqs = _reqs(Req, 4, max_new=20)
    cancelled_mid = fe.submit(req=reqs[0], tenant="a")
    timed_out = fe.submit(req=reqs[1], tenant="a", deadline_ticks=2)
    cancelled_queued = fe.submit(req=reqs[2], tenant="b")
    survivor = fe.submit(req=reqs[3], tenant="b")
    fe.cancel(cancelled_queued)              # still QUEUED: no engine state
    fe.pump()                                # first two mid-insert/active
    fe.cancel(cancelled_mid)
    fe.pump()
    fe.pump()                                # deadline passes in flight
    fe.pump_until_idle()
    assert [t.status for t in (cancelled_mid, timed_out, cancelled_queued, survivor)] == \
        [mod.CANCELLED, mod.TIMEOUT, mod.CANCELLED, mod.DONE]
    tickets = [cancelled_mid, timed_out, cancelled_queued, survivor]
    state = _state(eng, fe, tickets)
    eng.prefix_cache.clear()                 # cache-held pages are accounted
    assert eng.pool_free_pages() == base, "lifecycle exit leaked KV pages"
    return state


def test_real_engine_leak_regression_on_cancel_and_timeout(weights):
    assert _leak_regression(weights, "torch") == _leak_regression(weights, "jax")


def _backpressure(weights, pkg):
    # pool fits ~one request; the rest defer/absorb, never raise
    eng, mod, Req = _stack(weights, pkg, num_pages=4, prefix_cache=False)
    fe = mod.ServingFrontend(eng, max_prefill_chunks=1)
    base = eng.pool_free_pages()             # num_pages minus the sink page
    ts = [fe.submit(req=r, tenant="a") for r in _reqs(Req, 3, max_new=8)]
    fe.pump_until_idle()
    assert all(t.status == mod.DONE for t in ts)
    assert fe.stats["deferred"] + fe.stats["pool_exhausted_absorbed"] + \
        eng.stats["admission_deferred"] > 0
    assert eng.pool_free_pages() == base
    return _state(eng, fe, ts)


def test_real_engine_backpressure_never_raises(weights):
    assert _backpressure(weights, "torch") == _backpressure(weights, "jax")


def _shed_and_priority(weights, pkg):
    """Typed shedding (a prompt over max_len, past max_queue) and a strict
    priority class over two weighted tenants, on the real engine."""
    eng, mod, Req = _stack(weights, pkg)
    fe = mod.ServingFrontend(eng, tenant_weights={"gold": 2.0}, max_queue=5,
                             max_prefill_chunks=2)
    reqs = _reqs(Req, 6)
    ts = [fe.submit(req=r, tenant="gold" if r.rid % 2 else "silver")
          for r in reqs[:4]]
    ts.append(fe.submit(req=reqs[4], tenant="silver", priority=1))
    ts.append(fe.submit(req=reqs[5], tenant="gold"))          # past max_queue
    ts.append(fe.submit(list(range(3, 120)), tenant="gold"))  # over max_len
    fe.pump_until_idle()
    assert [t.status for t in ts].count(mod.SHED) == 2
    return _state(eng, fe, ts)


def test_shed_and_priority_identical(weights):
    assert _shed_and_priority(weights, "torch") == _shed_and_priority(weights, "jax")


def _served_round(weights, pkg):
    """A served mini-SWDE query whose extraction rounds go through the
    admission frontend (the query's tenant rides on its requests; the
    sampling phase's run as the default tenant)."""
    jcfg, jparams, tcfg, tparams, proj = weights
    core = jcore if pkg == "jax" else tcore
    corpus = _mini_swde(jcorpus if pkg == "jax" else tcorpus)
    if pkg == "jax":
        eng = JaxEngine(jcfg, jparams, slots=4, max_len=1024, prefix_cache=True)
        fe = jfe.ServingFrontend(eng, tenant_weights={"gold": 2.0}, max_prefill_chunks=2)
        ex = JaxServed(corpus, eng, max_new=6, frontend=fe)
        ret = JaxRetriever(corpus)
    else:
        eng = ServingEngine(tcfg, tparams, slots=4, max_len=1024, prefix_cache=True,
                            device="cpu")
        fe = tfe.ServingFrontend(eng, tenant_weights={"gold": 2.0}, max_prefill_chunks=2)
        ex = ServedExtractor(corpus, eng, max_new=6, frontend=fe)
        ret = TwoLevelRetriever(corpus, embedder=HashedEmbedder(proj=proj, device="cpu"),
                                device="cpu")
    sess = core.Session(ret, ex, batch_size=4)
    res = sess.prepare(_swde_query(core)).submit(tenant="gold").result()
    assert res.rows and fe.stats["completed"] == ex.stats.requests > 0
    assert "gold" in fe.tenants
    return (res.rows, {c: getattr(res.ledger, c) for c in LEDGER_COLUMNS},
            dict(eng.stats), dataclasses.asdict(ex.stats), dict(fe.stats),
            fe.tenant_snapshot(), {r: q.out for r, q in eng.finished.items()})


def test_served_extractor_through_frontend_identical(weights):
    assert _served_round(weights, "torch") == _served_round(weights, "jax")


def _session_cancel(pkg):
    core = jcore if pkg == "jax" else tcore
    corpus = (jcorpus if pkg == "jax" else tcorpus).make_wiki_corpus(seed=0)
    q = core.Query(tables=["players"], select=[("players", "player_name")],
                   where=core.conj(core.Filter("age", ">", 30, table="players"),
                                   core.Filter("all_stars", ">=", 5, table="players")))
    if pkg == "jax":
        ret, ex = JaxRetriever(corpus), JaxOracle(corpus)
    else:
        from repro.index.embedder import HashedEmbedder as JaxEmbedder
        import numpy as np
        proj = np.asarray(JaxEmbedder()._proj)
        ret = TwoLevelRetriever(corpus, embedder=HashedEmbedder(proj=proj, device="cpu"),
                                device="cpu")
        ex = OracleExtractor(corpus)
    sess = core.Session(ret, ex, batch_size=4)
    h = sess.submit(q, tenant="acme")
    sess._step()                             # mid-sampling: owns reservation
    assert h.cancel() and not h.cancel()
    with pytest.raises(core.QueryCancelled):
        h.result()
    assert not sess._samples, "cancel left a sampling reservation behind"
    ref = sess.execute(q)
    h2 = sess.submit(q, deadline_s=0.0)
    time.sleep(0.005)
    with pytest.raises(core.QueryTimeout):
        h2.result()
    assert not sess._active
    return ref.rows, {c: getattr(ref.ledger, c) for c in LEDGER_COLUMNS}


def test_session_cancel_and_timeout_release_sampling():
    assert _session_cancel("torch") == _session_cancel("jax")


def test_serving_costs_match_reference_at_h100_rates():
    """`serving/costs.py`: the flops and bytes fields of every ported config
    equal the JAX package's; the rates come from the H100's peaks."""
    from repro.configs import get_config as jax_get_config
    from repro.serving import costs as jcosts
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.serving import costs as tcosts
    assert (tcosts.PEAK_FLOPS, tcosts.HBM_BW) == (989e12, 3.35e12)
    fields = ("arch", "prefill_flops_per_token", "decode_flops_per_token",
              "kv_bytes_per_token", "state_bytes")
    table = tcosts.cost_table(context=2048)
    assert [c.arch for c in table] == [get_config(a).name for a in ARCH_IDS]
    for arch, ours in zip(ARCH_IDS, table):
        theirs = jcosts.serving_costs(jax_get_config(arch), context=2048)
        assert [getattr(ours, f) for f in fields] == [getattr(theirs, f) for f in fields]
        assert ours.prefill_tokens_per_s_chip == 0.4 * 989e12 / ours.prefill_flops_per_token
        dec_bytes = get_config(arch).param_count(active_only=True) * 2 + \
            ours.kv_bytes_per_token * 2048 + ours.state_bytes
        assert ours.decode_ms_per_token_chip == 1e3 * dec_bytes / 3.35e12
        assert ours.extraction_seconds(100, 10) == pytest.approx(
            100 / ours.prefill_tokens_per_s_chip + 10 * ours.decode_ms_per_token_chip / 1e3)
