"""The model cascade (`extract/cascade.py`) on the port against the JAX
package: the cases of `tests/test_cascade.py` that drive real engines, on
six SWDE university documents. The target tier is SMOKE qwen2.5-3b, the
small tier that file's one-layer cut of it, both with weights drawn by
the JAX package (`PRNGKey(0)` and `PRNGKey(1)`) and bridged. Values, the
`CascadeServedStats`, both engines' counters, ledger columns and the
generated tokens per rid must be identical."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.core.ledger import CostLedger as JaxLedger  # noqa: E402
from repro.core.scheduler import BatchScheduler as JaxScheduler  # noqa: E402
from repro.core.stats import SampleStats as JaxSampleStats  # noqa: E402
from repro.data import corpus as jcorpus  # noqa: E402
from repro.extract import CascadeExtractor as JaxCascade  # noqa: E402
from repro.extract import ServedExtractor as JaxServed  # noqa: E402
from repro.index.retriever import TwoLevelRetriever as JaxRetriever  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core.ledger import CostLedger  # noqa: E402
from repro_torch.core.scheduler import BatchScheduler  # noqa: E402
from repro_torch.core.stats import SampleStats  # noqa: E402
from repro_torch.data import corpus as tcorpus  # noqa: E402
from repro_torch.extract import CascadeExtractor, ServedExtractor  # noqa: E402
from repro_torch.index.embedder import HashedEmbedder  # noqa: E402
from repro_torch.index.retriever import TwoLevelRetriever  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from test_torch_serving import LEDGER_COLUMNS, weights  # noqa: E402,F401

N_DOCS = 6


def _small(cfg):
    return cfg.replace(num_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                       head_dim=16, d_ff=48)


@pytest.fixture(scope="module")
def tiers(weights):
    jcfg, jparams, tcfg, tparams, proj = weights
    jsmall = _small(jcfg)
    jsp = init_params(jsmall, jax.random.PRNGKey(1))
    tsp = params_from_numpy(_small(tcfg), jax.tree.map(np.asarray, jsp), device="cpu")
    return {"jax": (jcfg, jparams, jsmall, jsp), "torch": (tcfg, tparams, _small(tcfg), tsp),
            "proj": proj}


def _mods(pkg):
    if pkg == "jax":
        return dict(corpus=jcorpus, core=jcore, Engine=JaxEngine, Served=JaxServed,
                    Cascade=JaxCascade, SampleStats=JaxSampleStats, Ledger=JaxLedger,
                    Scheduler=JaxScheduler, kw={})
    return dict(corpus=tcorpus, core=tcore, Engine=ServingEngine, Served=ServedExtractor,
                Cascade=CascadeExtractor, SampleStats=SampleStats, Ledger=CostLedger,
                Scheduler=BatchScheduler, kw={"device": "cpu"})


def _corpus(m):
    full = m["corpus"].make_swde_corpus()
    return full.subset([d for d in sorted(full.docs) if "universities" in d][:N_DOCS])


def _engines(tiers, pkg, slots=2):
    m = _mods(pkg)
    cfg, params, scfg, sparams = tiers[pkg]
    target = m["Engine"](cfg, params, slots=slots, max_len=1024, prefix_cache=True, **m["kw"])
    small = m["Engine"](scfg, sparams, slots=slots, max_len=1024, prefix_cache=True,
                        **m["kw"])
    return target, small


def _folded_estimator(m, presence=1.0, n=4, cost=30.0, table="universities",
                      attr="tuition", **kw):
    est = m["core"].DifficultyEstimator(None, **kw)
    stats = m["SampleStats"](table=table)
    docs = [f"d{i}" for i in range(n)]
    present = round(presence * n)
    for i, d in enumerate(docs):
        stats.record(d, attr, 1 if i < present else None, int(cost))
    est.fold_sample(table, [attr], stats, sampled=docs)
    return est


def _items(corpus, n_docs, attrs):
    docs = sorted(corpus.docs)[:n_docs]
    return [(d, a, [corpus.docs[d].text]) for d in docs for a in attrs]


def _engine_state(*engines):
    return [(dict(e.stats), {r: q.out for r, q in e.finished.items()}) for e in engines]


def _off(tiers, pkg):
    m = _mods(pkg)
    corpus = _corpus(m)
    items = _items(corpus, 2, ["tuition", "enrollment"])
    target, _ = _engines(tiers, pkg)
    base = m["Served"](corpus, target, max_new=6).extract_batch(items)
    target2, small2 = _engines(tiers, pkg)
    casc = m["Cascade"](corpus, target2, small2, cascade="off", max_new=6)
    off = casc.extract_batch(items)
    assert off == base
    assert casc.stats.small_requests == 0 and small2.stats["decode_steps"] == 0
    assert m["Cascade"](corpus, target2, None, cascade="on", max_new=6).cascade == "off"
    return off, dataclasses.asdict(casc.stats), _engine_state(target, target2, small2)


def test_cascade_off_byte_identical_to_served(tiers):
    assert _off(tiers, "torch") == _off(tiers, "jax")


def _verify_all(tiers, pkg):
    m = _mods(pkg)
    corpus = _corpus(m)
    items = _items(corpus, 2, ["tuition", "enrollment"])
    target, _ = _engines(tiers, pkg)
    base = m["Served"](corpus, target, max_new=6).extract_batch(items)
    target2, small2 = _engines(tiers, pkg)
    casc = m["Cascade"](corpus, target2, small2, cascade="verify_all", max_new=6)
    rows = casc.extract_batch(items)
    assert rows == base
    assert casc.stats.routed_small == casc.stats.escalations == len(items)
    assert casc.stats.accepted_small == 0 and small2.stats["decode_steps"] > 0
    return rows, dataclasses.asdict(casc.stats), _engine_state(target2, small2)


def test_verify_all_escalates_everything_rows_identical(tiers):
    assert _verify_all(tiers, "torch") == _verify_all(tiers, "jax")


def _on(tiers, pkg):
    m = _mods(pkg)
    corpus = _corpus(m)
    items = _items(corpus, 2, ["tuition", "enrollment"])
    target, _ = _engines(tiers, pkg)
    base = m["Served"](corpus, target, max_new=6).extract_batch(items)
    target2, small2 = _engines(tiers, pkg)
    est = _folded_estimator(m, presence=1.0, cost=20.0)
    stats = m["SampleStats"](table="universities")
    for i in range(4):
        stats.record(f"d{i}", "enrollment", 1, 20)
    est.fold_sample("universities", ["enrollment"], stats, sampled=[])
    casc = m["Cascade"](corpus, target2, small2, cascade="on", difficulty=est, max_new=6)
    rows = casc.extract_batch(items)
    assert rows == base
    assert casc.stats.accepted_small == len(items) and casc.stats.target_tokens_saved > 0
    return rows, dataclasses.asdict(casc.stats), _engine_state(target2, small2)


def test_cascade_on_values_identical_and_saves_target_tokens(tiers):
    assert _on(tiers, "torch") == _on(tiers, "jax")


def _memo(tiers, pkg):
    m = _mods(pkg)
    corpus = _corpus(m)
    doc = sorted(corpus.docs)[0]
    items = [(doc, "tuition", ["no evidence in this segment"])]
    target, small = _engines(tiers, pkg)
    est = _folded_estimator(m, presence=1.0, cost=10.0)
    casc = m["Cascade"](corpus, target, small, cascade="on", difficulty=est, max_new=6)
    first = casc.extract_batch(items)
    assert first[0][0] is None and casc.stats.escalations == 1
    assert (doc, "tuition") in casc.tier_memo
    small_reqs = casc.stats.small_requests
    second = casc.extract_batch(items)
    assert second == first
    assert casc.stats.small_requests == small_reqs
    assert casc.stats.memo_target_routes == 1 and casc.stats.escalations == 1
    return first, dataclasses.asdict(casc.stats), dict(casc.tier_memo), \
        _engine_state(target, small)


def test_escalation_memo_exactly_once(tiers):
    assert _memo(tiers, "torch") == _memo(tiers, "jax")


def _ledger_flow(tiers, pkg):
    m = _mods(pkg)
    corpus = _corpus(m)
    docs = sorted(corpus.docs)[:2]
    items = [(d, a, "universities") for d in docs for a in ("tuition", "enrollment")]

    def run(mode):
        target, small = _engines(tiers, pkg)
        if pkg == "jax":
            retr = JaxRetriever(corpus, mode="rag_topk")
        else:
            retr = TwoLevelRetriever(corpus, mode="rag_topk", device="cpu",
                                     embedder=HashedEmbedder(proj=tiers["proj"],
                                                             device="cpu"))
        est = _folded_estimator(m, presence=1.0, cost=20.0)
        est.retriever = retr
        casc = m["Cascade"](corpus, target, small, cascade=mode, difficulty=est, max_new=6)
        ledger = m["Ledger"]()
        sched = m["Scheduler"](retr, casc, ledger, {}, batch_size=2)
        return sched.extract_many(items), casc, ledger, (target, small)

    rows_off, _, led_off, _ = run("off")
    rows_on, casc, led_on, engines = run("on")
    assert rows_on == rows_off
    for col in ("input_tokens", "output_tokens", "total_tokens", "per_phase"):
        assert led_on.snapshot()[col] == led_off.snapshot()[col]
    snap = led_on.snapshot()
    assert snap["cascade_small"] == casc.stats.accepted_small
    assert snap["cascade_escalations"] == casc.stats.escalations
    assert snap["target_tokens_saved"] == casc.stats.target_tokens_saved
    return rows_on, snap, {c: getattr(led_on, c) for c in LEDGER_COLUMNS}, \
        dataclasses.asdict(casc.stats), _engine_state(*engines)


def test_cascade_counters_flow_to_ledger(tiers):
    assert _ledger_flow(tiers, "torch") == _ledger_flow(tiers, "jax")
