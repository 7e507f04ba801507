"""CascadeExtractor: difficulty-aware two-tier extraction (DESIGN.md §18).

QUEST minimizes *which segments* reach the LLM; the cascade adds the next
cost axis — *which model*. A small zoo model (the same second-engine
plumbing the draft-model drafter of §14 uses, promoted to a first-class
extractor) serves the easy per-(doc, attr) extractions; the target model
serves the hard ones and every extraction the verifier bounces.

Routing: `core.difficulty.DifficultyEstimator` scores each (doc, attr)
from sampling-phase agreement stats, segment retrieval margins, and
context length; scores at or below its threshold go to the small tier.
A (doc, attr) the verifier ever escalated is memoized (`tier_memo`) and
routed straight to the target from then on — it never pays the small
model twice. Under a live corpus the memo and the difficulty estimates
drop with the mutated document (InvalidationCascade, §17/§18).

Verification: the small tier's answer goes through the same §8.1 parse
(decoded text, then the oracle-fallback context parse). A structurally
invalid result — no parseable value from either — escalates to the
target model in the same `extract_batch` round. Because the §8.1 parse
is deterministic in (doc, attr, segments), an accepted small-tier value
is the value the target path would have produced, so the cascade's row
parity is exact on this container, and with trained checkpoints the
verifier bar tightens to decoded-parse agreement at unchanged plumbing.

Modes (`cascade=`): "on" (route by difficulty), "off" (byte-identical to
a plain ServedExtractor on the target engine — the small engine is never
touched), "verify_all" (degenerate-routing parity check: everything
routes small and the verifier escalates everything, so rows must be
byte-identical to target-only while the small tier's cost is pure waste).

Accounting: small-tier requests/prompt/decode tokens land in dedicated
`CascadeServedStats` columns (the inherited columns stay target-tier
only); `target_tokens_saved` counts the prompt+decode tokens of accepted
small-tier extractions — target-model work that never happened. The
scheduler forwards round deltas to `CostLedger.record_cascade`, keeping
the logical token columns cascade-invariant like every other serving
optimization.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.difficulty import DifficultyEstimator
from repro_torch.data import lm_data
from repro_torch.data.tokens import count_tokens
from repro_torch.obs import as_tracer

from .served import ServedExtractor, ServedStats

CASCADE_MODES = ("on", "off", "verify_all")


@dataclass
class CascadeServedStats(ServedStats):
    # the inherited request/token columns count the *target* tier only;
    # the small tier reports apart so per-tier economics stay legible
    small_requests: int = 0
    small_prompt_tokens: int = 0
    small_generated_tokens: int = 0
    routed_small: int = 0          # routing decisions -> small tier
    routed_target: int = 0         # routing decisions -> target tier
    memo_target_routes: int = 0    # routed target because the memo said so
    escalations: int = 0           # verifier bounces (small -> target)
    accepted_small: int = 0        # small-tier values that stood
    target_tokens_saved: int = 0   # target prompt+decode tokens avoided


class CascadeExtractor(ServedExtractor):
    """ServedExtractor with a small-model fast tier. Same `extract_batch`
    / `extract_full_doc_batch` / `escalate_batch` contract, same scheduler
    protocol (`accepts_owners`); sampling sweeps and full-document
    escalations always run on the target engine (they are the evidence
    the difficulty estimates and output-critical retries rest on)."""

    def __init__(self, corpus, engine, small_engine=None, *,
                 cascade: str = "on", difficulty: DifficultyEstimator = None,
                 retriever=None, **kwargs):
        """`engine` is the target tier, `small_engine` the cheap tier (a
        ServingEngine over a smaller zoo config; None degrades to
        `cascade="off"`). `difficulty` is the routing estimator — built
        over `retriever` when omitted, so margins flow without extra
        wiring. Remaining kwargs are ServedExtractor's."""
        super().__init__(corpus, engine, **kwargs)
        if cascade not in CASCADE_MODES:
            raise ValueError(f"unknown cascade mode {cascade!r} "
                             f"(known: {CASCADE_MODES})")
        self.small_engine = small_engine
        self.cascade = cascade if small_engine is not None else "off"
        self.difficulty = (difficulty if difficulty is not None
                           else DifficultyEstimator(retriever))
        self.tier_memo: set = set()   # (doc_id, attr) escalated once already
        self.stats = CascadeServedStats()

    # ------------------------------------------------------------ routing --

    def _route(self, doc_id, attr: str, seg_tokens: int) -> str:
        if self.cascade == "verify_all":
            self.stats.routed_small += 1
            return "small"
        if (doc_id, attr) in self.tier_memo:
            self.stats.memo_target_routes += 1
            self.stats.routed_target += 1
            return "target"
        table = self.corpus.docs[doc_id].table
        tier = self.difficulty.route(doc_id, attr, table, seg_tokens)
        if tier == "small":
            self.stats.routed_small += 1
        else:
            self.stats.routed_target += 1
        return tier

    # ------------------------------------------------------ small serving --

    def _make_small_request(self, prefix_text, tail_text, owner=None,
                            content_docs=()):
        """Target-shaped request re-homed to the small tier: built by the
        parent (identical prompt bytes — the escalation path must replay
        the exact prompt on the target), then its counts move to the
        small-tier stat columns."""
        req = self._make_request(prefix_text, tail_text, owner=owner,
                                 content_docs=content_docs)
        self.stats.requests -= 1
        self.stats.prompt_tokens -= len(req.prompt)
        self.stats.small_requests += 1
        self.stats.small_prompt_tokens += len(req.prompt)
        return req

    def _run_small_round(self, reqs: list) -> dict:
        """One continuous-batching round on the small engine — the same
        drain loop as `_run_round`, with decode tokens landing in the
        small-tier column and engine-side prefix/spec deltas folded into
        the shared counters (a prefix hit is a saving whichever tier
        takes it)."""
        outs = {}
        es = self.small_engine.stats
        # spans land on the *target* engine's tracer: one trace per system
        tracer = as_tracer(getattr(self.engine, "tracer", None))
        hits0, saved0 = es["prefix_hits"], es["prefix_saved_tokens"]
        spec0 = (es["draft_tokens"], es["accepted_tokens"],
                 es["decode_steps_saved"])
        with tracer.span("cascade.small_round", kind="cascade",
                         reqs=len(reqs)):
            window = self.small_engine.queue_depth or len(reqs)
            for i in range(0, len(reqs), max(window, 1)):
                chunk = reqs[i:i + max(window, 1)]
                self.small_engine.submit_many(chunk)
                done = self.small_engine.run()
                self.stats.batches += 1
                self.stats.max_batch = max(self.stats.max_batch, len(chunk))
                for req in chunk:
                    if req.rid not in done:
                        failed = self.small_engine.failed.get(req.rid)
                        raise RuntimeError(
                            f"small-tier request {req.rid} failed: "
                            f"{failed.error if failed else 'not in finished set'}")
                    out = done[req.rid].out
                    self.stats.small_generated_tokens += len(out)
                    outs[req.rid] = lm_data.decode(out)
            self._note_round_deltas(es, hits0, saved0, spec0)
        return outs

    # ----------------------------------------------------------- protocol --

    def extract_batch(self, items: list, owners: list = None):
        """Cascaded batch round: route every item, run the small tier's
        round, verify, escalate rejects into the target tier's round of
        the *same* call — so one scheduler round still resolves every
        item, whatever mix of tiers it took."""
        if self.cascade == "off":
            return super().extract_batch(items, owners)
        results: list = [None] * len(items)
        small, target = [], []      # (item index, doc, attr, text, tokens)
        for i, (doc_id, attr, segments) in enumerate(items):
            text = " ".join(segments)
            if not text:
                results[i] = (None, 0)
                continue
            entry = (i, doc_id, attr, text, count_tokens(text))
            tier = self._route(doc_id, attr, entry[4])
            (small if tier == "small" else target).append(entry)
        tracer = as_tracer(getattr(self.engine, "tracer", None))
        tracer.instant("cascade.route", kind="cascade",
                       small=len(small), target=len(target))

        reqs, meta = [], []
        for i, doc_id, attr, text, tokens in small:
            req = self._make_small_request(
                self._prompt_prefix(doc_id, attr), f"{text} Answer:",
                owner=owners[i] if owners else None, content_docs=(doc_id,))
            reqs.append(req)
            meta.append((i, doc_id, attr, text, tokens, req))
        outs = self._run_small_round(reqs) if reqs else {}
        for i, doc_id, attr, text, tokens, req in meta:
            value = self._parse(doc_id, attr, outs[req.rid], text)
            if value is not None and self.cascade != "verify_all":
                self.stats.accepted_small += 1
                self.stats.target_tokens_saved += \
                    len(req.prompt) + self.max_new
                results[i] = (value, tokens)
            else:
                self.stats.escalations += 1
                self.tier_memo.add((doc_id, attr))
                target.append((i, doc_id, attr, text, tokens))
                if tracer.enabled(2):
                    tracer.instant("cascade.escalate", kind="cascade",
                                   level=2, doc=str(doc_id), attr=attr)

        reqs, meta = [], []
        for i, doc_id, attr, text, tokens in target:
            req = self._make_request(
                self._prompt_prefix(doc_id, attr), f"{text} Answer:",
                owner=owners[i] if owners else None, content_docs=(doc_id,))
            reqs.append(req)
            meta.append((i, doc_id, attr, text, tokens, req.rid))
        if reqs:
            outs = self._run_round(reqs)
            for i, doc_id, attr, text, tokens, rid in meta:
                results[i] = (self._parse(doc_id, attr, outs[rid], text),
                              tokens)
        return results
