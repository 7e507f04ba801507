"""ServedExtractor: QUEST's extraction operator driven by the port's
PyTorch serving engine (counterpart of `repro.extract.served`).

The retrieved segments become a real prompt; prefill/decode run through
`repro_torch.serving.ServingEngine` (continuous batching, paged KV, the
Hopper attention kernels on the card), and the ledger charges the engine's
true token counts. Since no
pretrained checkpoint ships in this container, answer *parsing* falls back
to the corpus pattern oracle when the model's decoded text doesn't parse —
cost/latency are real, accuracy is oracle-backed; with a trained checkpoint
(`examples/train_extractor.py`) the decoded text itself is used. This split
is documented in DESIGN.md §8.1.

`extract_batch` is the cross-document fast path (DESIGN.md §9): N prompts
are submitted together and drained by a *single* `engine.run()`, so the
engine's slots stay full and prefill/decode interleave across documents —
the serial `extract` path drains the engine once per extraction instead.

Prompts are ordered shared-part-first (DESIGN.md §10): the static task
template + attribute name + description come before the per-document
evidence, and `Request.shared_len` marks that boundary, so an engine with
the prefix KV cache enabled prefills the template once per attribute and
only the evidence tail per document. The byte-level tokenizer makes the
boundary exact (`encode(a + b) == encode(a) + encode(b)`).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.data import lm_data
from repro_torch.data.tokens import count_tokens
from repro_torch.obs import as_tracer
from repro_torch.serving.engine import Request, ServingEngine

MAX_PROMPT_TOKENS = 220


@dataclass
class ServedStats:
    requests: int = 0
    prompt_tokens: int = 0
    generated_tokens: int = 0
    batches: int = 0          # extract_batch rounds (one engine.run() each)
    max_batch: int = 0
    prefix_hits: int = 0               # engine prefix-cache hits for our reqs
    saved_prefill_tokens: int = 0      # prefill tokens skipped via those hits
    draft_tokens: int = 0              # speculative decode (DESIGN.md §14):
    accepted_tokens: int = 0           # drafted/accepted tokens and decode
    decode_steps_saved: int = 0        # steps saved for our requests


class ServedExtractor:
    # opt-in scheduler protocol extension (core/scheduler.py): batch calls
    # may carry `owners=` (per-item child ledgers) so requests inherit the
    # owning query's tenant/priority for admission control
    accepts_owners = True

    def __init__(self, corpus, engine: ServingEngine, *, max_new: int = 12,
                 oracle_fallback: bool = True, frontend=None,
                 doc_prefix_escalation: bool = False):
        """frontend: the admission frontend of the JAX package
        (`serving/frontend.py`) is not ported yet; it must be None.

        doc_prefix_escalation: lay full-document escalation prompts
        document-first (the document text is the shareable prefix, the
        attribute question the tail), so several attrs escalated on the
        same document share its prefill KV. Those entries embed document
        text, so a live-corpus mutation of the doc invalidates them
        (DESIGN.md §17) — which is exactly why the default template-first
        layout keeps its prefix entries mutation-immune."""
        if frontend is not None:
            raise NotImplementedError(
                "frontend= is not yet ported, see ROADMAP.md Queue 1")
        self.corpus = corpus
        self.engine = engine
        self.max_new = max_new
        self.oracle_fallback = oracle_fallback
        self.doc_prefix_escalation = doc_prefix_escalation
        self.stats = ServedStats()
        self._rid = 0

    # ------------------------------------------------------------ serving --

    def _prompt_prefix(self, doc_id, attr: str) -> str:
        """Shareable prompt head: identical for every document of an
        attribute, so it prefix-caches across the whole corpus sweep."""
        table = self.corpus.docs[doc_id].table
        desc = self.corpus.attr_description(table, attr)
        return (f"Task: report the value of one attribute from document "
                f"evidence. Attribute: {attr} ({desc}). "
                f"Answer with the value only. Evidence: ")

    @staticmethod
    def _owner_identity(owner) -> tuple:
        """(tenant, priority) a request inherits from its owning query's
        child ledger (core/ledger.py tags tenant ledgers and their query
        children); session-direct work runs as the default tenant."""
        tenant = getattr(owner, "tenant", "") or "default"
        return tenant, 0

    def _make_request(self, prefix_text: str, tail_text: str, owner=None,
                      content_docs=(), content_in_prefix=False) -> Request:
        """Build a request from (shareable prefix, per-request tail); the
        tail is truncated to the token budget, never the prefix boundary.
        `content_docs` records which documents' text the prompt embeds and
        `content_in_prefix` where it starts (prefix vs tail) — the engine
        tags prefix-cache entries with it for live-corpus invalidation."""
        cap = 4 * MAX_PROMPT_TOKENS
        prefix = lm_data.encode(prefix_text)[:cap]
        toks = prefix + lm_data.encode(tail_text)[:cap - len(prefix)]
        self._rid += 1
        self.stats.requests += 1
        self.stats.prompt_tokens += len(toks)
        tenant, priority = self._owner_identity(owner)
        return Request(rid=self._rid, prompt=toks or [lm_data.BOS],
                       max_new=self.max_new, eos_id=lm_data.EOS,
                       shared_len=min(len(prefix), max(len(toks) - 1, 0)),
                       tenant=tenant, priority=priority,
                       content_docs=tuple(content_docs),
                       content_start=(0 if content_in_prefix
                                      else len(prefix)) if content_docs
                                     else None)

    def _run_round(self, reqs: list) -> dict:
        """Submit N requests, drain with one continuous-batching run per
        admission window (the engine's queue_depth, when set, bounds how
        many requests may be queued at once)."""
        outs = {}
        es = self.engine.stats
        tracer = as_tracer(getattr(self.engine, "tracer", None))
        hits0, saved0 = es["prefix_hits"], es["prefix_saved_tokens"]
        spec0 = (es["draft_tokens"], es["accepted_tokens"],
                 es["decode_steps_saved"])
        with tracer.span("extract.round", kind="extract", reqs=len(reqs),
                         frontend=False):
            window = self.engine.queue_depth or len(reqs)
            for i in range(0, len(reqs), max(window, 1)):
                chunk = reqs[i:i + max(window, 1)]
                self.engine.submit_many(chunk)
                done = self.engine.run()
                self.stats.batches += 1
                self.stats.max_batch = max(self.stats.max_batch, len(chunk))
                for req in chunk:
                    if req.rid not in done:            # retry cap exceeded
                        failed = self.engine.failed.get(req.rid)
                        raise RuntimeError(
                            f"extraction request {req.rid} failed: "
                            f"{failed.error if failed else 'not in finished set'}")
                    out = done[req.rid].out
                    self.stats.generated_tokens += len(out)
                    outs[req.rid] = lm_data.decode(out)
            self._note_round_deltas(es, hits0, saved0, spec0)
            return outs

    def _note_round_deltas(self, es, hits0, saved0, spec0):
        self.stats.prefix_hits += es["prefix_hits"] - hits0
        self.stats.saved_prefill_tokens += es["prefix_saved_tokens"] - saved0
        self.stats.draft_tokens += es["draft_tokens"] - spec0[0]
        self.stats.accepted_tokens += es["accepted_tokens"] - spec0[1]
        self.stats.decode_steps_saved += es["decode_steps_saved"] - spec0[2]

    def _generate(self, prefix_text: str, tail_text: str) -> str:
        req = self._make_request(prefix_text, tail_text)
        return self._run_round([req])[req.rid]

    # ------------------------------------------------------------ parsing --

    def _spec(self, doc_id, attr):
        doc = self.corpus.docs[doc_id]
        spec = self.corpus.spec(doc.domain, attr)
        if spec is None:
            for attrs in self.corpus.attr_specs.values():
                if attr in attrs:
                    return attrs[attr]
        return spec

    def _parse(self, doc_id, attr: str, answer: str, context: str):
        spec = self._spec(doc_id, attr)
        value = spec.parse(answer) if spec else None
        if value is None and self.oracle_fallback and spec is not None:
            value = spec.parse(context)         # DESIGN.md §8.1 split
        return value

    # ----------------------------------------------------------- protocol --

    def extract(self, doc_id, attr: str, segments: list):
        return self.extract_batch([(doc_id, attr, segments)])[0]

    def extract_batch(self, items: list, owners: list = None):
        """items = [(doc_id, attr, segments)] -> [(value, input_tokens)].
        One continuous-batching round for the whole batch. `owners`
        (optional, parallel to items) carries each item's owning child
        ledger; its tenant/priority ride on the request for admission
        control."""
        results: list = [None] * len(items)
        reqs, meta = [], []
        for i, (doc_id, attr, segments) in enumerate(items):
            text = " ".join(segments)
            if not text:
                results[i] = (None, 0)
                continue
            req = self._make_request(self._prompt_prefix(doc_id, attr),
                                     f"{text} Answer:",
                                     owner=owners[i] if owners else None,
                                     content_docs=(doc_id,))
            reqs.append(req)
            meta.append((i, doc_id, attr, text, count_tokens(text), req.rid))
        if reqs:
            outs = self._run_round(reqs)
            for i, doc_id, attr, text, tokens, rid in meta:
                results[i] = (self._parse(doc_id, attr, outs[rid], text), tokens)
        return results

    def escalate_batch(self, items: list, owners: list = None):
        """Full-document escalation rounds (session `_resolve_escalations`
        dispatches here). Default layout delegates to `extract_batch`
        (template-first, prefix entries mutation-immune); with
        `doc_prefix_escalation` on, prompts go document-first so the N
        attrs escalated on one document share its prefill KV — those
        entries are doc-tagged and fall to `invalidate_docs` when the
        document mutates."""
        if not self.doc_prefix_escalation:
            return self.extract_batch(items, owners)
        results: list = [None] * len(items)
        reqs, meta = [], []
        for i, (doc_id, attr, segments) in enumerate(items):
            text = " ".join(segments)
            if not text:
                results[i] = (None, 0)
                continue
            doc = self.corpus.docs[doc_id]
            table = doc.table
            desc = self.corpus.attr_description(table, attr)
            req = self._make_request(
                f"Document evidence: {text} ",
                f"Task: report the value of one attribute. "
                f"Attribute: {attr} ({desc}). Answer:",
                owner=owners[i] if owners else None,
                content_docs=(doc_id,), content_in_prefix=True)
            reqs.append(req)
            meta.append((i, doc_id, attr, text, count_tokens(text), req.rid))
        if reqs:
            outs = self._run_round(reqs)
            for i, doc_id, attr, text, tokens, rid in meta:
                results[i] = (self._parse(doc_id, attr, outs[rid], text), tokens)
        return results

    def _full_doc_values(self, doc_id, attrs: list):
        doc = self.corpus.docs[doc_id]
        tokens = doc.tokens or count_tokens(doc.text)
        values, segs = {}, {}
        for attr in attrs:
            spec = self.corpus.spec(doc.domain, attr)
            v = spec.parse(doc.text) if spec else None
            values[attr] = v
            if v is not None and attr in doc.spans:
                segs[attr] = [doc.spans[attr]]
        return values, segs, tokens

    def extract_full_doc(self, doc_id, attrs: list):
        return self.extract_full_doc_batch([(doc_id, attrs)])[0]

    def extract_full_doc_batch(self, items: list, owners: list = None):
        """Sampling phase, batched: one real engine round represents the
        full-document analysis prompts of the whole chunk (shared attrs
        template first, document text last — same prefix-reuse shape)."""
        results, reqs = [], []
        for i, (doc_id, attrs) in enumerate(items):
            results.append(self._full_doc_values(doc_id, attrs))
            doc = self.corpus.docs[doc_id]
            reqs.append(self._make_request(
                f"Task: extract {', '.join(attrs)}. Document: ",
                doc.text[:800], owner=owners[i] if owners else None,
                content_docs=(doc_id,)))
        if reqs:
            self._run_round(reqs)
        return results
