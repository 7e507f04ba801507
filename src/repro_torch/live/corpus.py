"""LiveCorpus: first-class ingest/update/delete over a `data.Corpus`
(DESIGN.md §17).

Mutations are applied *in place* on the wrapped corpus — every component
holding a reference (retriever, extractor, session) observes the new state
the moment a mutation lands — and every mutation appends a `MutationRecord`
to the versioned log, bumps the document's `(version, sha)` manifest entry,
and notifies subscribed listeners in subscription order. The listener
protocol is what the incremental index (`live.index.LiveRetriever`) and the
invalidation cascade (`live.invalidate.InvalidationCascade`) hang off.

Ground truth stays consistent under edits: unless the caller passes explicit
`truth=`/`spans=`, `update()` re-derives both from the new text via the
corpus attr specs (pattern parse + carrier-sentence search) — exactly what a
generator would have planted — so a rebuilt-from-scratch corpus at any
mutation point is byte-equivalent to the live one (the parity oracle).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

from repro_torch.data.corpus import Corpus, Document
from repro_torch.data.tokens import count_tokens, split_sentences

from .log import MutationLog, MutationRecord, sha_text


def _utf8_len(s: str) -> int:
    return len(s.encode("utf-8"))


def edit_span_bytes(old: str, new: str) -> int:
    """Size of the localized edit between two texts: strip the common
    prefix/suffix, count the differing middle of the *new* text (an edit
    that only deletes still counts 0 new bytes but bumps mutations)."""
    lo = min(len(old), len(new))
    i = 0
    while i < lo and old[i] == new[i]:
        i += 1
    j = 0
    while j < lo - i and old[len(old) - 1 - j] == new[len(new) - 1 - j]:
        j += 1
    return _utf8_len(new[i:len(new) - j])


def render_edit(corpus, doc_id, attr: str, new_value) -> str:
    """Edited full text of `doc_id` with `attr`'s value replaced by
    `new_value` in its carrier sentence — the canonical localized edit the
    tests and benchmark drive `update()` with."""
    doc = corpus.docs[doc_id]
    spec = corpus.spec(doc.domain, attr)
    old_sent = doc.spans.get(attr)
    if spec is None or old_sent is None:
        raise KeyError(f"{doc_id} has no editable span for {attr!r}")
    m = re.search(spec.pattern, old_sent)
    if m is None:
        raise ValueError(f"span for {attr!r} no longer matches its pattern")
    new_sent = old_sent[:m.start(1)] + str(new_value) + old_sent[m.end(1):]
    return doc.text.replace(old_sent, new_sent, 1)


@dataclass
class LiveCorpusStats:
    mutations: int = 0
    ingests: int = 0
    updates: int = 0
    deletes: int = 0
    edited_bytes: int = 0      # localized-diff bytes across updates
    ingested_bytes: int = 0
    deleted_bytes: int = 0

    def snapshot(self) -> dict:
        return dict(self.__dict__)


class LiveCorpus:
    """Mutable view over a `Corpus`. All reads delegate to the wrapped
    corpus, so a LiveCorpus can stand in anywhere a Corpus is expected."""

    def __init__(self, corpus: Corpus):
        self.corpus = corpus
        self.log = MutationLog()
        self.stats = LiveCorpusStats()
        self._listeners: list = []
        # seed manifest: version 0 entries for the initial snapshot, so
        # replay digests cover the starting state too
        for doc_id, doc in corpus.docs.items():
            doc.sha = doc.sha or sha_text(doc.text)
            self.log.manifest[doc_id] = (doc.version, doc.sha)

    # ------------------------------------------------------- corpus facade --

    @property
    def name(self):
        return self.corpus.name

    @property
    def docs(self):
        return self.corpus.docs

    @property
    def tables(self):
        return self.corpus.tables

    @property
    def attr_specs(self):
        return self.corpus.attr_specs

    @property
    def domain_of_table(self):
        return self.corpus.domain_of_table

    def attr_description(self, table: str, attr: str) -> str:
        return self.corpus.attr_description(table, attr)

    def spec(self, domain: str, attr: str):
        return self.corpus.spec(domain, attr)

    def truth_rows(self, table: str) -> dict:
        return self.corpus.truth_rows(table)

    @property
    def seq(self) -> int:
        """Current mutation-log sequence (0 = untouched seed snapshot)."""
        return self.log.seq

    def subscribe(self, listener) -> None:
        """listener(record, old_doc, new_doc) — called after each mutation
        has been applied, in subscription order (the incremental index
        subscribes before the invalidation cascade)."""
        self._listeners.append(listener)

    def snapshot(self) -> Corpus:
        """Deep-enough copy of the current state for the rebuild-from-
        scratch parity oracle: later live mutations never leak into it."""
        docs = {d: Document(doc.doc_id, doc.domain, doc.text,
                            dict(doc.truth), dict(doc.spans), doc.tokens,
                            version=doc.version, sha=doc.sha)
                for d, doc in self.corpus.docs.items()}
        return Corpus(self.corpus.name, docs,
                      {t: list(ids) for t, ids in self.corpus.tables.items()},
                      self.corpus.attr_specs, self.corpus.domain_of_table)

    # ----------------------------------------------------------- mutations --

    def _domain_specs(self, domain: str) -> dict:
        out: dict = {}
        for t, d in self.corpus.domain_of_table.items():
            if d == domain:
                out.update(self.corpus.attr_specs.get(t, {}))
        return out

    def _derive_truth_spans(self, domain: str, text: str):
        """Re-derive (truth, spans) from text the way the generators plant
        them: value = pattern parse over the full text, span = the first
        sentence the pattern matches within."""
        truth, spans = {}, {}
        sents = split_sentences(text)
        for attr, spec in self._domain_specs(domain).items():
            truth[attr] = spec.parse(text)
            if truth[attr] is None:
                continue
            for s in sents:
                if re.search(spec.pattern, s):
                    spans[attr] = s
                    break
        return truth, spans

    def _notify(self, rec: MutationRecord, old_doc, new_doc) -> None:
        for fn in self._listeners:
            fn(rec, old_doc, new_doc)

    def ingest(self, doc_or_id, text: str = None, domain: str = None, *,
               truth: dict = None, spans: dict = None) -> MutationRecord:
        """Add a new document: `ingest(Document)` or
        `ingest(doc_id, text, domain)`. The new doc joins every table's
        candidate pool (corpus convention: table membership is discovered
        by the index, never given)."""
        if isinstance(doc_or_id, Document):
            doc = doc_or_id
            doc_id, text, domain = doc.doc_id, doc.text, doc.domain
            truth = truth if truth is not None else (doc.truth or None)
            spans = spans if spans is not None else (doc.spans or None)
        else:
            doc_id = doc_or_id
        if doc_id in self.corpus.docs:
            raise KeyError(f"{doc_id!r} already exists (use update)")
        if truth is None or spans is None:
            d_truth, d_spans = self._derive_truth_spans(domain, text)
            truth = d_truth if truth is None else truth
            spans = d_spans if spans is None else spans
        doc = Document(doc_id, domain, text, dict(truth), dict(spans),
                       count_tokens(text), version=1, sha=sha_text(text))
        self.corpus.docs[doc_id] = doc
        for pool in self.corpus.tables.values():
            if doc_id not in pool:
                pool.append(doc_id)
        self.stats.mutations += 1
        self.stats.ingests += 1
        self.stats.ingested_bytes += _utf8_len(text)
        self.stats.edited_bytes += _utf8_len(text)
        rec = self.log.append("ingest", doc_id, 1, doc.sha,
                              n_bytes=_utf8_len(text), domain=domain,
                              text=text)
        self._notify(rec, None, doc)
        return rec

    def update(self, doc_id, text: str, *, truth: dict = None,
               spans: dict = None) -> MutationRecord:
        """Replace a document's text; version bumps, sha/tokens/truth/spans
        follow the new content."""
        old = self.corpus.docs.get(doc_id)
        if old is None:
            raise KeyError(f"{doc_id!r} not in corpus (use ingest)")
        if truth is None or spans is None:
            d_truth, d_spans = self._derive_truth_spans(old.domain, text)
            truth = d_truth if truth is None else truth
            spans = d_spans if spans is None else spans
        old_doc = Document(old.doc_id, old.domain, old.text, dict(old.truth),
                           dict(old.spans), old.tokens, version=old.version,
                           sha=old.sha)
        edit = edit_span_bytes(old.text, text)
        old.text = text
        old.truth = dict(truth)
        old.spans = dict(spans)
        old.tokens = count_tokens(text)
        old.version += 1
        old.sha = sha_text(text)
        self.stats.mutations += 1
        self.stats.updates += 1
        self.stats.edited_bytes += edit
        rec = self.log.append("update", doc_id, old.version, old.sha,
                              n_bytes=_utf8_len(text), domain=old.domain,
                              text=text)
        self._notify(rec, old_doc, old)
        return rec

    def delete(self, doc_id) -> MutationRecord:
        """Remove a document from the corpus and every candidate pool."""
        old = self.corpus.docs.pop(doc_id, None)
        if old is None:
            raise KeyError(f"{doc_id!r} not in corpus")
        for pool in self.corpus.tables.values():
            if doc_id in pool:
                pool.remove(doc_id)
        self.stats.mutations += 1
        self.stats.deletes += 1
        self.stats.deleted_bytes += _utf8_len(old.text)
        rec = self.log.append("delete", doc_id, old.version, "",
                              n_bytes=0, domain=old.domain)
        self._notify(rec, old, None)
        return rec
