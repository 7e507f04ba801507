"""Oracle LLM extractor with a calibrated context-length noise model.

Used for the paper-table experiments: extraction correctness is a controlled
function of (a) whether the retrieved segments actually contain the value
(retrieval quality — QUEST's variable under test) and (b) context length
(longer prompts -> higher error rate, reproducing the paper's observation
that full-document feeding misleads the LLM on long docs, e.g. Lotus' F1
collapse on LCR). Token accounting is exact.

Error model, per (doc, attr) deterministic:
  present value : miss/corrupt with p = P_MISS + P_CONFUSE * max(0, T - T0)/SCALE
  absent value  : hallucinate with p = P_HALL * min(1, T / SCALE)
where T = prompt tokens.
"""
from __future__ import annotations

import hashlib
import random

from repro_torch.data.tokens import count_tokens

P_MISS = 0.02
P_CONFUSE = 0.18
P_HALL = 0.10
T0 = 600
SCALE = 4000.0


def _doc_rng(doc_id, attr: str, salt: str = "") -> random.Random:
    h = hashlib.blake2b(f"{doc_id}|{attr}|{salt}".encode(), digest_size=8).digest()
    return random.Random(int.from_bytes(h, "little"))


class OracleExtractor:
    # accepts the scheduler's owners= protocol extension (a no-op here:
    # the oracle has no admission tier to route tenants into) so oracle
    # and served paths run under identical scheduler call shapes
    accepts_owners = True

    def __init__(self, corpus, *, noisy: bool = True):
        self.corpus = corpus
        self.noisy = noisy

    # -- helpers ------------------------------------------------------------

    def _spec_for(self, attr: str):
        for table, attrs in self.corpus.attr_specs.items():
            if attr in attrs:
                return attrs[attr]
        return None

    def _fabricate(self, attr: str, rng: random.Random):
        spec = self._spec_for(attr)
        if spec is None:
            return None
        if spec.kind == "int":
            return rng.randint(1, 40)
        if spec.kind == "float":
            return round(rng.uniform(1.0, 40.0), 1)
        return rng.choice(["Example Value", "Unknown Entity", "Riverton Комета"])[:20]

    def _error_rates(self, tokens: int):
        p_err = P_MISS + P_CONFUSE * max(0, tokens - T0) / SCALE
        p_hall = P_HALL * min(1.0, tokens / SCALE)
        return min(p_err, 0.5), min(p_hall, 0.3)

    # -- protocol -----------------------------------------------------------

    def extract(self, doc_id, attr: str, segments: list[str]):
        """Returns (value_or_None, input_tokens)."""
        text = " ".join(segments)
        tokens = count_tokens(text)
        doc = self.corpus.docs[doc_id]
        spec = self.corpus.spec(doc.domain, attr) or self._spec_for(attr)
        value = spec.parse(text) if (spec and text) else None
        if not self.noisy:
            return value, tokens
        rng = _doc_rng(doc_id, attr)
        p_err, p_hall = self._error_rates(tokens)
        if value is not None:
            if rng.random() < p_err:
                value = None if rng.random() < 0.7 else self._fabricate(attr, rng)
        else:
            if text and rng.random() < p_hall:
                value = self._fabricate(attr, rng)
        return value, tokens

    def extract_batch(self, items: list, owners: list = None):
        """Batched protocol: items = [(doc_id, attr, segments)], returns
        [(value, input_tokens)]. The oracle is deterministic per (doc, attr),
        so batching cannot change values or accounting — the property the
        batched-execution equivalence tests lean on."""
        return [self.extract(doc_id, attr, segments)
                for doc_id, attr, segments in items]

    def extract_full_doc_batch(self, items: list, owners: list = None):
        """items = [(doc_id, attrs)] -> [(values, segs_by_attr, tokens)]."""
        return [self.extract_full_doc(doc_id, attrs) for doc_id, attrs in items]

    def extract_full_doc(self, doc_id, attrs: list[str]):
        """Sampling-phase call: whole document in, values + source segments
        out. Returns (values dict, segments-by-attr dict, input_tokens)."""
        doc = self.corpus.docs[doc_id]
        tokens = doc.tokens or count_tokens(doc.text)
        values, segs = {}, {}
        for attr in attrs:
            spec = self.corpus.spec(doc.domain, attr)
            v = spec.parse(doc.text) if spec else None
            if self.noisy:
                rng = _doc_rng(doc_id, attr, salt="full")
                p_err, p_hall = self._error_rates(tokens)
                if v is not None and rng.random() < p_err:
                    v = None
                elif v is None and rng.random() < p_hall * 0.5:
                    v = self._fabricate(attr, rng)
            values[attr] = v
            if v is not None and attr in doc.spans:
                segs[attr] = [doc.spans[attr]]
        return values, segs, tokens
