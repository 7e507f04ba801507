"""Semantic segmentation (paper §4.1, SemanticChunker-equivalent).

Split into sentences, then greedily merge consecutive sentences while their
embeddings stay similar (cosine of L2-normalized embeddings <=> L2 distance),
bounded by a max segment token budget so each attribute fits one segment.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.data.tokens import count_tokens, split_sentences


@dataclass
class Segment:
    doc_id: object
    seg_id: int
    text: str
    tokens: int


def segment_document(doc_id, text: str, embedder, *, sim_threshold: float = 0.55,
                     max_tokens: int = 120) -> list[Segment]:
    sents = split_sentences(text)
    if not sents:
        return [Segment(doc_id, 0, text, count_tokens(text))]
    embs = embedder.embed(sents)
    segs: list[list[int]] = [[0]]
    for i in range(1, len(sents)):
        cur = segs[-1]
        sim = float(np.dot(embs[i], embs[i - 1]))
        cur_tokens = sum(count_tokens(sents[j]) for j in cur)
        if sim >= sim_threshold and cur_tokens + count_tokens(sents[i]) <= max_tokens:
            cur.append(i)
        else:
            segs.append([i])
    out = []
    for si, idxs in enumerate(segs):
        t = " ".join(sents[j] for j in idxs)
        out.append(Segment(doc_id, si, t, count_tokens(t)))
    return out


def key_sentences(text: str, max_sentences: int = 8) -> str:
    """Cheap extractive summary for the document-level index (NLTK stand-in):
    lead sentences + sentences dense in entities/numbers (attribute
    carriers), which is what makes a document's *subject* identifiable."""
    sents = split_sentences(text)
    if len(sents) <= max_sentences:
        return " ".join(sents)
    lead = sents[:2]

    def score(s: str) -> float:
        toks = s.split()
        if not toks:
            return 0.0
        carriers = sum(1 for i, t in enumerate(toks)
                       if any(c.isdigit() for c in t) or (i > 0 and t[:1].isupper()))
        return carriers / len(toks)

    rest = sorted(sents[2:], key=score, reverse=True)[: max_sentences - 2]
    return " ".join(lead + rest)
