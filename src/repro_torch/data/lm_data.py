"""LM training data pipeline: byte-level tokenizer + deterministic,
checkpointable batch iterator over a document corpus.

The cursor (epoch, offset, rng key) is part of the training checkpoint so a
restarted job consumes exactly the batches it would have (bit-exact resume).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BOS, EOS, PAD = 256, 257, 258
VOCAB = 260  # byte values + specials (models with larger vocabs just ignore the tail)


def encode(text: str) -> list[int]:
    return list(text.encode("utf-8", errors="replace"))


def decode(ids) -> str:
    return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")


def corpus_token_stream(corpus) -> np.ndarray:
    parts = []
    for doc_id in sorted(corpus.docs):
        parts.append([BOS] + encode(corpus.docs[doc_id].text) + [EOS])
    flat = [t for p in parts for t in p]
    return np.asarray(flat, np.int32)


@dataclass
class DataState:
    offset: int = 0
    epoch: int = 0


class LMBatches:
    """Sequential batcher: (tokens, labels) of shape (B, S)."""

    def __init__(self, stream: np.ndarray, batch: int, seq: int):
        self.stream = stream
        self.batch = batch
        self.seq = seq
        self.state = DataState()

    def next(self) -> dict:
        need = self.batch * (self.seq + 1)
        n = len(self.stream)
        out = np.empty((need,), np.int32)
        off = self.state.offset
        got = 0
        while got < need:
            take = min(need - got, n - off)
            out[got:got + take] = self.stream[off:off + take]
            got += take
            off += take
            if off >= n:
                off = 0
                self.state.epoch += 1
        self.state.offset = off
        x = out.reshape(self.batch, self.seq + 1)
        return {"tokens": x[:, :-1].copy(), "labels": x[:, 1:].copy()}

    def snapshot(self) -> dict:
        return {"offset": self.state.offset, "epoch": self.state.epoch}

    def restore(self, snap: dict):
        self.state = DataState(snap["offset"], snap["epoch"])
