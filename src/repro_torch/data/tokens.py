"""Deterministic whitespace/punctuation tokenizer + token counting.

All cost accounting (paper metric: tokens/doc) flows through `count_tokens`
so QUEST, baselines and the serving cost model agree on the unit.
"""
from __future__ import annotations

import re

_TOKEN_RE = re.compile(r"[A-Za-z]+|\d+|[^\sA-Za-z\d]")


def tokenize(text: str) -> list[str]:
    return _TOKEN_RE.findall(text)


def count_tokens(text: str) -> int:
    return len(_TOKEN_RE.findall(text))


_WORD_RE = re.compile(r"[A-Za-z]+|\d+")


def words(text: str) -> list[str]:
    return [w.lower() for w in _WORD_RE.findall(text)]


_SENT_RE = re.compile(r"(?<=[.!?])\s+")


def split_sentences(text: str) -> list[str]:
    parts = [s.strip() for s in _SENT_RE.split(text)]
    return [s for s in parts if s]
