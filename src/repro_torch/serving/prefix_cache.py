"""Shared-prefix KV cache: longest-prefix-match store over prompt tokens
(DESIGN.md §10). Invariant: a hit changes prefill work, never decoded
output — results are byte-identical with the cache on or off.

QUEST plans issue hundreds of extraction calls whose prompts share a long
template prefix (instruction + attribute description + evidence header) and
differ only in the per-document tail (`extract/served.py` orders prompts
that way on purpose). Each stored entry maps a token prefix to the B=1
decode-cache snapshot obtained by prefilling *exactly* that prefix
(`models.cache_ops.prefix_snapshot`): attention KV sliced to the prefix,
SSM/conv state taken at the prefix boundary — so a hit is state-correct for
every model family, not just attention.

Entries live at explicit boundaries (`Request.shared_len`), so the store is
a radix-style trie whose every path is a single compressed edge:
`match(prompt)` returns the deepest stored node whose token path is a
*proper* prefix of the prompt (proper, because at least one suffix token
must be prefilled to produce the first-output logits). Lookup scans the
(small, LRU-bounded) entry table and compares token runs — O(entries ×
prefix) integer comparisons, cheap next to a single prefill step.

Eviction is LRU over both knobs: `max_entries` and, when set, `max_bytes`
of snapshot storage (`cache_ops.cache_nbytes`).

One instance may be shared by several engine replicas (`serving/
replicas.py`, DESIGN.md §15): entries are immutable after insert, hits only
touch LRU order, and in the paged layout entry pages are ref-counted in the
replicas' *shared* PageAllocator — so an eviction triggered by one replica
can never free a page another replica's live slot still references, and a
prefix prefilled by one replica splices O(1) into every other. Sharing is
single-threaded by construction: `ReplicaGroup` interleaves replica steps
on one host thread (the async tier of ROADMAP item 2 adds locking, not new
semantics).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.models.cache_ops import cache_nbytes


@dataclass
class PrefixEntry:
    tokens: tuple                 # the prefix token path
    cache: dict                   # trimmed B=1 snapshot (see cache_ops); in
    #                               the paged layout, the pure-state part only
    nbytes: int
    hits: int = 0
    # Paged layout (DESIGN.md §12): the prefix KV lives in the engine's page
    # pool, referenced rather than copied. `pages` are the completely-filled
    # pages (shared by reference with every slot that hits), `tail_page` the
    # partially-filled boundary page (copy-on-write on hit). `release` drops
    # the entry's page references; the store calls it exactly once when the
    # entry is evicted or cleared.
    pages: tuple = ()
    tail_page: Optional[int] = None
    release: Optional[Callable[[], None]] = None
    # Live-corpus provenance (DESIGN.md §17): doc_ids whose text is embedded
    # in this prefix. A mutation to any of them invalidates the entry via
    # `invalidate_docs`; template-only prefixes carry () and survive.
    doc_ids: tuple = ()

    def _drop(self) -> None:
        if self.release is not None:
            rel, self.release = self.release, None
            rel()


@dataclass
class PrefixCacheStats:
    hits: int = 0
    misses: int = 0
    inserts: int = 0
    evictions: int = 0
    saved_tokens: int = 0         # prefill tokens skipped via hits
    invalidated_entries: int = 0  # dropped by live-corpus doc invalidation

    def snapshot(self) -> dict:
        return dict(self.__dict__)


class PrefixCache:
    def __init__(self, *, max_entries: int = 32,
                 max_bytes: Optional[int] = None):
        self.max_entries = max(1, int(max_entries))
        self.max_bytes = max_bytes
        self.stats = PrefixCacheStats()
        self._entries: "OrderedDict[tuple, PrefixEntry]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def nbytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    # ------------------------------------------------------------ lookup --

    def match(self, prompt: list) -> Optional[PrefixEntry]:
        """Deepest entry whose path is a proper prefix of `prompt`."""
        best = None
        n = len(prompt)
        for key, entry in self._entries.items():
            k = len(key)
            if k < n and (best is None or k > len(best.tokens)) \
                    and tuple(prompt[:k]) == key:
                best = entry
        if best is None:
            self.stats.misses += 1
            return None
        self._entries.move_to_end(best.tokens)       # LRU touch
        best.hits += 1
        self.stats.hits += 1
        self.stats.saved_tokens += len(best.tokens)
        return best

    # ------------------------------------------------------------ insert --

    def insert(self, prefix: list, snapshot: dict, *, pages=(),
               tail_page: Optional[int] = None, nbytes: Optional[int] = None,
               release: Optional[Callable[[], None]] = None,
               doc_ids=()) -> PrefixEntry:
        key = tuple(prefix)
        if key in self._entries:                     # refresh, don't duplicate
            if release is not None:                  # drop the redundant copy
                release()
            self._entries.move_to_end(key)
            return self._entries[key]
        entry = PrefixEntry(
            tokens=key, cache=snapshot,
            nbytes=cache_nbytes(snapshot) if nbytes is None else int(nbytes),
            pages=tuple(pages), tail_page=tail_page, release=release,
            doc_ids=tuple(doc_ids))
        self._entries[key] = entry
        self.stats.inserts += 1
        self._evict()
        return entry

    def invalidate_docs(self, doc_ids) -> int:
        """Drop every entry whose prefix embeds one of `doc_ids` (live-
        corpus mutation, DESIGN.md §17). Page references release through
        the entries' `release` callbacks exactly as on eviction, so paged
        entries return their pages to the allocator. Returns entries
        dropped."""
        targets = set(doc_ids)
        stale = [k for k, e in self._entries.items()
                 if targets.intersection(e.doc_ids)]
        for k in stale:
            self._entries.pop(k)._drop()
        self.stats.invalidated_entries += len(stale)
        return len(stale)

    def _evict(self) -> None:
        while len(self._entries) > self.max_entries or (
                self.max_bytes is not None and self.nbytes > self.max_bytes
                and len(self._entries) > 1):
            _, entry = self._entries.popitem(last=False)
            entry._drop()
            self.stats.evictions += 1

    def pop_lru(self) -> Optional[PrefixEntry]:
        """Force-evict the least-recently-used entry (page-pool pressure);
        returns it (references already released) or None when empty."""
        if not self._entries:
            return None
        _, entry = self._entries.popitem(last=False)
        entry._drop()
        self.stats.evictions += 1
        return entry

    def clear(self) -> None:
        for entry in self._entries.values():
            entry._drop()
        self._entries.clear()
