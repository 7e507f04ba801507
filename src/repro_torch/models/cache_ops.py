"""Decode-cache surgery for the two KV layouts (counterpart of
`repro.models.cache_ops`).

Slab half: the engine keeps one batched slab decode cache (k/v (L, B,
max_len, Hkv, D), `model.init_decode_cache`); a request prefills into a
B=1 sub-cache that `write_slot` merges into its slot. The shared-prefix
cache stores *trimmed* B=1 sub-caches (`prefix_snapshot`: the token axis
cut to the prefix length, so a snapshot costs O(prefix)), which
`expand_snapshot` zero-pads back to max_len on a hit. Attention in decode
is gated by pos, so the zero tail is never attended. Pure-state entries
(Mamba1's conv window and scan state) are kept whole: they are the exact
state after the prefix, which is why a snapshot is taken by prefilling
exactly the prefix. These copy where the
JAX functions return new arrays, so a snapshot never aliases a cache the
model later writes into in place.

Paged half: vLLM-style block layout: the length-indexed KV buffers live in
a shared pool of fixed-size pages; a sequence is a *page table* (block
index -> physical page id). Page 0 is the sink: dead batch rows write into
it, it is never allocated and its contents are never used. Copy-on-write
of a prefix entry's boundary page (`PageAllocator.copy_page`) and
speculative rollback (`truncate_pages`, `release_trailing_pages`) work in
place on the pools.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device

from .config import ModelConfig
from .model import init_decode_cache

PAGE_SINK = 0  # reserved page id: write target for dead rows, never read

# Buffers indexed by token position; the dense family keeps "k" and "v".
# Every other cache entry (Mamba1's "conv" and "ssm") is per-slot state,
# copied whole.
LENGTH_KEYS = ("k", "v")


class PagePoolExhausted(RuntimeError):
    """The fixed page pool has no free page left."""


def cache_nbytes(tree: dict) -> int:
    """Device bytes held by a dict of tensors (for byte accounting)."""
    return sum(t.numel() * t.element_size()
               for t in tree.values() if torch.is_tensor(t))


def slot_cache(cache: dict, slot: int) -> dict:
    """One slot of a batched slab cache as a B=1 sub-cache (a copy)."""
    sub = {}
    for k, a in cache.items():
        if k == "pos":
            sub[k] = a[slot].clone() if a.ndim else a.clone()
        else:
            sub[k] = a[:, slot:slot + 1].clone()
    return sub


def write_slot(cache: dict, sub: dict, slot: int) -> dict:
    """Merge a B=1 sub-cache into `slot` of a batched slab cache, in place.
    The cache's pos is (B,) (the engine's) or 0-d; the sub-cache's is 0-d."""
    for k in cache:
        if k == "pos":
            pos = cache["pos"]
            if pos.ndim:
                pos[slot] = torch.as_tensor(sub["pos"], dtype=pos.dtype, device=pos.device)
            else:
                cache["pos"] = torch.as_tensor(sub["pos"], dtype=pos.dtype,
                                               device=pos.device).clone()
        else:
            cache[k][:, slot] = sub[k][:, 0].to(cache[k].dtype)
    return cache


def prefix_snapshot(sub: dict, prefix_len: int) -> dict:
    """Trim a B=1 sub-cache (taken right after prefilling exactly the
    prefix) to O(prefix_len) storage: pos a 0-d int32 of prefix_len, the
    token axis cut to prefix_len (copied)."""
    snap = {}
    for k, a in sub.items():
        if k == "pos":
            snap[k] = torch.tensor(prefix_len, dtype=torch.int32, device=a.device)
        elif k in LENGTH_KEYS:
            snap[k] = a[:, :, :prefix_len].clone()
        else:
            snap[k] = a.clone()
    return snap


def expand_snapshot(snap: dict, max_len: int) -> dict:
    """Zero-pad a trimmed snapshot's token axis back to `max_len` so it is
    shape-compatible with the engine's slab cache (new tensors: the
    snapshot stays as it was)."""
    sub = {}
    for k, a in snap.items():
        if k in LENGTH_KEYS and a.shape[2] < max_len:
            out = a.new_zeros(a.shape[:2] + (max_len,) + a.shape[3:])
            out[:, :, :a.shape[2]] = a
            sub[k] = out
        else:
            sub[k] = a.clone()
    return sub


class PageAllocator:
    """Fixed-size KV page pool: free-list allocation + ref-counting.

    Owns the device pools -- one tensor per length-indexed cache key, shaped
    (num_layers, num_pages, page_size, n_kv_heads, head_dim) in cfg.dtype;
    none for Mamba1, whose state is not indexed by position -- and the
    host-side page metadata.
    """

    def __init__(self, cfg: ModelConfig, num_pages: int, page_size: int, *,
                 device=None):
        assert num_pages >= 2, "need at least the sink plus one real page"
        dev = resolve_device(device)
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        template = init_decode_cache(cfg, 1, self.page_size, device=dev)
        self.pools = {}
        for key in LENGTH_KEYS:
            if key in template:
                a = template[key]               # (L, 1, page_size, Hkv, D)
                self.pools[key] = torch.zeros((a.shape[0], self.num_pages) + a.shape[2:],
                                              dtype=a.dtype, device=dev)
        self.refcount = [0] * self.num_pages
        self._free = list(range(self.num_pages - 1, 0, -1))  # sink excluded

    # ------------------------------------------------------------ queries --

    @property
    def page_nbytes(self) -> int:
        """Device bytes of one page across every pooled buffer."""
        return sum(a[:, 0].numel() * a.element_size() for a in self.pools.values())

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - 1 - len(self._free)

    @property
    def nbytes_in_use(self) -> int:
        return self.used_pages * self.page_nbytes

    # --------------------------------------------------------- allocation --

    def alloc(self, n: int) -> list:
        """Allocate `n` pages (refcount 1 each). All-or-nothing: raises
        PagePoolExhausted without allocating anything if fewer are free."""
        if n > len(self._free):
            raise PagePoolExhausted(
                f"need {n} pages, {len(self._free)} free "
                f"(pool={self.num_pages}, page_size={self.page_size})")
        ids = [self._free.pop() for _ in range(n)]
        for i in ids:
            self.refcount[i] = 1
        return ids

    def retain(self, ids) -> None:
        """Add a reference to already-live pages (prefix sharing)."""
        for i in ids:
            if self.refcount[i] <= 0:
                raise RuntimeError(f"retain of free page {i}")
            self.refcount[i] += 1

    def release(self, ids) -> None:
        """Drop a reference; a page returns to the free list at zero.
        Releasing an already-free page is a hard error (double free)."""
        for i in ids:
            if self.refcount[i] <= 0:
                raise RuntimeError(f"double free of page {i}")
            self.refcount[i] -= 1
            if self.refcount[i] == 0:
                self._free.append(i)

    def copy_page(self, src: int) -> int:
        """Copy-on-write: allocate a fresh page holding `src`'s contents.
        The copy is made in place in the pools, for every layer and both
        `k` and `v` (the JAX package donates the pool buffer to the same
        end)."""
        (dst,) = self.alloc(1)
        for pool in self.pools.values():
            pool[:, dst].copy_(pool[:, src])
        return dst


def truncate_pages(pools: dict, page_ids: list, start: int, end: int,
                   page_size: int) -> None:
    """Page-truncate (speculative rollback): zero the KV at logical
    positions [start, end) of a sequence whose block table is `page_ids`.
    Positions past the allocation are skipped (they were written into the
    sink). Zeroing, rather than relying only on the position masks,
    restores the pool bit-exactly to its pre-speculation state, so shared
    and copy-on-write pages compare equal byte for byte. Works in place on
    the pools, for every layer and both `k` and `v`; all arguments are host
    values."""
    for b in range(start // page_size, -(-end // page_size)):
        if b >= len(page_ids):
            break
        lo = max(start - b * page_size, 0)
        hi = min(end - b * page_size, page_size)
        if lo >= hi:
            continue
        pid = int(page_ids[b])
        for pool in pools.values():
            pool[:, pid, lo:hi] = 0


def release_trailing_pages(alloc: PageAllocator, pages: list,
                           keep_blocks: int) -> list:
    """Ref-release (speculative rollback): drop the references a rejected
    suffix held past the kept block high-water mark. Returns the trimmed
    page table; the released pages return to the allocator's free list at
    refcount zero."""
    keep_blocks = max(0, int(keep_blocks))
    if keep_blocks >= len(pages):
        return pages
    alloc.release(pages[keep_blocks:])
    return pages[:keep_blocks]
