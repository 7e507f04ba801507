"""Decode-cache surgery for the two KV layouts (counterpart of
`repro.models.cache_ops`).

Slab half: the engine keeps one batched slab decode cache (k/v (L, B,
max_len, Hkv, D), or MLA's ckv/krope (L, B, max_len, r / rd),
`model.init_decode_cache`); a request prefills into a
B=1 sub-cache that `write_slot` merges into its slot. The shared-prefix
cache stores *trimmed* B=1 sub-caches (`prefix_snapshot`: the token axis
cut to the prefix length, so a snapshot costs O(prefix)), which
`expand_snapshot` zero-pads back to max_len on a hit. Attention in decode
is gated by pos, so the zero tail is never attended. Pure-state entries
(Mamba1's and Mamba2's conv window and scan state) are kept whole: they are the exact
state after the prefix, which is why a snapshot is taken by prefilling
exactly the prefix. These copy where the
JAX functions return new arrays, so a snapshot never aliases a cache the
model later writes into in place.

Paged half: vLLM-style block layout: the length-indexed KV buffers live in
a shared pool of fixed-size pages; a sequence is a *page table* (block
index -> physical page id). Page 0 is the sink, never allocated: a dead
row's table is all sink, and a live row's table is sink past its pages.
The sink is read -- a dead row attends it, and so does a padded position
past a row's pages -- and what it reads matters wherever rows interact or
a row's state outlives the call: with MoE a dead row's tokens compete for
expert capacity, and in the hybrid family a dead slot's Mamba2 state is
kept. So the sink holds what the JAX engine's holds. The JAX engine
gathers each row's view through its table (the sink as it was before the
call, plus the row's own new tokens) and scatters whole blocks back, the
last (row, block) in row-major order winning the sink. MLA does exactly
that (`layers.write_view_blocks`); the dense paged path, whose kernels
read the pool itself, gets the same from `sink_plan`: each sink block a
row writes becomes a private scratch page past the allocatable ones,
seeded from the sink before the call (`seed_scratch`), and the winning
block is copied into the sink after it (`sink_take`). Copy-on-write of a
prefix entry's boundary page (`PageAllocator.copy_page`) and speculative
rollback (`truncate_pages`, `release_trailing_pages`) work in place on the
pools.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

from .config import ModelConfig
from .model import init_decode_cache

PAGE_SINK = 0  # reserved page id, never allocated: dead rows' tables and blocks past a table

# Buffers indexed by token position: the dense family's "k" and "v", MLA's
# compressed "ckv" and "krope". Every other cache entry (the Mamba blocks'
# "conv" and "ssm", the encdec family's cross K/V "ck" and "cv") is
# per-slot state, copied whole.
LENGTH_KEYS = ("k", "v", "ckv", "krope")


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
    (num_layers, num_pages + scratch, page_size, n_kv_heads, head_dim) in
    cfg.dtype (the hybrid family: one layer per shared-block application),
    or (num_layers, num_pages, page_size, r / rd) for MLA's ckv/krope;
    none for Mamba1, whose state is not indexed by position -- and the
    host-side page metadata. The scratch pages past num_pages are the dense
    paged path's (`sink_plan`): never allocated, never counted in the page
    or byte counts, their contents never compared. MLA's page views are
    gathered and written back in `layers` (`page_view`,
    `write_view_blocks`).
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

    @property
    def scratch(self) -> list:
        """Ids of the scratch pages past the allocatable ones (`sink_plan`):
        never allocated, never counted, their contents never compared."""
        width = next(iter(self.pools.values())).shape[1] if self.pools else self.num_pages
        return list(range(self.num_pages, width))

    def reserve_scratch(self, n: int) -> None:
        """Make the pools hold at least n scratch pages (each engine on this
        allocator reserves what its calls need when it is made, before any
        call)."""
        have = len(self.scratch)
        if not self.pools or n <= have:
            return
        for key, pool in self.pools.items():
            self.pools[key] = torch.cat(
                [pool, pool.new_zeros((pool.shape[0], n - have) + pool.shape[2:])], dim=1)

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
        The copy is made in place in the pools, for every layer and every
        pooled key (the JAX package donates the pool buffer to the same
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
    the pools, for every layer and every pooled key; all arguments are
    host values."""
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


def sink_plan(table, wpos, wblocks, page_size: int, scratch: list):
    """Make a dense paged call write and read the sink as the JAX engine's
    gathered views do (host values throughout).

    table (B, n) page ids (PAGE_SINK past each row's pages; all sink for a
    dead row); wpos (B, W) the positions each row writes, into its view of
    n * page_size positions (the JAX package drops a write at or past it);
    wblocks (B, m) the view blocks the JAX engine scatters back for each
    row, in order; scratch the allocator's scratch page ids, the last one
    taken as the trash page for dropped writes.

    Every sink block a row writes gets a scratch page of its own in the
    returned table, so the row reads the sink as it was before the call
    except where it wrote, and no two rows write one page. Returns (table
    (B, n), write pages (B, W): the page each position is written to, the
    trash page where JAX drops the write; the scratch pages to seed from
    the sink before the call (`seed_scratch`); and the page whose block the
    sink takes after it (`sink_take`): the last (row, block) of wblocks
    that maps to the sink, in row-major order -- a scratch page if that row
    wrote the block, else PAGE_SINK, the sink left as it was)."""
    table = np.asarray(table)
    wpos = np.asarray(wpos, np.int64)
    B, n = table.shape
    view = n * page_size
    out = table.copy()
    free = iter(scratch[:-1])
    seeds = []
    for b in range(B):
        for blk in np.unique(wpos[b][wpos[b] < view] // page_size):
            if table[b, blk] == PAGE_SINK:
                out[b, blk] = next(free)
                seeds.append(int(out[b, blk]))
    blk = np.minimum(wpos // page_size, n - 1)
    wpages = np.where(wpos < view, np.take_along_axis(out, blk, 1), scratch[-1])
    winner = PAGE_SINK
    for b, j in zip(*np.nonzero(np.take_along_axis(table, np.asarray(wblocks), 1) == PAGE_SINK)):
        winner = int(out[b, wblocks[b][j]])
    return out, wpages.astype(np.int32), seeds, winner


def seed_scratch(pools: dict, ids: list) -> None:
    """Copy the sink page into scratch pages `ids`, in every layer and
    pooled key, in place."""
    if ids:
        for pool in pools.values():
            pool[:, ids] = pool[:, PAGE_SINK:PAGE_SINK + 1].clone()


def sink_take(pools: dict, src: int) -> None:
    """The sink takes page `src`'s block (nothing when src is the sink), in
    every layer and pooled key, in place."""
    if src != PAGE_SINK:
        for pool in pools.values():
            pool[:, PAGE_SINK] = pool[:, src]
