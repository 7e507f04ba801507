"""Paged KV pool: page allocation and byte accounting (counterpart of the
paged half of `repro.models.cache_ops`).

vLLM-style block layout: the length-indexed KV buffers live in a shared
pool of fixed-size pages; a sequence is a *page table* (block index ->
physical page id). Page 0 is the sink: dead batch rows write into it, it is
never allocated and its contents are never used. The prefix-cache half of
the JAX module (snapshots, copy-on-write, rollback) is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device

from .config import ModelConfig
from .model import torch_dtype

PAGE_SINK = 0  # reserved page id: write target for dead rows, never read

# Buffers indexed by token position; the dense family keeps "k" and "v".
LENGTH_KEYS = ("k", "v")


class PagePoolExhausted(RuntimeError):
    """The fixed page pool has no free page left."""


def cache_nbytes(tree: dict) -> int:
    """Device bytes held by a dict of tensors (for byte accounting)."""
    return sum(t.numel() * t.element_size()
               for t in tree.values() if torch.is_tensor(t))


class PageAllocator:
    """Fixed-size KV page pool: free-list allocation + ref-counting.

    Owns the device pools -- one tensor per length-indexed cache key, shaped
    (num_layers, num_pages, page_size, n_kv_heads, head_dim) in cfg.dtype --
    and the host-side page metadata.
    """

    def __init__(self, cfg: ModelConfig, num_pages: int, page_size: int, *,
                 device=None):
        assert num_pages >= 2, "need at least the sink plus one real page"
        if cfg.family != "dense" or cfg.use_mla:
            raise NotImplementedError(
                f"paged KV for family {cfg.family!r} is not yet ported, see "
                f"ROADMAP.md Queue 1")
        dev = resolve_device(device)
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        shape = (cfg.num_layers, self.num_pages, self.page_size,
                 cfg.n_kv_heads, cfg.resolved_head_dim)
        self.pools = {k: torch.zeros(shape, dtype=torch_dtype(cfg.dtype), device=dev)
                      for k in LENGTH_KEYS}
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
