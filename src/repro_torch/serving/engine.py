"""Batched serving engine with continuous batching on a paged KV pool
(counterpart of `repro.serving.engine`, paged layout).

Length-indexed KV lives in a fixed pool of `page_size`-token pages
(`models.cache_ops.PageAllocator`); each slot is a page table. Prompts
prefill in fixed-size chunks (`chunk_size` tokens per `prefill_chunk`
call, the last chunk right-padded with its true length carried along), and
live slots decode together in batched `decode_step`s. On the card both run
their attention on the pool itself -- kernel K2 for a chunk, kernel K1 for
a decode step -- where the JAX engine gathers the pages into dense views,
runs jnp attention and scatters the pages back; the engine's counters keep
the JAX formulas, so `stats` are identical between the two packages.

Requests, slots, the insert coroutines that interleave chunked prefill
with decode, `drain_slot` (bounded retries), `cancel`, `poll` and the
strict `run()` (`RunTruncated`) follow the JAX engine one for one. The
slab layout, the prefix KV cache, speculative decoding, mesh serving and
shared page allocators are not ported yet and raise NotImplementedError.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.data import lm_data
from repro_torch.device import resolve_device
from repro_torch.models import decode_step, prefill_chunk
from repro_torch.models.cache_ops import (PAGE_SINK, PageAllocator,
                                          PagePoolExhausted, cache_nbytes)
from repro_torch.models.config import ModelConfig
from repro_torch.obs import MetricsRegistry, StatsDict, as_tracer
from repro_torch.obs.metrics import ENGINE_STATS

_NOT_PORTED = "not yet ported, see ROADMAP.md Queue 1"


@dataclass
class Request:
    rid: int
    prompt: list
    max_new: int = 16
    eos_id: int = lm_data.EOS
    shared_len: int = 0      # prompt[:shared_len] is shareable across requests
    max_retries: int = 3     # drain_slot evictions tolerated before failing
    tenant: str = ""         # admission-control identity
    priority: int = 0        # admission priority class (higher first)
    out: list = field(default_factory=list)
    done: bool = False
    submitted_s: float = 0.0
    finished_s: float = 0.0
    retries: int = 0
    error: Optional[str] = None
    # speculative-decode economy (kept for field parity; spec is not ported)
    draft_tokens: int = 0
    accepted_tokens: int = 0
    # live-corpus provenance: doc_ids whose text the prompt embeds, and the
    # token offset where that content starts
    content_docs: tuple = ()
    content_start: Optional[int] = None


class RunTruncated(RuntimeError):
    """`run()` exhausted max_steps with requests still queued/active."""

    def __init__(self, msg: str, finished: dict):
        super().__init__(msg)
        self.finished = finished


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 256, queue_depth: Optional[int] = None, prefix_cache=False,
                 kv_layout: str = "paged",
                 page_size: int = 16, num_pages: Optional[int] = None,
                 chunk_size: int = 32, spec_decode="off", mesh=None,
                 page_allocator=None, tracer=None, metrics=None,
                 device=None):
        """queue_depth: optional admission-control bound on queued requests;
        ServedExtractor splits its batch rounds into windows of this size
        (None = unbounded).
        page_size: tokens per KV page (must divide max_len).
        num_pages: pool capacity (default (slots+4) tables' worth + sink).
        chunk_size: prompt tokens per chunked-prefill call.
        device: where the pool and the model run (None = the CUDA device);
        `params` must already live there.
        prefix_cache, kv_layout="slab", spec_decode, mesh and page_allocator
        are the JAX engine's options that are not ported yet."""
        if kv_layout != "paged":
            raise NotImplementedError(f"kv_layout={kv_layout!r} is {_NOT_PORTED}")
        if prefix_cache:
            raise NotImplementedError(f"prefix_cache is {_NOT_PORTED}")
        if spec_decode not in ("off", None, False):
            raise NotImplementedError(f"spec_decode={spec_decode!r} is {_NOT_PORTED}")
        if mesh is not None:
            raise NotImplementedError(f"mesh serving is {_NOT_PORTED}")
        if page_allocator is not None:
            raise NotImplementedError(f"a shared page_allocator is {_NOT_PORTED}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.queue_depth = queue_depth
        self.page_size = max(1, int(page_size))
        self.chunk_size = max(1, int(chunk_size))
        if cfg.family != "dense":
            raise NotImplementedError(f"family {cfg.family!r} is {_NOT_PORTED}")
        self.queue: deque = deque()
        self.active: dict = {}          # slot -> Request
        self.finished: dict = {}
        self.failed: dict = {}          # rid -> Request (retry cap exceeded)
        self.cancelled: dict = {}       # rid -> Request (cancel() resolved)
        self._inserting: dict = {}      # slot -> (Request, insert coroutine)
        self.tracer = as_tracer(tracer)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.stats = StatsDict(self.metrics, "engine", ENGINE_STATS)

        # per-slot state: the decode position, int32 as in the JAX engine
        # (its byte size enters kv_bytes_peak)
        self.cache = {"pos": torch.zeros((slots,), dtype=torch.int32,
                                         device=self.device)}
        self._live = np.zeros((slots,), bool)
        self._tokens = torch.zeros((slots, 1), dtype=torch.int64,
                                   device=self.device)

        if max_len % self.page_size:
            raise ValueError(
                f"max_len={max_len} must be a multiple of page_size={page_size}")
        self.pages_per_slot = max_len // self.page_size
        if num_pages is None:
            num_pages = (slots + 4) * self.pages_per_slot + 1
        self.alloc = PageAllocator(cfg, num_pages, self.page_size,
                                   device=self.device)
        self.slot_pages: list = [[] for _ in range(slots)]
        self._pos_h = np.zeros((slots,), np.int64)   # host mirror of pos

    # ------------------------------------------------------------ intake --

    def submit(self, req: Request):
        if self.queue_depth is not None and len(self.queue) >= self.queue_depth:
            raise RuntimeError(
                f"serving queue full ({len(self.queue)} >= {self.queue_depth})")
        req.submitted_s = time.time()
        self.queue.append(req)

    def submit_many(self, reqs):
        """All-or-nothing admission: never leaves a batch half-enqueued."""
        reqs = list(reqs)
        if self.queue_depth is not None and \
                len(self.queue) + len(reqs) > self.queue_depth:
            raise RuntimeError(
                f"serving queue full ({len(self.queue)} + {len(reqs)} > "
                f"{self.queue_depth})")
        for req in reqs:
            req.submitted_s = time.time()
            self.queue.append(req)

    # ------------------------------------------------------------ prefill --

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int32), device=self.device)

    def _chunked_prefill_co(self, slot: int, tokens: list):
        """Feed `tokens` through fixed-size prefill chunks, yielding between
        chunks so the caller can interleave decode of live slots with this
        insert's prefill. Every chunk is padded to `chunk_size` and carries
        its true length; its K/V goes straight into the slot's pages, and
        the context is read through a pow2-bucketed page-table row as wide
        as the JAX engine's gathered view, whose width the counters use.
        Returns (last-chunk logits, new logical position)."""
        cs, ps = self.chunk_size, self.page_size
        pages = self.slot_pages[slot]
        logits, lpos, n = None, 0, len(tokens)
        while lpos < n:
            if lpos:
                yield               # cooperative point between chunks
            true_clen = min(cs, n - lpos)
            # blocks the padded chunk can dirty, and the context they need
            nb = (cs + ps - 2) // ps + 1 if ps > 1 else cs
            n_ctx = _pow2_at_least(max(-(-(lpos + cs) // ps), nb))
            ctx = [pages[b] if b < len(pages) else PAGE_SINK
                   for b in range(n_ctx)]
            chunk = list(tokens[lpos:lpos + true_clen]) + [0] * (cs - true_clen)
            logits = prefill_chunk(
                self.cfg, self.params,
                torch.as_tensor([chunk], dtype=torch.int64, device=self.device),
                lpos, true_clen, self.alloc.pools, self._ids(ctx))
            self.stats["prefill_invocations"] += 1
            self.stats["prefill_chunks"] += 1
            self.stats["prefill_ctx_positions"] += cs * n_ctx * ps
            self.tracer.instant("engine.prefill_chunk", kind="engine",
                                level=2, tokens=int(true_clen))
            lpos += true_clen
        return logits, lpos

    def _free_slot_pages(self, slot: int):
        if self.slot_pages[slot]:
            self.alloc.release(self.slot_pages[slot])
            self.slot_pages[slot] = []

    def _page_table(self, width: int) -> torch.Tensor:
        """Page table truncated to the live rows' block high-water mark
        (pow2-bucketed by the caller): decode attends only the blocks
        actually in use instead of the full max_len."""
        tbl = np.full((self.slots, width), PAGE_SINK, np.int32)
        for s, pages in enumerate(self.slot_pages):
            if self._live[s]:
                tbl[s, :min(len(pages), width)] = pages[:width]
        return self._ids(tbl)

    def _insert_co(self, slot: int, req: Request):
        """Coroutine insert: run `req`'s chunked prefill into `slot`,
        yielding between chunks so `step()` can interleave decode of
        already-live slots with admission prefill. The slot goes live only
        on completion; mid-insert it is reserved via `self._inserting`.
        Pages are acquired all at once before the first yield
        (all-or-nothing: PagePoolExhausted raises out of the first advance
        with nothing held); from then on `slot_pages[slot]` owns every page
        ref, so abandoning the coroutine cleans up via `_free_slot_pages`."""
        plen = len(req.prompt)
        if plen > self.max_len:
            raise ValueError(f"prompt ({plen}) exceeds cache max_len={self.max_len}")
        # positions ever written: prompt + every fed generated token
        cap = min(plen + req.max_new, self.max_len)
        self.slot_pages[slot] = self.alloc.alloc(-(-cap // self.page_size))
        logits, lpos = yield from self._chunked_prefill_co(slot, req.prompt)
        self.stats["prefill_tokens"] += plen
        self.cache["pos"][slot] = lpos
        self._pos_h[slot] = lpos
        nxt = int(torch.argmax(logits[0, -1]))
        self._tokens[slot, 0] = nxt
        req.out.append(nxt)
        self.active[slot] = req
        self._live[slot] = True
        self._note_kv_bytes()

    def _note_kv_bytes(self):
        used = cache_nbytes(self.cache) + self.alloc.nbytes_in_use
        self.stats["kv_bytes_peak"] = max(self.stats["kv_bytes_peak"], used)

    # ------------------------------------------------------------- decode --

    def _finish(self, slot: int, req: Request):
        req.done = True
        req.finished_s = time.time()
        self.finished[req.rid] = req
        del self.active[slot]
        self._live[slot] = False
        self._free_slot_pages(slot)

    def _step(self):
        write_ids = np.full((self.slots,), PAGE_SINK, np.int32)
        maxb = 1
        for s in range(self.slots):
            if self._live[s]:
                maxb = max(maxb, len(self.slot_pages[s]))
                b = int(self._pos_h[s]) // self.page_size
                if b < len(self.slot_pages[s]):
                    write_ids[s] = self.slot_pages[s][b]
        width = min(_pow2_at_least(maxb), self.pages_per_slot)
        pos = self.cache["pos"]
        logits = decode_step(self.cfg, self.params, self._tokens, pos,
                             self.alloc.pools, self._page_table(width),
                             self._ids(write_ids))
        self.cache["pos"] = pos + 1
        self._pos_h += 1
        self.stats["decode_steps"] += 1
        self.stats["decode_slot_steps"] += len(self.active)
        self.stats["max_live"] = max(self.stats["max_live"], len(self.active))
        nxt = torch.argmax(logits[:, 0, :], dim=-1).cpu().numpy()
        for slot, req in list(self.active.items()):
            tok = int(nxt[slot])
            req.out.append(tok)
            full = int(self._pos_h[slot]) >= self.max_len - 1
            if tok == req.eos_id or len(req.out) >= req.max_new or full:
                self._finish(slot, req)
        self._tokens = torch.as_tensor(nxt[:, None], dtype=torch.int64,
                                       device=self.device)

    def drain_slot(self, slot: int):
        """Evict + requeue (straggler/failure mitigation). Retries are
        bounded: past `req.max_retries` the request fails visibly into
        `self.failed` instead of requeueing forever."""
        if slot in self.active:
            req = self.active.pop(slot)
            self._live[slot] = False
            self._free_slot_pages(slot)
            req.out.clear()
            req.retries += 1
            self.stats["evictions"] += 1
            self.tracer.instant("engine.evict", kind="engine", level=2,
                                rid=req.rid, retries=req.retries)
            if req.retries > req.max_retries:
                req.error = (f"evicted {req.retries} times "
                             f"(max_retries={req.max_retries})")
                self.failed[req.rid] = req
                self.stats["failures"] += 1
            else:
                self.queue.appendleft(req)

    # ------------------------------------------------- non-blocking API ---

    def _free_slot(self) -> Optional[int]:
        """Lowest slot that is neither live nor mid-insert, or None."""
        for s in range(self.slots):
            if not self._live[s] and s not in self._inserting:
                return s
        return None

    def _advance_insert(self, slot: int, req: Request, gen, budget):
        """Drive one insert coroutine until it completes or `budget`
        prefill units are consumed (None = unbounded). Completion removes
        it from `_inserting`; pool exhaustion rolls the slot's page refs
        back and requeues the request at the queue head. Returns the
        remaining budget."""
        try:
            while budget is None or budget > 0:
                next(gen)
                if budget is not None:
                    budget -= 1
        except StopIteration:
            self._inserting.pop(slot, None)
        except PagePoolExhausted:
            self._inserting.pop(slot, None)
            self._free_slot_pages(slot)
            self.queue.appendleft(req)
            raise
        return budget

    def poll(self, rid: int) -> Optional[Request]:
        """Non-blocking result check: the resolved Request once it has
        finished, failed, or been cancelled; None while still in flight."""
        for d in (self.finished, self.failed, self.cancelled):
            if rid in d:
                return d[rid]
        return None

    def _resolve_cancelled(self, req: Request):
        req.error = "cancelled"
        req.finished_s = time.time()
        self.cancelled[req.rid] = req
        self.stats["cancelled"] += 1

    def cancel(self, rid: int) -> bool:
        """Cancel a request wherever it is in the lifecycle -- queued,
        mid-insert, or actively decoding -- releasing its slot and pages.
        Returns False when `rid` is unknown or already resolved."""
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                del self.queue[i]
                self._resolve_cancelled(req)
                return True
        for slot, (req, gen) in list(self._inserting.items()):
            if req.rid == rid:
                gen.close()                      # abandon mid-chunk prefill
                del self._inserting[slot]
                self._free_slot_pages(slot)
                self._resolve_cancelled(req)
                return True
        for slot, req in list(self.active.items()):
            if req.rid == rid:
                del self.active[slot]
                self._live[slot] = False
                self._free_slot_pages(slot)
                req.out.clear()
                self._resolve_cancelled(req)
                return True
        return False

    # --------------------------------------------------------------- run ---

    def step(self, *, max_prefill_chunks: Optional[int] = None,
             defer_admission: bool = False) -> bool:
        """One continuous-batching round: resume in-flight chunked inserts,
        admit queued requests into free slots, then run one batched decode
        step. Returns whether work remains.

        max_prefill_chunks: cap on chunked-prefill calls this round (None
        drains every insert within the round).
        defer_admission: turn PagePoolExhausted during admission into
        backpressure while something is live or inserting."""
        budget = max_prefill_chunks
        for slot in sorted(self._inserting):
            if budget is not None and budget <= 0:
                break
            req, gen = self._inserting[slot]
            try:
                budget = self._advance_insert(slot, req, gen, budget)
            except PagePoolExhausted:
                if defer_admission and (self.active or self._inserting):
                    self.stats["admission_deferred"] += 1
                    self.tracer.instant("engine.admission_deferred",
                                        kind="engine", level=2, rid=req.rid)
                else:
                    raise
        while self.queue and (budget is None or budget > 0):
            slot = self._free_slot()
            if slot is None:
                break
            req = self.queue.popleft()
            gen = self._insert_co(slot, req)
            self._inserting[slot] = (req, gen)
            try:
                budget = self._advance_insert(slot, req, gen, budget)
            except PagePoolExhausted:
                if defer_admission and (self.active or self._inserting):
                    self.stats["admission_deferred"] += 1
                    self.tracer.instant("engine.admission_deferred",
                                        kind="engine", level=2, rid=req.rid)
                    break
                raise
        if self.active:
            if self.tracer.enabled(2):
                with self.tracer.span("engine.decode_step", kind="engine",
                                      level=2, live=len(self.active)):
                    self._step()
            else:
                self._step()
        return bool(self.queue or self.active or self._inserting)

    def run(self, max_steps: int = 10_000, *, strict: bool = True):
        """Drain the queue. If `max_steps` is exhausted with requests still
        queued/active the run is *truncated*: stats["truncations"] is bumped
        and, under `strict` (default), `RunTruncated` is raised -- partial
        results must never read as complete."""
        self.stats["runs"] += 1
        with self.tracer.span("engine.run", kind="engine",
                              queued=len(self.queue)):
            while (self.queue or self.active or self._inserting) and \
                    max_steps > 0:
                max_steps -= 1
                self.step()
        if self.queue or self.active or self._inserting:
            self.stats["truncations"] += 1
            if strict:
                raise RunTruncated(
                    f"run() truncated at max_steps with {len(self.active)} "
                    f"active and {len(self.queue)} queued requests",
                    self.finished)
        return self.finished
