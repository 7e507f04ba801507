"""Data-parallel engine replicas behind one shared admission queue
(DESIGN.md §15).

Throughput past one engine comes from *replicas*: N `ServingEngine`s, each
with its own slots, decode cache, and jitted phases (and, when `mesh=` is
set, its own TP/FSDP-sharded execution), fed from a single shared queue.
`ReplicaGroup` is the engine-state split ROADMAP items 2 and 4 also need:

  per-replica — slots, decode cache, page *tables*, drafters, stats;
  shared      — the admission queue, the prefix cache, and (paged layout)
                the KV page pool, so a prefix prefilled by one replica is
                an O(1) page-id splice for every other.

Scheduling is least-loaded continuous batching: each group step spreads the
shared queue over the replicas (most-free-slots first, so partial batches
parallelize instead of piling onto replica 0), then advances every replica
that has work by one `ServingEngine.step()`. In a deployment the replicas
run concurrently (one process/device-set each); the in-process group
interleaves them on one host thread, which keeps rows byte-identical to a
single engine serving the same workload — the parity bar
tests/test_sharded_serving.py holds the group to.

Stats aggregate by *summation* across replicas (peaks — `max_live`,
`kv_bytes_peak` — take the max), updated in place on one long-lived dict so
callers holding `group.stats` (e.g. `ServedExtractor._run_round`'s
delta-accounting) read coherent totals, exactly as they would off a single
engine. Replica-sum equals single-engine totals for the per-token counters
on an identical workload (regression-tested); last-writer-wins merging of
replica stats dicts is the bug class the aggregation tests pin down.

`ReplicaGroup` is interface-compatible with `ServingEngine` where the
extraction layer touches it (`submit`/`submit_many`/`run`/`stats`/
`queue_depth`/`failed`/`finished`), so it drops into `ServedExtractor`
unchanged and `CostLedger` charges aggregate back through the normal path.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Optional, Union

from repro_torch.models.cache_ops import PageAllocator, PagePoolExhausted
from repro_torch.models.config import ModelConfig

from .engine import RunTruncated, ServingEngine
from .prefix_cache import PrefixCache

# stats aggregated as max over replicas; every other counter sums
PEAK_KEYS = ("max_live", "kv_bytes_peak")


def aggregate_stats(stat_dicts, into: Optional[dict] = None) -> dict:
    """Sum counters (max for PEAK_KEYS) across per-replica stats dicts.
    With `into`, the aggregate is written into that dict in place (cleared
    first) so long-lived references observe the update."""
    agg: dict = {}
    for stats in stat_dicts:
        for k, v in stats.items():
            if k in PEAK_KEYS:
                agg[k] = max(agg.get(k, 0), v)
            else:
                agg[k] = agg.get(k, 0) + v
    if into is None:
        return agg
    into.clear()
    into.update(agg)
    return into


class ReplicaGroup:
    def __init__(self, cfg: ModelConfig, params, *, replicas: int = 2,
                 slots: int = 4, max_len: int = 256,
                 queue_depth: Optional[int] = None,
                 prefix_cache: Union[bool, PrefixCache, None] = False,
                 kv_layout: str = "paged", page_size: int = 16,
                 num_pages: Optional[int] = None, mesh=None,
                 share_kv_pool: bool = True, device=None, **engine_kwargs):
        """replicas: number of data-parallel engines behind the queue.
        queue_depth: admission bound on the *shared* queue (replica queues
        stay unbounded; the group only feeds them up to free slots).
        share_kv_pool: paged layout — one PageAllocator across replicas
        (prefix pages splice cross-replica); False gives each replica its
        own pool (no cross-replica prefix sharing in the paged layout).
        num_pages: shared-pool capacity (default: every replica's default
        allotment); per-replica capacity when share_kv_pool=False.
        device: where the shared pool and every replica run (None = the
        CUDA device). mesh= is not ported yet and raises.
        Remaining kwargs (spec_decode, chunk_size, ...) pass through to
        every `ServingEngine`."""
        if replicas < 1:
            raise ValueError(f"need at least one replica, got {replicas}")
        self.replicas = replicas
        self.queue: deque = deque()
        self.queue_depth = queue_depth
        self.stats: dict = {}
        self._own = {"runs": 0, "truncations": 0, "cancelled": 0}
        self._cancelled: dict = {}   # rid -> Request (cancelled off the shared queue)
        if isinstance(prefix_cache, PrefixCache):
            self.prefix_cache: Optional[PrefixCache] = prefix_cache
        else:
            self.prefix_cache = PrefixCache() if prefix_cache else None
        shared_alloc = None
        if mesh is not None:
            raise NotImplementedError(
                "mesh serving is not yet ported, see ROADMAP.md Queue 1")
        if kv_layout == "paged" and share_kv_pool and replicas > 1:
            pages_per_slot = max_len // max(1, int(page_size))
            if num_pages is None:
                num_pages = replicas * (slots + 4) * pages_per_slot + 1
            shared_alloc = PageAllocator(cfg, num_pages, page_size,
                                         device=device)
        self.engines = [
            ServingEngine(
                cfg, params, slots=slots, max_len=max_len, queue_depth=None,
                prefix_cache=(self.prefix_cache if self.prefix_cache
                              is not None else False),
                kv_layout=kv_layout, page_size=page_size,
                num_pages=num_pages, mesh=mesh, page_allocator=shared_alloc,
                device=device, **engine_kwargs)
            for _ in range(replicas)]
        self._sync_stats()

    # ------------------------------------------------------------ intake --

    def submit(self, req):
        if self.queue_depth is not None and len(self.queue) >= self.queue_depth:
            raise RuntimeError(
                f"serving queue full ({len(self.queue)} >= {self.queue_depth})")
        req.submitted_s = time.time()
        self.queue.append(req)

    def submit_many(self, reqs):
        """All-or-nothing admission, mirroring `ServingEngine.submit_many`."""
        reqs = list(reqs)
        if self.queue_depth is not None and \
                len(self.queue) + len(reqs) > self.queue_depth:
            raise RuntimeError(
                f"serving queue full ({len(self.queue)} + {len(reqs)} > "
                f"{self.queue_depth})")
        for req in reqs:
            self.submit(req)

    # --------------------------------------------------------- aggregation --

    def _sync_stats(self) -> dict:
        aggregate_stats([e.stats for e in self.engines], into=self.stats)
        for k, v in self._own.items():
            # group-level run/truncation accounting: the group drives
            # engine.step() directly, so engines' own counters stay zero
            self.stats[k] = self.stats.get(k, 0) + v
        return self.stats

    @property
    def finished(self) -> dict:
        out: dict = {}
        for e in self.engines:
            out.update(e.finished)
        return out

    @property
    def failed(self) -> dict:
        out: dict = {}
        for e in self.engines:
            out.update(e.failed)
        return out

    @property
    def cancelled(self) -> dict:
        out: dict = dict(self._cancelled)
        for e in self.engines:
            out.update(e.cancelled)
        return out

    @property
    def active_requests(self) -> int:
        return sum(len(e.active) + len(e.queue) + len(e._inserting)
                   for e in self.engines)

    @property
    def free_slots(self) -> int:
        return sum(e.free_slots for e in self.engines)

    def pool_free_pages(self) -> Optional[int]:
        """Free pages in the (shared or per-replica) KV pool — the most
        constrained replica when pools are private. None off-paged."""
        vals = [e.alloc.free_pages for e in self.engines
                if e.paged and e.alloc.pools]
        return min(vals) if vals else None

    def estimate_pages(self, prompt_len: int, max_new: int) -> int:
        return self.engines[0].estimate_pages(prompt_len, max_new)

    # --------------------------------------------------------------- run ---

    def _dispatch(self):
        """Least-loaded dispatch: hand shared-queue requests one at a time
        to the replica with the most free slots (ties to the lowest index),
        so a partial batch spreads across replicas instead of serializing
        behind replica 0 — that spread IS the dp2 throughput win the bench
        gates. Stats stay sum-identical to a single engine: replicas step
        sequentially after dispatch, so whichever replica steps first with a
        prefix group's request pays the one boundary prefill and inserts the
        snapshot into the shared cache; every later admission hits. The
        boundary is paid once and each request pays its own suffix, exactly
        the single-engine totals."""
        while self.queue:
            best, cap = None, 0
            for eng in self.engines:
                free = eng.free_slots - len(eng.queue)
                if free > cap:
                    best, cap = eng, free
            if best is None:
                break
            best.queue.append(self.queue.popleft())

    def _work_remains(self) -> bool:
        return bool(self.queue) or \
            any(e.queue or e.active or e._inserting for e in self.engines)

    def step(self, *, max_prefill_chunks=None,
             defer_admission: bool = False) -> bool:
        """One group round: least-loaded dispatch off the shared queue,
        then one `ServingEngine.step()` on every replica with work — the
        non-blocking unit `serving/frontend.py` pumps. Both knobs pass
        through to each replica (the prefill budget is per replica: they
        model independent devices, so budgets don't share). Returns whether
        work remains; stats are re-aggregated so long-lived references
        observe the round."""
        self._dispatch()
        for eng in self.engines:
            if eng.queue or eng.active or eng._inserting:
                eng.step(max_prefill_chunks=max_prefill_chunks,
                         defer_admission=defer_admission)
        self._sync_stats()
        return self._work_remains()

    def poll(self, rid: int):
        """Non-blocking result check across the group (None = in flight)."""
        if rid in self._cancelled:
            return self._cancelled[rid]
        for eng in self.engines:
            req = eng.poll(rid)
            if req is not None:
                return req
        return None

    def cancel(self, rid: int) -> bool:
        """Cancel wherever the request lives: the shared queue, or any
        replica's queue/insert/active slot (resources released there)."""
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                del self.queue[i]
                req.error = "cancelled"
                req.finished_s = time.time()
                self._cancelled[req.rid] = req
                self._own["cancelled"] += 1
                self._sync_stats()
                return True
        for eng in self.engines:
            if eng.cancel(rid):
                self._sync_stats()
                return True
        return False

    def run(self, max_steps: int = 10_000, *, strict: bool = True):
        """Drain the shared queue across all replicas. Semantics mirror
        `ServingEngine.run`: `max_steps` bounds *group* steps (one
        interleaved round over every replica), truncation is counted and,
        under `strict`, raised as `RunTruncated`."""
        self._own["runs"] += 1
        try:
            while self._work_remains() and max_steps > 0:
                max_steps -= 1
                self._dispatch()
                for eng in self.engines:
                    if eng.queue or eng.active:
                        eng.step()
        except PagePoolExhausted:
            self._sync_stats()
            raise
        self._sync_stats()
        if self._work_remains():
            self._own["truncations"] += 1
            self._sync_stats()
            if strict:
                raise RunTruncated(
                    f"run() truncated at max_steps with "
                    f"{self.active_requests} requests on replicas and "
                    f"{len(self.queue)} queued", self.finished)
        return self.finished
