"""Batched serving engine with continuous batching (counterpart of
`repro.serving.engine`). Inputs are token-level `Request`s; outputs are
greedy decoded ids, identical across every layout and option below.

Two KV layouts, as in the JAX engine:

`kv_layout="paged"` (default): length-indexed KV lives in a fixed pool of
`page_size`-token pages (`models.cache_ops.PageAllocator`); each slot is a
page table. Prompts prefill in fixed-size chunks (`chunk_size` tokens per
`prefill_chunk` call, the last chunk right-padded with its true length
carried along), and live slots decode together in batched `decode_step`s.
On the card both run their attention on the pool itself -- kernel K2 for a
chunk, kernel K1 for a decode step -- where the JAX engine gathers the
pages into dense views, runs jnp attention and scatters the pages back.
The sink page (page 0) holds what the JAX engine's holds, on every
family: a dead row's table is all sink and it attends the sink, and so
does a padded position past a row's pages; with MoE those tokens compete
for expert capacity, and a dead hybrid slot's Mamba2 state is kept. Each
JAX row reads its gathered view -- the sink as it was before the call,
plus the row's own new tokens -- and the scatter back leaves in the sink
the last (row, block), in row-major order, of the blocks that map to it.
MLA (deepseek-v2-lite-16b) keeps that form: it gathers each row's view,
attends it in plain PyTorch and writes the dirtied blocks back. The
dense paged path keeps its kernels on the pool and gets the same from
`cache_ops.sink_plan`: each sink block a row writes is replaced in that
row's table by a scratch page of its own (past the allocatable pages),
seeded from the sink before the call, a write the JAX package drops goes
to a trash page, and after the call the sink takes the winning block, so
the write is deterministic on the card.
A request whose prompt extends a cached prefix (`prefix_cache=True`)
splices the entry's full page ids into its table (ref-counted), copies the
partially filled boundary page (copy-on-write) and chunk-prefills only the
unshared suffix, from a start position in the middle of a page.

`kv_layout="slab"`: per-slot contiguous KV (`model.init_decode_cache`).
A prompt prefills whole, right-padded to the next `chunk_size` multiple
(`prefill(..., length=n)` keeps the state exact at the true length;
kernel K2 over the slab seen as pages), into a B=1 sub-cache merged into
its slot (`write_slot`). A prefix hit copies the entry's trimmed snapshot
into a fresh sub-cache (`expand_snapshot`) and decodes the unshared
suffix one token at a time through the B=1 slab decode step; the first
request of a group prefills exactly the prefix and snapshots it
(`prefix_snapshot`). Batched decode steps run kernel K5 on the slab.

With `spec_decode="prompt_lookup"`, `"draft"` (a second model,
`draft_model=(cfg, params)`) or a custom drafter, decode runs as
draft/verify rounds: the drafter proposes up to `spec_k` tokens per live
slot, one batched verify forward scores every slot's pending token plus
drafts at per-row positions -- kernel K4, on the pool or on the slab seen
as pages -- and the longest greedy-agreeing prefix plus one bonus token is
emitted. Rejected suffixes roll back exactly: on the pool their KV
positions are zeroed and the speculative page references released
(`cache_ops.truncate_pages` / `release_trailing_pages`); on the slab the
row's position is reset. Greedy output is identical to plain decode.

Mamba1 (`family="ssm"`, falcon-mamba-7b) has no length-indexed KV, so
the pool holds nothing and no page is allocated: its conv window and scan
state live per slot in `self.cache` beside `pos`, as in the JAX engine. A
request prefills into a B=1 state (`_init_state_sub`) that is merged into
its slot when the insert completes; a prefix entry carries the exact
state at its boundary, and its byte size counts it. Verify rounds write
the state after every candidate into checkpoint buffers allocated once
per engine (`models.init_verify_ckpts`), and a row that rejects part of
its drafts is restored from the checkpoint at its kept length
(`_restore_ckpt_rows`), on either layout.

The hybrid family (zamba2-2.7b) has both: KV pools of one layer per
shared-block application, and its Mamba2 conv window and state per slot
beside them. A prefix entry holds the pages and a copy of the state at
its boundary together, and verify rounds checkpoint and restore the
Mamba2 state as Mamba1's.

The encoder-decoder family (whisper-medium) keeps the cross K/V of the
stub frontend's zero frames, "ck"/"cv", per slot beside `pos`, as the JAX
engine does: not in the pool, and whole in every prefix entry, whose
byte size counts it. The paged layout encodes the frames once per engine
(`encode_cross_kv`) into each request's state; the slab `prefill` runs
the encoder on every call. The frames take no cache position.

The vlm family (llava-next-mistral-7b) puts `n_image_tokens` image
positions in front of every prompt (`_extra`, from the stub vision
tower's zero embeddings), as the JAX engine does: a sequence's first
chunk or bucketed prefill carries them, positions, page counts, prefix
snapshots and the cache bound count them, and the prompt tokens, the
ledger and `prefill_tokens` do not.

The engine's counters keep the JAX formulas, so `stats` are identical
between the two packages. Requests, slots, the insert coroutines that
interleave prefill with decode, `drain_slot` (bounded retries), `cancel`,
`poll` and the strict `run()` (`RunTruncated`) follow the JAX engine one
for one, as do `free_slots`, `estimate_pages` and `pool_free_pages`, the
non-blocking surface the admission frontend (`serving/frontend.py`)
schedules against. Engines of a replica group (`serving/replicas.py`)
share one `PageAllocator` (`page_allocator=`): every page reference
(`retain`/`release`) goes to that one pool, while each engine keeps its own
page tables and positions.

`mesh=` (a (data, model) `DeviceMesh` from `launch.mesh`, over a default
process group the caller has started) serves every family, both layouts
and every drafter on a mesh, one process a rank. Every rank builds the
engine with the full parameters and the same arguments and runs the same
requests: the host-side decisions (scheduling, page ids, prefix hits,
drafts) are the same on every rank, so none is exchanged. Each rank keeps
its shards of the parameters (`distributed.sharding.shard_params`: FSDP on
`data`, tensor parallelism on `model`), of the pool (heads, or MLA's
latent rank, over `model`, pages replicated, `PageAllocator.shard_pools`)
and of the per-slot state and slab (`serving_cache_specs`: slots over
`data`, the slab's sequence, Mamba1's channels and the cross K/V's heads
over `model`); the forwards write out the collectives that GSPMD inserts
in the JAX engine (`distributed.sharding.MeshRank`). A batched decode step
or verify round runs each `data` rank's slots (the moe family: every slot
on every rank, so K6 sees the whole call), writes every slot's K/V into a
paged pool on every rank and all-gathers the step's tokens; a prefill
chunk or whole prompt runs on every rank, and a B = 1 sub-cache is the
rank's shard of the slab but for the batch. The slab's decode steps run
the sequence-sharded combine over kernel K5s. A prefix entry holds the
rank's shards, and its byte size, like `kv_bytes_peak`, counts the global
tensors, as the JAX package counts a sharded array. Rows, tokens and
`stats` are those of the single-device engine.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.data import lm_data
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (MeshRank, global_nbytes, serving_cache_specs,
                                              shard_params)
from repro_torch.launch.mesh import mesh_device
from repro_torch.models import (decode_step, decode_step_slab,
                                encode_cross_kv, init_decode_cache, init_state_cache,
                                init_verify_ckpts, prefill, prefill_chunk, verify_chunk,
                                verify_chunk_slab)
from repro_torch.models.cache_ops import (PAGE_SINK, PageAllocator,
                                          PagePoolExhausted, cache_nbytes,
                                          expand_snapshot, prefix_snapshot,
                                          release_trailing_pages, seed_scratch,
                                          sink_plan, sink_take, truncate_pages,
                                          write_slot)
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import VISION_DIM
from repro_torch.obs import MetricsRegistry, StatsDict, as_tracer
from repro_torch.obs.metrics import ENGINE_STATS

from .prefix_cache import PrefixCache
from .spec_decode import DraftModelDrafter, PromptLookupDrafter

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
    # per-request speculative-decode economy
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
                 max_len: int = 256, queue_depth: Optional[int] = None,
                 prefix_cache: Union[bool, PrefixCache, None] = False,
                 prefix_min_len: int = 8, kv_layout: str = "paged",
                 page_size: int = 16, num_pages: Optional[int] = None,
                 chunk_size: int = 32, spec_decode="off", spec_k: int = 4,
                 spec_ngram: int = 3, draft_model: Optional[tuple] = None,
                 mesh=None, page_allocator=None,
                 compilation_cache_dir: Optional[str] = None, tracer=None, metrics=None,
                 device=None):
        """queue_depth: optional admission-control bound on queued requests;
        ServedExtractor splits its batch rounds into windows of this size
        (None = unbounded).
        prefix_cache: shared-prefix KV reuse -- False/None off, True for a
        default `PrefixCache()`, or a configured instance.
        prefix_min_len: shortest prefix worth snapshotting/splicing.
        kv_layout: "paged" (page-table KV + chunked prefill) or "slab"
        (per-slot contiguous KV, bucketed whole-prompt prefill).
        page_size: tokens per KV page (paged layout; must divide max_len).
        num_pages: pool capacity (default (slots+4) tables' worth + sink).
        chunk_size: prompt tokens per chunked-prefill call; also the
        bucket granularity of slab-layout prefill.
        spec_decode: speculative decoding -- "off", "prompt_lookup" (n-gram
        drafting over the request's own context), "draft" (a second model,
        see `draft_model`) or a custom drafter instance (`draft_round`/
        `on_insert`/`on_free`). Greedy output is identical across them.
        spec_k: draft tokens per verify round (each round emits 1..k+1).
        spec_ngram: longest n-gram the prompt-lookup drafter matches.
        draft_model: (ModelConfig, params) of the draft model, required for
        spec_decode="draft" (dense/moe family, same vocab); its params
        must live on `device`.
        page_allocator: a `PageAllocator` shared with other engines (a
        replica group's one KV pool) in place of the engine's own; its page
        size must be `page_size` and its pools must live on `device`.
        device: where the KV and the model run (None = the CUDA device);
        `params` must already live there.
        mesh: a (data, model) `DeviceMesh` (`launch.mesh.make_serving_mesh`)
        over a started default process group: the engine on the mesh.
        `params` are the full parameters (or `shard_params`' shards), and
        so are a draft model's; the engine's device is the rank's
        (`launch.mesh.mesh_device`), and `device` must be None.
        compilation_cache_dir: build and load the CUDA kernels' library in
        this directory (`launch/compile_cache.py`), so that a later process
        with the same directory loads it without nvcc."""
        if compilation_cache_dir is not None:
            from repro_torch.launch.compile_cache import enable_compilation_cache
            enable_compilation_cache(compilation_cache_dir)
        if kv_layout not in ("paged", "slab"):
            raise ValueError(f"kv_layout must be 'paged' or 'slab', got {kv_layout!r}")
        self.cfg = cfg
        self._mesh = None
        if mesh is not None:
            if device is not None:
                raise ValueError("on a mesh the engine runs on the rank's device; "
                                 "pass device=None")
            self.device = mesh_device(mesh)
            params = shard_params(cfg, params, mesh, device=self.device)
            self._mesh = MeshRank(cfg, params, None if kv_layout == "paged" else max_len)
        else:
            self.device = resolve_device(device)
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.queue_depth = queue_depth
        self.kv_layout = kv_layout
        self.paged = kv_layout == "paged"
        self.page_size = max(1, int(page_size))
        self.chunk_size = max(1, int(chunk_size))
        if isinstance(prefix_cache, PrefixCache):   # may be empty, i.e. falsy
            self.prefix_cache: Optional[PrefixCache] = prefix_cache
        else:
            self.prefix_cache = PrefixCache() if prefix_cache else None
        self.prefix_min_len = max(1, int(prefix_min_len))
        self.spec_k = max(1, int(spec_k))
        if isinstance(spec_decode, str):
            if spec_decode not in ("off", "prompt_lookup", "draft"):
                raise ValueError(
                    f"spec_decode must be 'off', 'prompt_lookup', 'draft' or "
                    f"a drafter instance, got {spec_decode!r}")
            if spec_decode == "prompt_lookup":
                self.drafter = PromptLookupDrafter(ngram=spec_ngram)
            elif spec_decode == "draft":
                if draft_model is None:
                    raise ValueError(
                        "spec_decode='draft' requires draft_model=(cfg, params)")
                dcfg, dparams = draft_model
                if dcfg.vocab_size != cfg.vocab_size:
                    raise ValueError(
                        f"draft vocab {dcfg.vocab_size} != target vocab "
                        f"{cfg.vocab_size}")
                self.drafter = DraftModelDrafter(
                    dcfg, dparams, slots=slots, max_len=max_len, mesh=mesh,
                    device=None if mesh is not None else self.device)
            else:
                self.drafter = None
        else:
            # custom drafter instance; falsy (None/False) reads as off
            self.drafter = spec_decode or None
            if self.drafter is not None and \
                    not hasattr(self.drafter, "draft_round"):
                raise ValueError(
                    f"spec_decode instance must implement the drafter "
                    f"protocol (draft_round/on_insert/on_free), got "
                    f"{spec_decode!r}")
        self.spec = self.drafter is not None
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
        # (its byte size enters kv_bytes_peak), beside the slab's K/V or
        # Mamba1's conv/ssm state
        if self.paged:
            self.cache = init_state_cache(cfg, slots, device=self.device)
        else:
            self.cache = init_decode_cache(cfg, slots, max_len, device=self.device)
            self._prefill_buckets: set = set()     # distinct prefill lengths
        if mesh is not None:
            # the rank's shards, and the specs that give their global bytes
            # (the batched cache's, and a B = 1 sub-cache's or state's)
            self._specs = serving_cache_specs(cfg, self.cache, mesh, slots)
            self._sub_specs = serving_cache_specs(cfg, self.cache, mesh, 1)
            self.cache = self._mesh.local_cache(cfg, self.cache, slots)
        self.cache["pos"] = torch.zeros((slots,), dtype=torch.int32, device=self.device)
        self._pos_h = np.zeros((slots,), np.int64)   # host mirror of pos
        self._live = np.zeros((slots,), bool)
        self._tokens = torch.zeros((slots, 1), dtype=torch.int64,
                                   device=self.device)
        self.slot_pages: list = [[] for _ in range(slots)]   # empty for slab
        self._ckpts = None          # Mamba1 verify checkpoints, made once
        self._cross_kv = None       # encdec: the frames' cross K/V, computed once
        # vlm: image tokens occupy the first cache positions of every prompt
        self._extra = cfg.n_image_tokens if cfg.family == "vlm" else 0

        if self.paged:
            if max_len % self.page_size:
                raise ValueError(
                    f"max_len={max_len} must be a multiple of page_size={page_size}")
            self.pages_per_slot = max_len // self.page_size
            # scratch pages a call may take (`cache_ops.sink_plan`): the sink
            # blocks a padded chunk, or every row of a decode step or verify
            # round, can write, and the trash page
            ps, cs = self.page_size, self.chunk_size + self._extra
            C = self.spec_k + 1 if self.spec else 1
            n_scratch = max((cs + ps - 2) // ps + 1,
                            slots * ((C + ps - 2) // ps + 1 if ps > 1 else C)) + 1
            if page_allocator is not None:
                assert page_allocator.page_size == self.page_size, (
                    f"shared allocator page_size={page_allocator.page_size} "
                    f"!= engine page_size={self.page_size}")
                here = torch.empty(0, device=self.device).device
                assert all(a.device == here for a in page_allocator.pools.values()), (
                    f"shared allocator pools live on "
                    f"{sorted({str(a.device) for a in page_allocator.pools.values()})}, "
                    f"not on the engine's {here}")
                self.alloc = page_allocator   # shared pool: replica groups
            else:
                if num_pages is None:
                    num_pages = (slots + 4) * self.pages_per_slot + 1
                self.alloc = PageAllocator(cfg, num_pages, self.page_size,
                                           device=self.device)
                if mesh is not None:
                    self.alloc.shard_pools(mesh)
            # the dense paged path reads and writes the sink through scratch
            # pages; MLA gathers views and writes their blocks back itself
            self._sink_pages = "k" in self.alloc.pools
            if self._sink_pages:
                self.alloc.reserve_scratch(n_scratch)

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

    # --------------------------------------------------- slab-mode prefill --

    def _bucket_len(self, n: int) -> int:
        """Next chunk_size multiple: bounds the distinct prefill lengths
        (the JAX engine's jit signatures). Capped so padding never pushes
        text + image tokens past the cache bound a legal prompt still fits
        in."""
        b = self.chunk_size
        return min(((n + b - 1) // b) * b, self.max_len - self._extra)

    def _image_embeds(self):
        """The stub vision tower's output for one prompt: zeros (1,
        n_image_tokens, VISION_DIM) float32, as the JAX engine feeds it."""
        return torch.zeros((1, self._extra, VISION_DIM), dtype=torch.float32,
                           device=self.device)

    def _frames(self):
        """The stub audio frontend's output for one prompt: zeros (1,
        encoder_seq, d_model) in the model dtype, as the JAX engine feeds
        the encoder."""
        return torch.zeros((1, self.cfg.encoder_seq, self.cfg.d_model),
                           dtype=self.params["embed"].dtype, device=self.device)

    def _prefill_sub(self, tokens: list):
        """Exact-state prefill of `tokens` into a B=1 slab sub-cache, padded
        to a bucketed length (`length` keeps the logits and the cache
        position exact at the true length; a vlm prompt carries its image
        prefix, an encdec prompt the frames its encoder runs on). Returns
        (last-position logits, sub-cache)."""
        n = len(tokens)
        bucket = self._bucket_len(n)
        self._prefill_buckets.add(bucket)
        toks = torch.as_tensor([list(tokens) + [0] * (bucket - n)], dtype=torch.int64,
                               device=self.device)
        self.stats["prefill_invocations"] += 1
        # attention-FLOPs proxy: KV positions computed against (S x S matrix)
        self.stats["prefill_ctx_positions"] += (self._extra + bucket) ** 2
        return prefill(self.cfg, self.params, toks, self.max_len, length=n,
                       image_embeds=self._image_embeds() if self._extra else None,
                       frames=self._frames() if self.cfg.family == "encdec" else None,
                       mesh=self._mesh)

    def _nbytes(self, tree: dict, sub: bool = False, seq_len=None) -> int:
        """Bytes of a cache dict; on a mesh those of the global tensors the
        rank's shards belong to (the batched cache's specs, or with `sub` a
        B = 1 sub-cache's; `seq_len` for a trimmed snapshot)."""
        if self._mesh is None:
            return cache_nbytes(tree)
        return global_nbytes(tree, self._sub_specs if sub else self._specs,
                             self._mesh.mesh, seq_len)

    def _insert_slab_co(self, slot: int, req: Request):
        """Slab-layout insert, yielding between prefill units (one bucketed
        prefill, or one decode step per unshared-suffix token). A prefix
        hit expands the entry's snapshot and decodes the suffix token by
        token through the B=1 slab decode step; the first request of a
        group prefills exactly the shared prefix, snapshots it, then
        continues the same way. Returns (last logits, logical position); the
        position counts the image prefix."""
        prompt = req.prompt
        sub, prefix_len, did_work = None, 0, False
        if self.prefix_cache is not None:
            entry = self.prefix_cache.match(prompt)
            if entry is not None and len(entry.tokens) >= self.prefix_min_len:
                prefix_len = len(entry.tokens)
                sub = expand_snapshot(entry.cache, self.max_len, self._mesh)
                self.stats["prefix_hits"] += 1
                self.stats["prefix_saved_tokens"] += prefix_len
                self.tracer.instant("engine.prefix_hit", kind="engine",
                                    level=2, saved=prefix_len)
            else:
                # first request of a prefix group: prefill the shared prefix
                # exactly (state-correct snapshot boundary), then continue
                boundary = min(int(req.shared_len), len(prompt) - 1)
                if boundary >= self.prefix_min_len:
                    _, sub = self._prefill_sub(prompt[:boundary])
                    did_work = True
                    self.stats["prefill_tokens"] += boundary
                    lp = self._extra + boundary
                    snap = prefix_snapshot(sub, lp, self._mesh)
                    self.prefix_cache.insert(
                        prompt[:boundary], snap,
                        nbytes=self._nbytes(snap, sub=True, seq_len=lp),
                        doc_ids=self._entry_docs(req, boundary))
                    self.stats["prefix_inserts"] += 1
                    prefix_len = boundary
        if sub is None:
            logits, sub = self._prefill_sub(prompt)
            self.stats["prefill_tokens"] += len(prompt)
        else:
            logits = None
            for t in prompt[prefix_len:]:
                if did_work:
                    yield               # cooperative point between tokens
                did_work = True
                logits, sub = decode_step_slab(
                    self.cfg, self.params,
                    torch.as_tensor([[t]], dtype=torch.int64, device=self.device), sub,
                    mesh=self._mesh)
                self.stats["prefill_invocations"] += 1
                # each token-step attends the full max_len KV buffer
                self.stats["prefill_ctx_positions"] += self.max_len
            self.stats["prefill_tokens"] += len(prompt) - prefix_len
        write_slot(self.cache, sub, slot, self._mesh)
        return logits, self._extra + len(prompt)

    # -------------------------------------------------- paged-mode prefill --

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int32), device=self.device)

    def _chunked_prefill_co(self, slot: int, state: dict, tokens: list, lpos: int, *,
                            first: bool = True):
        """Feed `tokens` through fixed-size prefill chunks from logical
        position `lpos`, yielding between chunks so the caller can
        interleave decode of live slots with this insert's prefill. Every
        chunk is padded to `chunk_size` and carries its true length; its K/V
        goes straight into the slot's pages, and the context is read through
        a pow2-bucketed page-table row as wide as the JAX engine's gathered
        view, whose width the counters use. `state` is the request's B=1
        pure state (Mamba1's conv/ssm; empty for the dense family), advanced
        in place. `first=False` yields before the first chunk too
        (continuation of an insert that already did a prefill unit). A vlm
        sequence's first chunk (`lpos == 0`) carries the image prefix ahead
        of its text, and the padded chunk then touches cs + n_image_tokens
        positions. Returns (last-chunk logits, new logical position, first)."""
        cs, ps = self.chunk_size, self.page_size
        pages = self.slot_pages[slot]
        has_pool = bool(self.alloc.pools)
        logits, i, n = None, 0, len(tokens)
        while i < n:
            if not first:
                yield               # cooperative point between chunks
            first = False
            true_clen = min(cs, n - i)
            with_images = self._extra > 0 and lpos == 0
            extra = self._extra if with_images else 0
            llen_pad = cs + extra         # positions the padded chunk touches
            winner = PAGE_SINK
            if has_pool:
                # blocks the padded chunk can dirty, and the context they need
                nb = (llen_pad + ps - 2) // ps + 1 if ps > 1 else llen_pad
                n_ctx = _pow2_at_least(max(-(-(lpos + llen_pad) // ps), nb))
                ctx = np.asarray([[pages[b] if b < len(pages) else PAGE_SINK
                                   for b in range(n_ctx)]], np.int32)
                if self._sink_pages:
                    b0 = min(lpos // ps, n_ctx - nb)
                    ctx, _, seeds, winner = sink_plan(
                        ctx, lpos + np.arange(llen_pad)[None], b0 + np.arange(nb)[None],
                        ps, self.alloc.scratch)
                    seed_scratch(self.alloc.pools, seeds)
                ctx = self._ids(ctx[0])
            else:
                n_ctx, ctx = 0, None
            chunk = list(tokens[i:i + true_clen]) + [0] * (cs - true_clen)
            logits = prefill_chunk(
                self.cfg, self.params,
                torch.as_tensor([chunk], dtype=torch.int64, device=self.device),
                lpos, true_clen, self.alloc.pools, ctx, state=state,
                image_embeds=self._image_embeds() if with_images else None,
                mesh=self._mesh)
            sink_take(self.alloc.pools, winner)
            self.stats["prefill_invocations"] += 1
            self.stats["prefill_chunks"] += 1
            self.stats["prefill_ctx_positions"] += \
                llen_pad * (n_ctx * ps if has_pool else llen_pad)
            self.tracer.instant("engine.prefill_chunk", kind="engine",
                                level=2, tokens=int(true_clen))
            i += true_clen
            lpos += true_clen + extra
        return logits, lpos, first

    def _ensure_pages(self, n: int, acquired: list) -> list:
        """Allocate n pages, evicting LRU prefix entries under pool pressure
        (pinned entries -- pages shared with live slots -- free nothing and
        the loop moves on to the next victim). Newly allocated ids are
        appended to `acquired`; on hard exhaustion the caller rolls that
        list back."""
        while True:
            try:
                ids = self.alloc.alloc(n)
                acquired.extend(ids)
                return ids
            except PagePoolExhausted:
                if self.prefix_cache is not None and \
                        self.prefix_cache.pop_lru() is not None:
                    continue
                raise

    def _cow_page(self, src: int, acquired: list) -> int:
        """copy_page with the same evict-LRU-under-pressure behaviour as
        `_ensure_pages`. `src` must be retained by the caller so a victim
        eviction cannot free it mid-copy."""
        while True:
            try:
                dst = self.alloc.copy_page(src)
                acquired.append(dst)
                return dst
            except PagePoolExhausted:
                if self.prefix_cache is not None and \
                        self.prefix_cache.pop_lru() is not None:
                    continue
                raise

    @staticmethod
    def _entry_docs(req: Request, boundary: int) -> tuple:
        """Doc provenance for a prefix entry at `boundary` tokens: the
        request's content docs iff the boundary reaches into the content
        span -- a template-only prefix embeds no document text and must
        survive that document's mutation."""
        if (req.content_docs and req.content_start is not None
                and boundary > req.content_start):
            return tuple(req.content_docs)
        return ()

    def _snapshot_prefix_paged(self, slot: int, prefix: list, state: dict,
                               req: Optional[Request] = None):
        """Store a prefix entry as *page references*: full pages shared by
        reference (ref-counted), the partially filled boundary page copied
        once so the slot can keep writing into its own copy (CoW). The
        entry's state is the position, an int32 scalar as in the JAX engine,
        and a copy of the request's pure state at the boundary (Mamba1's
        conv/ssm; none for the dense family); their bytes enter the entry's
        size."""
        lp = self._extra + len(prefix)
        pages = self.slot_pages[slot]
        full = lp // self.page_size
        entry_pages = list(pages[:full])
        self.alloc.retain(entry_pages)
        tail = None
        if lp % self.page_size and full < len(pages):
            try:
                tail = self._cow_page(pages[full], [])
            except PagePoolExhausted:
                # caching this prefix is an optimization, not a requirement:
                # under hard pool pressure skip the snapshot, keep serving
                self.alloc.release(entry_pages)
                return
            self.stats["cow_copies"] += 1
        snap = {"pos": torch.tensor(lp, dtype=torch.int32),
                **{k: a.clone() for k, a in state.items()}}
        nbytes = ((len(entry_pages) + (1 if tail is not None else 0))
                  * self.alloc.page_nbytes + self._nbytes(snap, sub=True))
        alloc, ids = self.alloc, entry_pages + ([tail] if tail is not None else [])
        self.prefix_cache.insert(prefix, snap, pages=entry_pages,
                                 tail_page=tail, nbytes=nbytes,
                                 release=(lambda: alloc.release(ids)),
                                 doc_ids=(self._entry_docs(req, len(prefix))
                                          if req is not None else ()))
        self.stats["prefix_inserts"] += 1

    def _init_state_sub(self) -> dict:
        """A fresh B=1 pure state (zeros shaped as one slot of the
        per-slot cache, `pos` aside). For the encdec family it is the cross
        K/V of the frames, which the engine encodes once
        (`encode_cross_kv`, as the JAX engine) and every request shares:
        no forward writes a state's "ck"/"cv", and snapshots copy them."""
        if self.cfg.family == "encdec":
            if self._cross_kv is None:
                self._cross_kv = encode_cross_kv(self.cfg, self.params, self._frames(),
                                                 tp=self._mesh)
            return dict(zip(("ck", "cv"), self._cross_kv))
        return {k: torch.zeros_like(a[:, :1]) for k, a in self.cache.items() if k != "pos"}

    def _free_slot_pages(self, slot: int):
        if self.slot_pages[slot]:
            self.alloc.release(self.slot_pages[slot])
            self.slot_pages[slot] = []

    def _page_table(self, width: int) -> np.ndarray:
        """Page table truncated to the live rows' block high-water mark
        (pow2-bucketed by the caller): decode attends only the blocks
        actually in use instead of the full max_len."""
        tbl = np.full((self.slots, width), PAGE_SINK, np.int32)
        for s, pages in enumerate(self.slot_pages):
            if self._live[s]:
                tbl[s, :min(len(pages), width)] = pages[:width]
        return tbl

    def _insert_paged_co(self, slot: int, req: Request):
        """Chunked prefill of `req` into `slot`. Pages are acquired all at
        once *before the first yield* (all-or-nothing: PagePoolExhausted
        raises out of the first advance with every acquired ref rolled
        back); a prefix-cache hit splices the entry's full pages and CoWs
        its boundary page, and only the unshared suffix is prefilled. From
        the first yield on, `slot_pages[slot]` owns every page ref, so
        abandoning the coroutine cleans up via `_free_slot_pages` alone.
        Returns (last-chunk logits, logical position)."""
        prompt = req.prompt
        plen = len(prompt)
        total = self._extra + plen
        ps = self.page_size
        # Positions ever written: prompt + every fed generated token. With
        # speculation on, verify rounds grow the table lazily (and roll a
        # rejected suffix's pages back), so insert covers the prompt only.
        cap = min(total if self.spec else total + req.max_new, self.max_len)
        blocks = -(-cap // ps) if self.alloc.pools else 0
        acquired: list = []
        state, prefix_len, pages = None, 0, []
        try:
            if self.prefix_cache is not None:
                entry = self.prefix_cache.match(prompt)
                if entry is not None and len(entry.tokens) >= self.prefix_min_len:
                    # O(1) splice: share the full pages, CoW the boundary page
                    prefix_len = len(entry.tokens)
                    pages = list(entry.pages)
                    self.alloc.retain(pages)
                    acquired.extend(pages)
                    if entry.tail_page is not None:
                        tail_src = entry.tail_page
                        self.alloc.retain([tail_src])   # survive a victim evict
                        try:
                            pages.append(self._cow_page(tail_src, acquired))
                        finally:
                            self.alloc.release([tail_src])
                        self.stats["cow_copies"] += 1
                    state = {k: a.clone() for k, a in entry.cache.items() if k != "pos"}
                    self.stats["prefix_hits"] += 1
                    self.stats["prefix_saved_tokens"] += prefix_len
                    self.tracer.instant("engine.prefix_hit", kind="engine",
                                        level=2, saved=prefix_len)
            if blocks > len(pages):
                pages = pages + self._ensure_pages(blocks - len(pages), acquired)
        except PagePoolExhausted:
            if acquired:                    # roll back the splice/CoW refs
                self.alloc.release(acquired)
            raise
        self.slot_pages[slot] = pages
        if state is not None:
            logits, lpos, _ = yield from self._chunked_prefill_co(
                slot, state, prompt[prefix_len:], self._extra + prefix_len)
            self.stats["prefill_tokens"] += plen - prefix_len
        else:
            state = self._init_state_sub()
            boundary = 0 if self.prefix_cache is None else \
                min(int(req.shared_len), plen - 1)
            if boundary >= self.prefix_min_len:
                _, lpos, first = yield from self._chunked_prefill_co(
                    slot, state, prompt[:boundary], 0)
                self._snapshot_prefix_paged(slot, prompt[:boundary], state, req=req)
                logits, lpos, first = yield from self._chunked_prefill_co(
                    slot, state, prompt[boundary:], lpos, first=first)
            else:
                logits, lpos, _ = yield from self._chunked_prefill_co(
                    slot, state, prompt, 0)
            self.stats["prefill_tokens"] += plen
        write_slot(self.cache, state, slot, self._mesh)
        return logits, lpos

    def _insert_co(self, slot: int, req: Request):
        """Coroutine insert: run `req`'s chunked prefill into `slot`,
        yielding between chunks so `step()` can interleave decode of
        already-live slots with admission prefill. The slot goes live only
        on completion; mid-insert it is reserved via `self._inserting`."""
        plen = len(req.prompt)
        if self._extra + plen > self.max_len:
            raise ValueError(f"prompt ({plen} + {self._extra} image tokens) exceeds "
                             f"cache max_len={self.max_len}")
        co = self._insert_paged_co if self.paged else self._insert_slab_co
        logits, lpos = yield from co(slot, req)
        self.cache["pos"][slot] = lpos
        self._pos_h[slot] = lpos
        nxt = int(torch.argmax(logits[0, -1]))
        self._tokens[slot, 0] = nxt
        req.out.append(nxt)
        self.active[slot] = req
        self._live[slot] = True
        if self.spec:
            self.drafter.on_insert(slot, req)
        self._note_kv_bytes()

    def _note_kv_bytes(self):
        used = self._nbytes(self.cache)
        if self.paged:
            used += self.alloc.nbytes_in_use
        elif self.prefix_cache is not None:
            used += self.prefix_cache.nbytes
        self.stats["kv_bytes_peak"] = max(self.stats["kv_bytes_peak"], used)

    # ------------------------------------------------------------- decode --

    def _finish(self, slot: int, req: Request):
        req.done = True
        req.finished_s = time.time()
        self.finished[req.rid] = req
        del self.active[slot]
        self._live[slot] = False
        self._free_slot_pages(slot)
        if self.spec:
            self.drafter.on_free(slot)

    def _step(self):
        if self.paged:
            table = write_ids = None
            winner = PAGE_SINK
            if self.alloc.pools:
                write_ids = np.full((self.slots,), PAGE_SINK, np.int32)
                maxb = 1
                for s in range(self.slots):
                    if self._live[s]:
                        maxb = max(maxb, len(self.slot_pages[s]))
                        b = int(self._pos_h[s]) // self.page_size
                        if b < len(self.slot_pages[s]):
                            write_ids[s] = self.slot_pages[s][b]
                width = min(_pow2_at_least(maxb), self.pages_per_slot)
                table = self._page_table(width)
                if self._sink_pages:
                    # the block holding pos, clamped into the view, as the
                    # JAX engine's token scatter takes it back
                    wpos = self._pos_h[:, None]
                    table, wp, seeds, winner = sink_plan(
                        table, wpos, np.minimum(wpos // self.page_size, width - 1),
                        self.page_size, self.alloc.scratch)
                    write_ids = wp[:, 0]
                    seed_scratch(self.alloc.pools, seeds)
                table, write_ids = self._ids(table), self._ids(write_ids)
            pos = self.cache["pos"]
            logits = decode_step(self.cfg, self.params, self._tokens, pos,
                                 self.alloc.pools, table, write_ids, state=self.cache,
                                 mesh=self._mesh)
            sink_take(self.alloc.pools, winner)
            self.cache["pos"] = pos + 1
        else:
            # every row steps, live or not: a free slot's position runs on
            # (past max_len too, where its writes are dropped) until an
            # insert resets it, as in the JAX engine
            logits, self.cache = decode_step_slab(self.cfg, self.params,
                                                  self._tokens, self.cache, mesh=self._mesh)
        self._pos_h += 1
        self.stats["decode_steps"] += 1
        self.stats["decode_slot_steps"] += len(self.active)
        self.stats["max_live"] = max(self.stats["max_live"], len(self.active))
        nxt = self._greedy(logits[:, 0, :]).cpu().numpy()
        for slot, req in list(self.active.items()):
            tok = int(nxt[slot])
            req.out.append(tok)
            full = int(self._pos_h[slot]) >= self.max_len - 1
            if tok == req.eos_id or len(req.out) >= req.max_new or full:
                self._finish(slot, req)
        self._tokens = torch.as_tensor(nxt[:, None], dtype=torch.int64,
                                       device=self.device)

    # ------------------------------------------------ speculative decode --

    def _spec_grow_pages(self, slot: int, upto: int) -> int:
        """Lazily extend a slot's page table to cover `upto` positions for
        this verify round (evicting LRU prefix entries under pressure).
        Returns the number of positions that actually fit -- under hard pool
        exhaustion the round is clamped to the current allocation instead of
        failing, as long as at least the pending token fits."""
        ps = self.page_size
        pages = self.slot_pages[slot]
        need = min(-(-upto // ps), self.pages_per_slot)
        if need > len(pages):
            try:
                pages += self._ensure_pages(need - len(pages), [])
            except PagePoolExhausted:
                if len(pages) * ps <= int(self._pos_h[slot]):
                    raise               # not even the pending token fits
        return min(upto, len(pages) * ps, self.max_len)

    def _spec_clamp_drafts(self, live, pos_h, drafts):
        """Clamp each live slot's drafts to its page capacity, growing
        tables lazily. A slot whose *pending token* no longer fits (pool
        pinned by other live slots, prefix LRU drained) is evicted back to
        the queue via `drain_slot`, freeing its pages so the other slots
        (and, later, the requeued request) can proceed. Returns the live
        list minus any drained slots."""
        kept = []
        for s in live:
            if self.alloc.pools:
                try:
                    fit = self._spec_grow_pages(s, int(pos_h[s]) + 1 + len(drafts[s]))
                except PagePoolExhausted:
                    self.drain_slot(s)
                    continue
                drafts[s] = drafts[s][: max(fit - int(pos_h[s]) - 1, 0)]
            kept.append(s)
        return kept

    def _spec_step(self):
        """One speculative round (replaces `_step` when `spec_decode` is
        on): draft up to k tokens per live slot, verify pending+drafts for
        every slot in ONE batched `verify_chunk` forward (kernel K4 on the
        pool), emit the longest agreeing prefix plus the target's own next
        token, then roll rejected suffixes back -- position truncation plus
        page scrub and ref release -- so the engine state is exactly what
        plain decode would have built."""
        C, ps = self.spec_k + 1, self.page_size
        live = [s for s in range(self.slots) if self._live[s]]
        pos_h = self._pos_h.astype(np.int64).copy()
        reqs = {s: self.active[s] for s in live}
        k_eff = {}
        for s in live:
            req, p0 = self.active[s], int(pos_h[s])
            k_eff[s] = max(0, min(self.spec_k, req.max_new - len(req.out) - 1,
                                  self.max_len - 1 - p0))
        drafts = self.drafter.draft_round(reqs, k_eff)
        for s in live:
            drafts[s] = list(drafts.get(s) or [])[: k_eff[s]]
        if self.paged:
            live = self._spec_clamp_drafts(live, pos_h, drafts)
            if not live:
                return                   # all slots drained; run() reinserts
        toks = np.zeros((self.slots, C), np.int64)
        true_c = {}
        for s in live:
            row = [self.active[s].out[-1]] + drafts[s]
            true_c[s] = len(row)
            toks[s, :len(row)] = row

        ckpts = None
        if "ssm" in self.cache:
            if self._ckpts is None:
                self._ckpts = init_verify_ckpts(self.cache, C)
            ckpts = self._ckpts
        if self.paged:
            ctx = wpages = woffs = b0s = None
            winner = PAGE_SINK
            if self.alloc.pools:
                # context width bucketed as the JAX engine's gathered view
                nb_probe = (C + ps - 2) // ps + 1 if ps > 1 else C
                need_ctx = 1
                for s in live:
                    p0 = int(pos_h[s])
                    need_ctx = max(need_ctx, -(-(p0 + C) // ps), p0 // ps + nb_probe)
                n_ctx = _pow2_at_least(need_ctx)
                ctx = np.full((self.slots, n_ctx), PAGE_SINK, np.int32)
                # first block of the span each row may dirty (0 for a dead
                # row), as the JAX engine's verify scatter: MLA writes these
                # blocks of its gathered views back
                b0s = np.zeros((self.slots,), np.int32)
                for s in live:
                    pages = self.slot_pages[s]
                    ctx[s, :min(len(pages), n_ctx)] = pages[:n_ctx]
                    b0s[s] = min(int(pos_h[s]) // ps, n_ctx - nb_probe)
                # every candidate's page and slot (MLA writes its blocks
                # itself): a sink block a row writes becomes its scratch
                # page, and a position past the row's view goes to the trash
                # page, where JAX drops the write
                cpos = pos_h[:, None] + np.arange(C)[None, :]
                wpages = None
                if self._sink_pages:
                    ctx, wpages, seeds, winner = sink_plan(
                        ctx, cpos, b0s[:, None] + np.arange(nb_probe)[None, :], ps,
                        self.alloc.scratch)
                    seed_scratch(self.alloc.pools, seeds)
                    wpages = self._ids(wpages)
                ctx, woffs, b0s = self._ids(ctx), self._ids(cpos % ps), self._ids(b0s)
            logits = verify_chunk(
                self.cfg, self.params,
                torch.as_tensor(toks, device=self.device), self.cache["pos"],
                self.alloc.pools, ctx, wpages, woffs, state=self.cache, ckpts=ckpts,
                block0s=b0s, mesh=self._mesh)
            sink_take(self.alloc.pools, winner)
        else:
            logits, self.cache = verify_chunk_slab(
                self.cfg, self.params, torch.as_tensor(toks, device=self.device),
                self.cache, ckpts=ckpts, mesh=self._mesh)

        self.stats["decode_steps"] += 1
        self.stats["spec_rounds"] += 1
        self.stats["decode_slot_steps"] += len(live)
        self.stats["max_live"] = max(self.stats["max_live"], len(live))

        Y = self._greedy(logits).cpu().numpy()        # (slots, C)
        new_pos = pos_h.copy()
        restore = {}                    # slot -> tokens kept (Mamba1 rollback)
        for s in live:
            req, d, p0 = self.active[s], drafts[s], int(pos_h[s])
            m = 0
            while m < len(d) and int(Y[s, m]) == d[m]:
                m += 1
            emitted = d[:m] + [int(Y[s, m])]
            done, n_app = False, 0
            for i, t in enumerate(emitted):
                req.out.append(t)
                n_app = i + 1
                if t == req.eos_id or len(req.out) >= req.max_new or \
                        p0 + i + 1 >= self.max_len - 1:
                    done = True
                    break
            keep = n_app
            self.stats["draft_tokens"] += len(d)
            # count only accepted tokens actually emitted: when EOS/max_new/
            # max_len truncates mid-prefix, the tail never reached the output
            self.stats["accepted_tokens"] += min(m, n_app)
            req.draft_tokens += len(d)
            req.accepted_tokens += min(m, n_app)
            self.stats["decode_steps_saved"] += n_app - 1
            if not done and ckpts is not None:
                restore[s] = keep
            new_pos[s] = p0 + keep
            if done:
                self._finish(s, req)
            elif self.paged and self.alloc.pools:
                # page-truncate + ref-release the rejected suffix
                pages = self.slot_pages[s]
                end = min(p0 + true_c[s], len(pages) * ps)
                if p0 + keep < end:
                    truncate_pages(self.alloc.pools, pages, p0 + keep, end, ps)
                self.slot_pages[s] = release_trailing_pages(
                    self.alloc, pages, -(-(p0 + keep) // ps))
        if restore:
            self._restore_ckpt_rows(ckpts, restore)
        self.cache["pos"] = torch.as_tensor(new_pos.astype(np.int32),
                                            device=self.device)
        self._pos_h = new_pos
        self._note_kv_bytes()

    def _greedy(self, logits):
        """The greedy token of each row of a batched step's logits; on a
        mesh the rank's rows, all-gathered over `data` into every slot's."""
        tok = torch.argmax(logits, dim=-1)
        return tok if self._mesh is None else self._mesh.rows_cat(tok, self.slots)

    def _restore_ckpt_rows(self, ckpts: dict, keeps: dict):
        """Batched Mamba1 rollback (the JAX engine's `_restore_ckpt_rows`):
        every row in `keeps` gets the state after its kept tokens -- the scan
        state checkpointed at position keep - 1 and the conv window of raw
        inputs [keep, keep + K - 1) -- in one gather per buffer. On a mesh the
        rank restores the rows it holds."""
        if self._mesh is not None:
            local = {self._mesh.local_row(s, self.slots): k for s, k in keeps.items()}
            keeps = {r: k for r, k in local.items() if r is not None}
            if not keeps:
                return
        rows = torch.as_tensor(list(keeps), device=self.device)
        ks = torch.as_tensor(list(keeps.values()), device=self.device)
        km1 = self.cache["conv"].shape[2]
        win = ks[:, None] + torch.arange(km1, device=self.device)[None, :]
        self.cache["ssm"][:, rows] = ckpts["ssm"][:, rows, ks - 1]
        self.cache["conv"][:, rows] = ckpts["conv"][:, rows[:, None], win]

    def drain_slot(self, slot: int):
        """Evict + requeue (straggler/failure mitigation). Retries are
        bounded: past `req.max_retries` the request fails visibly into
        `self.failed` instead of requeueing forever."""
        if slot in self.active:
            req = self.active.pop(slot)
            self._live[slot] = False
            self._free_slot_pages(slot)
            if self.spec:
                self.drafter.on_free(slot)
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

    @property
    def free_slots(self) -> int:
        return self.slots - len(self.active) - len(self._inserting)

    def estimate_pages(self, prompt_len: int, max_new: int) -> int:
        """Pages the paged insert will demand up front for a prompt of this
        shape (0 for the slab layout and for Mamba1) -- the admission
        headroom check `serving/frontend.py` gates on."""
        if not (self.paged and self.alloc.pools):
            return 0
        total = self._extra + prompt_len
        cap = min(total if self.spec else total + max_new, self.max_len)
        return -(-cap // self.page_size)

    def pool_free_pages(self) -> Optional[int]:
        """Free pages in the KV pool (None off-paged and for Mamba1) --
        interface shared with `ReplicaGroup` so the frontend gates either
        uniformly."""
        if not (self.paged and self.alloc.pools):
            return None
        return self.alloc.free_pages

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
                if self.spec:
                    self.drafter.on_free(slot)
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
            decode = self._spec_step if self.spec else self._step
            if self.tracer.enabled(2):
                name = "engine.verify_round" if self.spec else "engine.decode_step"
                with self.tracer.span(name, kind="engine", level=2,
                                      live=len(self.active)):
                    decode()
            else:
                decode()
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
