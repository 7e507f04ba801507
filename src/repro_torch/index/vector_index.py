"""Vector indexes over L2 distance on L2-normalized embeddings (paper §4.2:
monotonically equivalent to cosine ranking).

`ExactIndex` is the oracle; `IVFIndex` (k-means coarse quantizer + nprobe)
is the scalable variant used at corpus scale. Both expose the same batched
contract — `search` (top-k), `range_search` (distance threshold tau/gamma),
and `range_search_many` (one fused pass over a probe batch, the API the
cross-document scheduler's `prefetch_segments` drives) — so either can back
a `TwoLevelRetriever` store. The hot loop delegates to
`repro_torch.kernels.ops.topk_l2`: kernel K3 on a CUDA device, its plain
PyTorch version on the CPU. Each index holds its rows as numpy arrays and
runs its searches on `device` (None = the CUDA device).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops

from .kmeans import kmeans


def _topk_l2(db, q: np.ndarray, k: int, device):
    return ops.topk_l2(db, q, k, device=device)


def _live_distance(emb: np.ndarray, ids: list, dead: np.ndarray,
                   q: np.ndarray, id_) -> float:
    """Distance to the *live* occurrence of `id_` (scanned newest-first:
    a re-added id's tombstoned old row never shadows the live one)."""
    for i in range(len(ids) - 1, -1, -1):
        if ids[i] == id_ and not dead[i]:
            return float(np.sqrt(((emb[i] - q) ** 2).sum()))
    raise ValueError(f"{id_!r} is not in the index")


class ExactIndex:
    """Exact store, now incrementally maintainable (DESIGN.md §17):
    `add` appends rows, `remove` tombstones them (searches filter dead
    rows), and compaction rebuilds the dense arrays once the dead fraction
    crosses `compact_ratio` — removal cost stays amortized O(1) per row
    instead of O(N) per mutation."""

    def __init__(self, embeddings: np.ndarray, ids: list | None = None, *,
                 compact_ratio: float = 0.25, device=None):
        self.device = resolve_device(device)
        self.emb = np.asarray(embeddings, np.float32)
        self._emb_dev = (None, None)     # (source array, its device copy)
        self.ids = list(ids) if ids is not None else list(range(len(self.emb)))
        self.compact_ratio = compact_ratio
        self._dead = np.zeros(len(self.ids), bool)
        self._n_dead = 0
        self.maint_stats = {"adds": 0, "removes": 0, "compactions": 0}

    def __len__(self):
        return len(self.ids) - self._n_dead

    # -------------------------------------------------------- maintenance --

    @property
    def n_tombstones(self) -> int:
        return self._n_dead

    def live_ids(self) -> list:
        if not self._n_dead:
            return list(self.ids)
        return [id_ for i, id_ in enumerate(self.ids) if not self._dead[i]]

    def add(self, embeddings: np.ndarray, ids: list) -> None:
        embs = np.atleast_2d(np.asarray(embeddings, np.float32))
        self.emb = embs.copy() if not len(self.ids) else \
            np.concatenate([self.emb, embs])
        self.ids.extend(ids)
        self._dead = np.concatenate([self._dead, np.zeros(len(embs), bool)])
        self.maint_stats["adds"] += len(embs)

    def remove(self, ids) -> int:
        """Tombstone every live row carrying one of `ids`; compacts when
        the dead fraction crosses `compact_ratio`. Returns rows removed."""
        idset = set(ids)
        n = 0
        for i, id_ in enumerate(self.ids):
            if id_ in idset and not self._dead[i]:
                self._dead[i] = True
                n += 1
        self._n_dead += n
        self.maint_stats["removes"] += n
        if self.ids and self._n_dead > self.compact_ratio * len(self.ids):
            self.compact()
        return n

    def compact(self) -> None:
        if not self._n_dead:
            return
        keep = ~self._dead
        self.emb = self.emb[keep]
        self.ids = [id_ for i, id_ in enumerate(self.ids) if keep[i]]
        self._dead = np.zeros(len(self.ids), bool)
        self._n_dead = 0
        self.maint_stats["compactions"] += 1

    # ------------------------------------------------------------- search --

    def search(self, q: np.ndarray, k: int):
        """q: (d,) or (m, d). Returns (ids, dists) per query."""
        q = np.atleast_2d(np.asarray(q, np.float32))
        k = min(k, len(self))
        if k == 0 or not len(self):
            return [([], [])] * len(q)
        # over-fetch by the tombstone count so dead rows can never displace
        # live ones from the top-k, then filter per row
        kk = min(k + self._n_dead, len(self.ids))
        dists, idx = _topk_l2(self._device_emb(), q, kk, self.device)
        out = []
        for row_d, row_i in zip(np.asarray(dists), np.asarray(idx)):
            if self._n_dead:
                keep = ~self._dead[np.asarray(row_i, int)]
                row_d, row_i = row_d[keep][:k], row_i[keep][:k]
            out.append(([self.ids[int(i)] for i in row_i], [float(d) for d in row_d]))
        return out

    def _device_emb(self):
        """The rows on the index's device, re-uploaded only after `add` /
        `compact` replaced the array."""
        src, dev = self._emb_dev
        if src is not self.emb:
            dev = torch.tensor(self.emb, device=self.device)
            self._emb_dev = (self.emb, dev)
        return dev

    def _ranked(self, qs: np.ndarray):
        """Full ascending ranking per query: (dists (M, N), idx (M, N)).
        Large databases go through the `kernels.topk_l2` kernel with k = N
        (same gate as kernels.ops.topk_l2); small ones use a numpy
        broadcast. Serial and batched range search share this helper, so
        they agree per query at every database size."""
        if len(self.ids) >= 256:
            dists, idx = _topk_l2(self._device_emb(), qs, len(self.ids),
                                  self.device)
            return np.asarray(dists), np.asarray(idx)
        d = np.sqrt(np.maximum(
            ((self.emb[None] - qs[:, None]) ** 2).sum(-1), 0.0))
        idx = np.argsort(d, axis=1)
        return np.take_along_axis(d, idx, axis=1), idx

    def range_search(self, q: np.ndarray, tau: float):
        """All ids with L2 distance < tau, sorted ascending by distance."""
        (out,) = self.range_search_many(np.asarray(q, np.float32)[None], [tau])
        return out

    def range_search_many(self, qs: np.ndarray, taus):
        """Batched range search: qs (M, D), taus length-M. One fused
        distance + rank pass for the whole probe batch — the vectorized
        path the cross-document scheduler uses to retrieve segments for a
        batch of (doc, attr) pairs at once."""
        qs = np.atleast_2d(np.asarray(qs, np.float32))
        if not len(self):
            return [([], [])] * len(qs)
        dists, idx = self._ranked(qs)
        out = []
        for row_d, row_i, tau in zip(dists, idx, taus):
            keep = row_d < tau
            if self._n_dead:
                keep = keep & ~self._dead[np.asarray(row_i, int)]
            out.append(([self.ids[int(i)] for i in row_i[keep]],
                        [float(d) for d in row_d[keep]]))
        return out

    def distance(self, q: np.ndarray, id_) -> float:
        return _live_distance(self.emb, self.ids, self._dead, q, id_)


class IVFIndex:
    """Inverted-file index: coarse k-means partitions, probe `nprobe` lists.

    Approximate; recall controlled by nprobe. Used for corpus-scale document/
    segment stores (paper cites PQ/HNSW — IVF is the TPU-friendly choice: the
    probed lists become dense tiles for the topk_l2 kernel)."""

    def __init__(self, embeddings: np.ndarray, ids: list | None = None,
                 n_lists: int = 16, nprobe: int = 4, seed: int = 0, *,
                 recluster_ratio: float = 0.5, compact_ratio: float = 0.25,
                 device=None):
        self.device = resolve_device(device)
        self.emb = np.asarray(embeddings, np.float32)
        self.ids = list(ids) if ids is not None else list(range(len(self.emb)))
        n_lists = max(1, min(n_lists, len(self.ids)))
        self.nprobe = max(1, min(nprobe, n_lists))
        centers, assign = kmeans(self.emb, n_lists, seed=seed,
                                 device=self.device)
        self.centers = np.array(centers, np.float32)  # writable: reclustering re-centers in place
        self.lists = [np.where(assign == c)[0] for c in range(len(self.centers))]
        # incremental maintenance (DESIGN.md §17): adds route to the nearest
        # center, removes tombstone; once a list's churn (adds+removes since
        # its last recluster) crosses recluster_ratio x its live size, that
        # list alone is re-centered and its members reassigned — bounded by
        # the list, never a global k-means rebuild.
        self.recluster_ratio = recluster_ratio
        self.compact_ratio = compact_ratio
        self._row_list = np.asarray(assign, np.int64).copy()  # row -> list
        self._dead = np.zeros(len(self.ids), bool)
        self._n_dead = 0
        self._churn = np.zeros(len(self.lists), np.int64)
        self.maint_stats = {"adds": 0, "removes": 0, "reclustered_lists": 0,
                            "migrated_rows": 0, "compactions": 0}

    def __len__(self):
        return len(self.ids) - self._n_dead

    # -------------------------------------------------------- maintenance --

    @property
    def n_tombstones(self) -> int:
        return self._n_dead

    def live_ids(self) -> list:
        if not self._n_dead:
            return list(self.ids)
        return [id_ for i, id_ in enumerate(self.ids) if not self._dead[i]]

    def add(self, embeddings: np.ndarray, ids: list) -> None:
        embs = np.atleast_2d(np.asarray(embeddings, np.float32))
        base = len(self.ids)
        self.emb = embs.copy() if not base else np.concatenate([self.emb, embs])
        self.ids.extend(ids)
        self._dead = np.concatenate([self._dead, np.zeros(len(embs), bool)])
        assign = np.argmin(
            ((self.centers[None] - embs[:, None]) ** 2).sum(-1), axis=1)
        self._row_list = np.concatenate([self._row_list, assign])
        touched = set()
        for off, li in enumerate(assign):
            li = int(li)
            self.lists[li] = np.append(self.lists[li], base + off)
            self._churn[li] += 1
            touched.add(li)
        self.maint_stats["adds"] += len(embs)
        for li in touched:
            self._maybe_recluster(li)

    def remove(self, ids) -> int:
        idset = set(ids)
        touched, n = set(), 0
        for i, id_ in enumerate(self.ids):
            if id_ in idset and not self._dead[i]:
                self._dead[i] = True
                li = int(self._row_list[i])
                self._churn[li] += 1
                touched.add(li)
                n += 1
        self._n_dead += n
        self.maint_stats["removes"] += n
        for li in touched:
            self._maybe_recluster(li)
        if self.ids and self._n_dead > self.compact_ratio * len(self.ids):
            self.compact()
        return n

    def _maybe_recluster(self, li: int) -> None:
        """Bounded per-list re-clustering: when churn crosses the ratio,
        drop the list's tombstoned rows, re-center it on its live members
        (k=1 k-means), and migrate members whose nearest center moved —
        work proportional to one list, never the whole index."""
        rows = self.lists[li]
        live = rows[~self._dead[rows]] if len(rows) else rows
        if self._churn[li] <= self.recluster_ratio * max(len(live), 1):
            return
        self._churn[li] = 0
        self.maint_stats["reclustered_lists"] += 1
        if not len(live):
            self.lists[li] = live
            return
        c = self.emb[live].mean(axis=0)
        self.centers[li] = c
        # reassign this list's members only (no recursive recluster: churn
        # lands on the target list and settles on its own threshold)
        assign = np.argmin(
            ((self.centers[None] - self.emb[live][:, None]) ** 2).sum(-1),
            axis=1)
        stay = live[assign == li]
        for row, tgt in zip(live[assign != li], assign[assign != li]):
            tgt = int(tgt)
            self.lists[tgt] = np.append(self.lists[tgt], row)
            self._row_list[row] = tgt
            self._churn[tgt] += 1
            self.maint_stats["migrated_rows"] += 1
        self.lists[li] = stay

    def compact(self) -> None:
        if not self._n_dead:
            return
        keep = ~self._dead
        new_row = np.cumsum(keep) - 1        # old row -> new row (keep only)
        self.emb = self.emb[keep]
        self.ids = [id_ for i, id_ in enumerate(self.ids) if keep[i]]
        self._row_list = self._row_list[keep]
        self.lists = [new_row[rows[keep[rows]]] if len(rows) else rows
                      for rows in self.lists]
        self._dead = np.zeros(len(self.ids), bool)
        self._n_dead = 0
        self.maint_stats["compactions"] += 1

    # ------------------------------------------------------------- search --

    def _probe(self, q: np.ndarray) -> np.ndarray:
        d = ((self.centers - q[None]) ** 2).sum(-1)
        lists = np.argsort(d)[: self.nprobe]
        rows = [self.lists[int(li)] for li in lists]
        rows = [r for r in rows if len(r)]
        probed = np.concatenate(rows) if rows else np.zeros((0,), np.int64)
        if self._n_dead and len(probed):
            probed = probed[~self._dead[probed]]
        return probed

    def _ranked_rows(self, q: np.ndarray):
        """Probed rows of one query, ranked ascending by distance: (rows,
        dists). Large probe sets go through the `kernels.topk_l2` kernel
        with k = |probed| (the same gate as `ExactIndex._ranked`); small
        ones use a numpy broadcast. `search`/`range_search`/
        `range_search_many` all share this helper."""
        rows = self._probe(q)
        if not len(rows):
            return rows, np.zeros((0,), np.float32)
        sub = self.emb[rows]
        if len(rows) >= 256:
            dists, idx = _topk_l2(sub, q[None], len(rows), self.device)
            d, order = np.asarray(dists)[0], np.asarray(idx)[0]
        else:
            d = np.sqrt(np.maximum(((sub - q[None]) ** 2).sum(-1), 0.0))
            order = np.argsort(d)
            d = d[order]
        return rows[order], d

    def search(self, q: np.ndarray, k: int):
        q = np.atleast_2d(np.asarray(q, np.float32))
        out = []
        for qq in q:
            rows, d = self._ranked_rows(qq)
            n = min(k, len(rows))
            out.append(([self.ids[int(r)] for r in rows[:n]],
                        [float(x) for x in d[:n]]))
        return out

    def range_search(self, q: np.ndarray, tau: float):
        (out,) = self.range_search_many(np.asarray(q, np.float32)[None], [tau])
        return out

    def range_search_many(self, qs: np.ndarray, taus):
        """Batched range search over the probed lists: qs (M, D), taus
        length-M. Same contract as `ExactIndex.range_search_many` (the
        scheduler's vectorized retrieval path), approximate by nprobe."""
        qs = np.atleast_2d(np.asarray(qs, np.float32))
        out = []
        for qq, tau in zip(qs, taus):
            rows, d = self._ranked_rows(qq)
            keep = d < tau
            out.append(([self.ids[int(r)] for r in rows[keep]],
                        [float(x) for x in d[keep]]))
        return out

    def distance(self, q: np.ndarray, id_) -> float:
        return _live_distance(self.emb, self.ids, self._dead, q, id_)
