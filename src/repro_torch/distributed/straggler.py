"""Straggler mitigation for QUEST query execution (DESIGN.md §6).

Documents are partitioned into work units processed by a worker pool; a
deadline-based reissuer duplicates units whose worker exceeds the p95-based
deadline, and the first completion wins (duplicate suppression). The same
pattern drives the serving engine's eviction path at the request level.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable


@dataclass
class WorkUnit:
    uid: int
    payload: object
    attempts: int = 0


@dataclass
class PoolStats:
    completed: int = 0
    reissued: int = 0
    duplicates_suppressed: int = 0
    wall_s: float = 0.0


def run_with_stragglers(units: Iterable, fn: Callable, *, n_workers: int = 4,
                        deadline_factor: float = 3.0, min_deadline_s: float = 0.05,
                        poll_s: float = 0.005, worker_delay=None) -> tuple:
    """Executes fn(payload) per unit with duplicate-on-deadline.

    worker_delay(worker_id) -> extra sleep per unit (test hook to simulate a
    slow node). Returns (results dict uid->value, PoolStats)."""
    t0 = time.time()
    units = [WorkUnit(i, p) for i, p in enumerate(units)]
    todo: "queue.Queue" = queue.Queue()
    for u in units:
        todo.put(u)
    results: dict = {}
    started: dict = {}
    durations: list = []
    lock = threading.Lock()
    stats = PoolStats()
    stop = threading.Event()

    def worker(wid: int):
        while not stop.is_set():
            try:
                u = todo.get(timeout=poll_s)
            except queue.Empty:
                continue
            with lock:
                if u.uid in results:
                    stats.duplicates_suppressed += 1
                    continue
                started[u.uid] = time.time()
            if worker_delay is not None:
                time.sleep(worker_delay(wid))
            val = fn(u.payload)
            with lock:
                if u.uid in results:
                    stats.duplicates_suppressed += 1
                else:
                    results[u.uid] = val
                    stats.completed += 1
                    durations.append(time.time() - started.get(u.uid, time.time()))

    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(n_workers)]
    for t in threads:
        t.start()

    # reissue loop
    while True:
        with lock:
            if len(results) >= len(units):
                break
            if durations:
                med = sorted(durations)[len(durations) // 2]
                deadline = max(min_deadline_s, deadline_factor * med)
            else:
                deadline = None
            now = time.time()
            for u in units:
                if u.uid in results or u.uid not in started:
                    continue
                if deadline is not None and now - started[u.uid] > deadline \
                        and u.attempts == 0:
                    u.attempts += 1
                    stats.reissued += 1
                    todo.put(WorkUnit(u.uid, u.payload, attempts=1))
        time.sleep(poll_s)
    stop.set()
    for t in threads:
        t.join(timeout=1.0)
    stats.wall_s = time.time() - t0
    return results, stats
