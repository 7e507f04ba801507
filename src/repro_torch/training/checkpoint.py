"""Checkpoints in the JAX package's layout (counterpart of
`repro.training.checkpoint`): <dir>/step_<n>/{payload.npz, manifest.json},
written into a tmp directory and renamed into place, with an `extra` dict
in the manifest.

The payload's keys are the JAX `keystr` paths of the tree (for a trainer,
{"params", "opt"}), with each layer stack stacked on axis 0 as in the JAX
package (`tree.leaves`), so a checkpoint either package writes is one the
other can read. Arrays are copied to the host (`.cpu().numpy()` copies)
before the writer thread starts; a bfloat16 tensor has no numpy dtype, so
trees are saved with float32 masters.

From a mesh (`shardings=`, a tree of `distributed.sharding.Sharding` of
the tree's structure) every rank gathers the global arrays, a collective,
and rank 0 writes them: the file is the one a single device writes, and
either package reads it. `restore_checkpoint(..., shardings=)` cuts each
rank's shards out of the global arrays for a mesh that may differ from
the writer's (the elastic restore).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import at, keystr, leaves, map_leaves


def _host(t) -> np.ndarray:
    return t.detach().to("cpu", copy=True).numpy()


def host_arrays(tree) -> dict:
    """{JAX keystr path: numpy copy}, layer stacks stacked on axis 0."""
    return {path: np.stack([_host(t) for t in group]) if stacked else _host(group[0])
            for path, group, stacked in leaves(tree)}


def _write(ckpt_dir, step: int, arrays: dict, extra: dict | None):
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}_{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    np.savez(tmp / "payload.npz", **arrays)
    manifest = {"step": step, "time": time.time(), "extra": extra or {},
                "keys": sorted(arrays)}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def _global(tree, shardings):
    """The global tensors of a tree of shards (a collective), or the tree
    itself without `shardings`."""
    if shardings is None:
        return tree
    return map_leaves(lambda keys, index, t: at(shardings, keys, index).whole(t), tree)


def _writer(shardings) -> bool:
    return shardings is None or dist.get_rank() == 0


def save_checkpoint(ckpt_dir, step: int, tree, extra: dict | None = None, shardings=None):
    """Synchronous save; keeps every step directory. Returns its path.
    With `shardings` every rank calls it, and rank 0 writes the global
    arrays (the others return None)."""
    arrays = host_arrays(_global(tree, shardings))
    return _write(ckpt_dir, step, arrays, extra) if _writer(shardings) else None


class AsyncCheckpointer:
    """Fire-and-forget saver: the tree is copied to the host, then written
    on a worker thread, so the train loop never blocks on disk. With
    `shardings` the global arrays are gathered first (every rank calls
    `save`) and rank 0 writes."""

    def __init__(self, ckpt_dir):
        self.ckpt_dir = Path(ckpt_dir)
        self._thread = None

    def save(self, step: int, tree, extra=None, shardings=None):
        arrays = host_arrays(_global(tree, shardings))   # snapshot before mutation
        self.wait()
        if not _writer(shardings):
            return
        self._thread = threading.Thread(
            target=_write, args=(self.ckpt_dir, step, arrays, extra), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*"))
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir, step: int, like_tree, shardings=None):
    """(a tree of `like_tree`'s structure holding the checkpoint's arrays,
    each on its `like_tree` tensor's device, in the stored dtype; the
    manifest's extra dict). With `shardings` (`Sharding`s of the current
    mesh, of `like_tree`'s structure) each leaf is this rank's shard of the
    stored global array."""
    path = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    with np.load(path / "payload.npz") as payload:
        arrays = {k: payload[k] for k in payload.files}

    def load(keys, index, like):
        arr = arrays[keystr(keys)]
        t = torch.from_numpy(np.array(arr if index is None else arr[index]))
        if shardings is not None:
            t = at(shardings, keys, index).local(t).contiguous()
        return t.to(like.device)
    return map_leaves(load, like_tree), manifest["extra"]
