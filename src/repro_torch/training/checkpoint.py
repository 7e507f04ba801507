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

from repro_torch.tree import keystr, leaves, map_leaves


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


def save_checkpoint(ckpt_dir, step: int, tree, extra: dict | None = None):
    """Synchronous save; keeps every step directory. Returns its path."""
    return _write(ckpt_dir, step, host_arrays(tree), extra)


class AsyncCheckpointer:
    """Fire-and-forget saver: the tree is copied to the host, then written
    on a worker thread, so the train loop never blocks on disk."""

    def __init__(self, ckpt_dir):
        self.ckpt_dir = Path(ckpt_dir)
        self._thread = None

    def save(self, step: int, tree, extra=None):
        arrays = host_arrays(tree)               # snapshot before mutation
        self.wait()
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


def restore_checkpoint(ckpt_dir, step: int, like_tree):
    """(a tree of `like_tree`'s structure holding the checkpoint's arrays,
    each on its `like_tree` tensor's device, in the stored dtype; the
    manifest's extra dict)."""
    path = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    with np.load(path / "payload.npz") as payload:
        arrays = {k: payload[k] for k in payload.files}

    def load(keys, index, like):
        arr = arrays[keystr(keys)]
        arr = arr if index is None else arr[index]
        return torch.from_numpy(np.array(arr)).to(like.device)
    return map_leaves(load, like_tree), manifest["extra"]
