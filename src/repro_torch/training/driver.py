"""Fault-tolerant training driver in PyTorch (counterpart of
`repro.training.driver`): the step loop, periodic async checkpoints and a
bit-exact resume (parameters, optimizer state and the data cursor are all
in the checkpoint). A `failure_at` hook simulates a node crash mid-run for
the restart tests; `resume()` continues from the latest checkpoint, which
either package may have written (`checkpoint`).

The trainer runs on the CUDA device when `device=None` and raises without
one; `device="cpu"` runs the plain PyTorch path. Parameters are float32
masters (`init_params(..., dtype=torch.float32)` from a generator seeded
with `TrainerConfig.seed`); the forward casts them to the model dtype.

On a (data, model) mesh (`mesh=`, a `launch.mesh` DeviceMesh over the
started process group; one process a rank) every rank draws the same
global parameters as one device, keeps its shards (`shard_params`) and
the shards of the optimizer state, and runs the global batch's rows of
its `data` coordinate (`train_step.make_train_step(mesh=)`). Checkpoints
hold the global arrays (gathered, rank 0 writes), so `resume()` restores
through `shardings` onto a mesh of any shape. The JAX `jit_kwargs` has no
meaning in eager PyTorch and is not taken.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (MeshParams, MeshRank, opt_state_shardings,
                                              param_shardings, param_specs, shard_params)
from repro_torch.launch.mesh import mesh_device
from repro_torch.models import init_params
from repro_torch.models.config import ModelConfig

from .checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from .optim import OptConfig, make_optimizer
from .train_step import make_train_step


class CrashInjected(RuntimeError):
    pass


@dataclass
class TrainerConfig:
    """The JAX `TrainerConfig`, except that `ckpt_dir` has no default and
    is given by keyword: `resume()` reads the latest checkpoint there, so
    two runs that shared a fixed default would resume each other's."""
    total_steps: int = 50
    ckpt_every: int = 10
    ckpt_dir: str = field(kw_only=True)
    seed: int = 0
    log_every: int = 10


def train_shardings(cfg: ModelConfig, opt_cfg: OptConfig, mesh) -> dict:
    """{"params", "opt"}: the `Sharding` trees of a trainer's state on
    `mesh`, from the global shapes on the meta device (nothing allocated):
    what `Trainer(shardings=)` restores through."""
    params = init_params(cfg, device="meta", dtype=torch.float32)
    pspecs = param_specs(cfg, params, mesh)
    opt = make_optimizer(opt_cfg)[0](params)
    return {"params": param_shardings(cfg, params, mesh),
            "opt": opt_state_shardings(cfg, opt, pspecs, mesh)}


class Trainer:
    def __init__(self, cfg: ModelConfig, opt_cfg: OptConfig, data, tcfg: TrainerConfig,
                 *, constrain=None, grad_transform=None, shardings=None, mesh=None,
                 device=None):
        self.cfg, self.opt_cfg, self.data, self.tcfg = cfg, opt_cfg, data, tcfg
        self.mesh, self.constrain, self.grad_transform = mesh, constrain, grad_transform
        self.device = mesh_device(mesh) if mesh is not None else resolve_device(device)
        if mesh is not None and shardings is None:
            shardings = train_shardings(cfg, opt_cfg, mesh)
        self.shardings = shardings
        self.tp = None
        self._init_opt, self.train_step = self._make_step()
        self.ckpt = AsyncCheckpointer(tcfg.ckpt_dir)
        self.params = None
        self.opt_state = None
        self.step = 0
        self.history = []

    def _make_step(self):
        return make_train_step(self.cfg, self.opt_cfg, remat=False, constrain=self.constrain,
                               grad_transform=self.grad_transform, mesh=self.tp)

    # ------------------------------------------------------------ state ---

    def init(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = init_params(self.cfg, gen, device=self.device, dtype=torch.float32)
        if self.mesh is not None:
            params = shard_params(self.cfg, params, self.mesh)
            self.tp = MeshRank(self.cfg, params, None)
            self._init_opt, self.train_step = self._make_step()
        self.params = params
        self.opt_state = self._init_opt(self.params)
        self.step = 0

    def state_tree(self):
        return {"params": self.params, "opt": self.opt_state}

    def resume(self) -> bool:
        last = latest_step(self.tcfg.ckpt_dir)
        if last is None:
            return False
        if self.params is None:
            self.init()
        tree, extra = restore_checkpoint(self.tcfg.ckpt_dir, last, self.state_tree(),
                                         shardings=self.shardings)
        params = tree["params"]
        if self.mesh is not None:
            params = MeshParams(params, self.params.specs, self.mesh)
        self.params, self.opt_state = params, tree["opt"]
        self.step = extra["step"]
        self.data.restore(extra["data"])
        return True

    # -------------------------------------------------------------- run ---

    def run(self, *, failure_at: int | None = None):
        assert self.params is not None, "call init() or resume() first"
        while self.step < self.tcfg.total_steps:
            if failure_at is not None and self.step == failure_at:
                raise CrashInjected(f"injected failure at step {self.step}")
            batch = self.data.next()
            self.params, self.opt_state, metrics = self.train_step(
                self.params, self.opt_state, batch)
            self.step += 1
            loss = float(metrics["loss"])
            self.history.append(loss)
            if self.step % self.tcfg.log_every == 0:
                print(f"step {self.step}: loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f}", flush=True)
            if self.step % self.tcfg.ckpt_every == 0:
                self.ckpt.save(self.step, self.state_tree(),
                               extra={"step": self.step,
                                      "data": self.data.snapshot()},
                               shardings=self.shardings if self.mesh is not None else None)
        self.ckpt.wait()
        return self.history
