"""Training in PyTorch (counterpart of `repro.training`): the loss and
train step (`train_step`), AdamW, Adafactor and 8-bit Adam (`optim`),
checkpoints in the JAX package's layout (`checkpoint`) and the crash-resume
`Trainer` (`driver`).

    from repro_torch.training import OptConfig, Trainer, TrainerConfig
    t = Trainer(cfg, OptConfig(), LMBatches(stream, batch=4, seq=512),
                TrainerConfig(total_steps=50, ckpt_dir="ckpt"))
    t.init()                      # or t.resume() from the latest checkpoint
    t.run()

On a (data, model) mesh, one process a rank: `Trainer(..., mesh=
make_test_mesh(2, 2), constrain=make_constrain(mesh, B))`; `resume()`
restores through `shardings` (default `train_shardings(cfg, opt_cfg,
mesh)`), so a checkpoint written on one mesh resumes on another.
"""
from .checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint, save_checkpoint
from .driver import CrashInjected, Trainer, TrainerConfig, train_shardings
from .optim import OptConfig, make_optimizer
from .train_step import cross_entropy, make_loss_fn, make_train_step

__all__ = ["AsyncCheckpointer", "CrashInjected", "OptConfig", "Trainer", "TrainerConfig",
           "cross_entropy", "latest_step", "make_loss_fn", "make_optimizer",
           "make_train_step", "restore_checkpoint", "save_checkpoint", "train_shardings"]
