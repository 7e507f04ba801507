"""Training step in PyTorch (counterpart of `repro.training.train_step`):
the cross-entropy loss, gradient clipping, optional microbatch gradient
accumulation and a `grad_transform` hook."""
from __future__ import annotations

import torch

from repro_torch.models import forward
from repro_torch.models.config import ModelConfig

from .optim import OptConfig, clip_by_global_norm, make_optimizer
from repro_torch.tree import flat, like


def cross_entropy(logits, labels, mask=None):
    """logits (B, S, V) any float dtype; labels (B, S) int. Computed in
    float32 with the row max under stop-gradient (`.detach()`); with
    `mask` (B, S) the masked mean over max(sum mask, 1)."""
    lf = logits.float()
    m = lf.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def make_loss_fn(cfg: ModelConfig, *, remat=True, aux_coef=None):
    """loss_fn(params, batch) -> (ce + aux_coef * aux, {"ce", "aux"}), on
    `forward`'s logits; aux_coef defaults to cfg.router_aux_coef. batch
    holds tensors on the parameters' device: "tokens", "labels", an
    optional "loss_mask" and the family's inputs (`forward`)."""
    aux_coef = cfg.router_aux_coef if aux_coef is None else aux_coef

    def loss_fn(params, batch):
        logits, aux = forward(cfg, params, batch, remat=remat)
        loss = cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
        return loss + aux_coef * aux, {"ce": loss, "aux": aux}

    return loss_fn


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, *, remat=True,
                    grad_transform=None, microbatch: int = 0):
    """Returns (init_opt_state, train_step).

    train_step(params, opt_state, batch) -> (params, opt_state, metrics):
    the gradients of the loss with respect to every parameter (made to
    require grad), `grad_transform(grads)` on the gradient tree
    (the parameters' structure) when given, clipping to opt_cfg.grad_clip
    (float32), then the optimizer, which writes the new parameters into
    `params` in place. batch values are numpy arrays or tensors, moved to
    the parameters' device. microbatch > 0 splits the batch along axis 0
    into B / microbatch parts, sums their float32 gradients and divides by
    the count, and reports aux as 0, as the JAX package does. metrics:
    "loss", "grad_norm", "ce", "aux", 0-d tensors.
    """
    loss_fn = make_loss_fn(cfg, remat=remat)
    init_fn, update_fn = make_optimizer(opt_cfg)

    def value_and_grad(params, batch):
        leaves = flat(params)
        for t in leaves:
            t.requires_grad_(True)
        loss, aux = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = like(params, [torch.zeros_like(t) if g is None else g
                              for t, g in zip(leaves, grads)])
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads

    def compute_grads(params, batch):
        if not microbatch:
            return value_and_grad(params, batch)
        n = batch["tokens"].shape[0] // microbatch
        acc, loss_sum = None, 0.0
        for i in range(n):
            part = {k: v[i * microbatch:(i + 1) * microbatch] for k, v in batch.items()}
            loss, _, grads = value_and_grad(params, part)
            g32 = flat(grads)
            acc = [torch.zeros(g.shape, dtype=torch.float32, device=g.device) + g
                   for g in g32] if acc is None else [a + g for a, g in zip(acc, g32)]
            loss_sum = loss_sum + loss
        grads = like(params, [a / n for a in acc])
        zero = torch.zeros((), dtype=torch.float32, device=loss_sum.device)
        return loss_sum / n, {"ce": loss_sum / n, "aux": zero}, grads

    def train_step(params, opt_state, batch):
        dev = flat(params)[0].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        loss, aux, grads = compute_grads(params, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
        params, opt_state = update_fn(grads, opt_state, params)
        metrics = {"loss": loss, "grad_norm": gnorm, **aux}
        return params, opt_state, metrics

    return init_fn, train_step
