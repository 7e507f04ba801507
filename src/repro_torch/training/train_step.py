"""Training step in PyTorch (counterpart of `repro.training.train_step`):
the cross-entropy loss, gradient clipping, optional microbatch gradient
accumulation and a `grad_transform` hook.

On a (data, model) mesh (`mesh=`, a `distributed.sharding.MeshRank` over
the rank's `shard_params`) each rank runs its rows of the global batch
(`models.model.forward(mesh=)`), and its loss is its share of the global
one: the sum of its rows' token losses over the global token count, so
the shares sum over `data` to the mean over the global batch. Where every
rank runs every row (the moe family without grouped dispatch, or a batch
that `data` does not divide) each rank's share is the loss over n_data.
The gradient of the share is the rank's term of the global gradient: the
FSDP gathers' backward sums the `data`-sharded leaves' terms, and
`MeshRank.sync_grads` the replicated leaves'. The logits over a
`model`-sharded vocabulary are gathered whole before the loss, on every
`model` rank, rather than reduced as a log-sum-exp of partial sums and a
max over `model`: the gather keeps one card's arithmetic. Its cost is the
whole float32 logits on each rank, B S V x 4 bytes (1.24 GB at
qwen2.5-3b's V 151,936 and 4 x 512 tokens), where the partial sums would
hold 1 / n_model of it (0.31 GB at n_model 4)."""
from __future__ import annotations

import torch

from repro_torch.models import forward
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import moe_groups
from repro_torch.tree import flat, like

from .optim import OptConfig, clip_by_global_norm, make_optimizer


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


def make_loss_fn(cfg: ModelConfig, *, remat=True, constrain=None, aux_coef=None, mesh=None):
    """loss_fn(params, batch) -> (ce + aux_coef * aux, {"ce", "aux"}), on
    `forward`'s logits; aux_coef defaults to cfg.router_aux_coef. batch
    holds tensors on the parameters' device: "tokens", "labels", an
    optional "loss_mask" and the family's inputs (`forward`).

    On a mesh (`mesh`, with `constrain`: `forward`'s) the first value is
    this rank's share of the loss (the module docstring), whose gradient
    is the rank's term of the global gradient, and "ce" the global cross-
    entropy (the shares summed over `data`, no gradient)."""
    aux_coef = cfg.router_aux_coef if aux_coef is None else aux_coef

    def loss_fn(params, batch):
        logits, aux = forward(cfg, params, batch, remat=remat, constrain=constrain,
                              mesh=mesh)
        if mesh is None:
            loss = cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
            return loss + aux_coef * aux, {"ce": loss, "aux": aux}
        B, S = batch["tokens"].shape
        rows, _ = mesh.train_rows(cfg, B, moe_groups(B * S), constrain)
        mask = batch.get("loss_mask")
        mask = None if mask is None else mask[rows]
        ce = cross_entropy(logits, batch["labels"][rows], mask)
        # the rank's share of the global mean: its own mean times its share
        # of the global token count (1 on a mesh of one rank, so one card's
        # arithmetic bit for bit), or 1 / n_data where every rank has every row
        count = torch.as_tensor(float(logits.shape[0] * logits.shape[1]), device=ce.device) \
            if mask is None else mask.float().sum()
        whole = rows.stop - rows.start == B
        share = count / mesh.data_sum(count) if not whole else 1.0 / mesh.n_data
        part = ce * share
        return part + aux_coef * aux * share, {"ce": mesh.data_sum(part.detach()),
                                               "aux": aux.detach()}

    return loss_fn


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, *, remat=True, constrain=None,
                    grad_transform=None, microbatch: int = 0, mesh=None):
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

    On a mesh (`mesh`, a `MeshRank`; `params` and the state the rank's
    shards, `init_opt_state` cutting the global state) `batch` is the
    global batch, and `constrain` (`make_constrain(mesh, B)`) picks the
    rank's rows. The loss is the rank's share (`make_loss_fn`), the
    gradients are summed over `data` (`MeshRank.sync_grads`), `grad_transform`
    runs on the rank's shards (`distributed.compression.make_pod_grad_sync`
    over a `pod` axis: each pod's (data, model) mesh syncs with the
    others'), and the norm and the optimizer have the global semantics
    (`optim`). With `microbatch`, part i is the global rows [i mb,
    (i + 1) mb), as the JAX step's reshape of the batch, and each rank runs
    its rows of it (`make_constrain(mesh, mb)`). The metrics are global.
    """
    loss_fn = make_loss_fn(cfg, remat=remat, constrain=constrain, mesh=mesh)
    part_loss_fn = make_loss_fn(cfg, remat=remat, mesh=mesh)
    init_fn, update_fn = make_optimizer(opt_cfg, mesh)

    def value_and_grad(params, batch, fn):
        leaves = flat(params)
        for t in leaves:
            t.requires_grad_(True)
        loss, aux = fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = like(params, [torch.zeros_like(t) if g is None else g
                              for t, g in zip(leaves, grads)])
        loss = loss.detach() if mesh is None else mesh.data_sum(loss.detach())
        return loss, {k: v.detach() for k, v in aux.items()}, grads

    def compute_grads(params, batch):
        if not microbatch:
            return value_and_grad(params, batch, loss_fn)
        n = batch["tokens"].shape[0] // microbatch
        acc, loss_sum = None, 0.0
        for i in range(n):
            part = {k: v[i * microbatch:(i + 1) * microbatch] for k, v in batch.items()}
            loss, _, grads = value_and_grad(params, part, part_loss_fn)
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
        if mesh is not None:
            grads = mesh.sync_grads(grads)
        if grad_transform is not None:
            grads = grad_transform(grads)
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip, mesh)
        params, opt_state = update_fn(grads, opt_state, params)
        metrics = {"loss": loss, "grad_norm": gnorm, **aux}
        return params, opt_state, metrics

    return init_fn, train_step
