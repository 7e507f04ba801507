"""Model assembly in PyTorch: parameters, chunked prefill and batched decode
on the paged KV pool (counterpart of `repro.models.model`, dense family).

Parameters are a nested dict of tensors with the JAX package's names and
shapes, except that the layer stack is a Python list of per-layer dicts
(the JAX package stacks layers on axis 0 for `lax.scan`; PyTorch runs the
layers in a loop). They are stored in `cfg.dtype` (the JAX package keeps
float32 and casts per call).

The length-indexed KV lives in pools shaped (L, P, ps, Hkv, D); the
serving engine owns them (`cache_ops.PageAllocator`). `prefill_chunk` and
`decode_step` write the new tokens' K/V into their pages in place and read
the context through page tables with kernels K2 and K1 -- no dense view is
gathered, and no page is scattered back.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device

from . import layers as L
from .config import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.use_mla or cfg.n_experts:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not yet ported, see ROADMAP.md "
            f"Queue 1 (the port serves the dense family)")


# ------------------------------------------------------------------ init ----


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None, dtype=None) -> dict:
    """Random parameters with the distributions of `repro.models.model.
    init_params` (normal * 0.02, output projections scaled by
    1/sqrt(2L), zero biases, unit norms), drawn from `generator` -- a
    different draw from JAX's, made on `device` in `dtype` (default
    cfg.dtype). A generator must live on `device`; None seeds one with 0."""
    _check_family(cfg)
    dev = resolve_device(device)
    dt = dtype or torch_dtype(cfg.dtype)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    d, hd, nq, nkv, ff = (cfg.d_model, cfg.resolved_head_dim, cfg.n_heads,
                          cfg.n_kv_heads, cfg.d_ff)
    out_std = 0.02 / math.sqrt(2 * cfg.num_layers)

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=dt).mul_(std)

    def ones(n):
        return {"w": torch.ones((n,), device=dev, dtype=dt)}

    def zeros(shape):
        return torch.zeros(shape, device=dev, dtype=dt)

    p = {"embed": normal((cfg.vocab_size, d), 0.02), "final_norm": ones(d)}
    if not cfg.tie_embeddings:
        p["lm_head"] = normal((d, cfg.vocab_size), 0.02)
    layers = []
    for _ in range(cfg.num_layers):
        attn = {"wq": normal((d, nq, hd), 0.02), "wk": normal((d, nkv, hd), 0.02),
                "wv": normal((d, nkv, hd), 0.02), "wo": normal((nq, hd, d), out_std)}
        if cfg.attn_bias:
            attn.update(bq=zeros((nq, hd)), bk=zeros((nkv, hd)), bv=zeros((nkv, hd)))
        if cfg.qk_norm:
            attn.update(q_norm=ones(hd)["w"], k_norm=ones(hd)["w"])
        mlp = {"w_down": normal((ff, d), out_std)}
        if cfg.gated_mlp:
            mlp.update(w_gate=normal((d, ff), 0.02), w_up=normal((d, ff), 0.02))
        else:
            mlp["w_in"] = normal((d, ff), 0.02)
        layers.append({"attn_norm": ones(d), "attn": attn, "mlp_norm": ones(d),
                       "mlp": mlp})
    p["layers"] = layers
    return p


def param_count(params) -> int:
    def count(t):
        if isinstance(t, dict):
            return sum(count(v) for v in t.values())
        if isinstance(t, list):
            return sum(count(v) for v in t)
        return t.numel()
    return count(params)


def _head(cfg: ModelConfig, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _mlp_block(cfg, lp, x):
    return x + L.mlp_apply(cfg, lp["mlp"], L.norm_apply(cfg, lp["mlp_norm"], x))


# ------------------------------------------------------------- decode ------


def decode_step(cfg: ModelConfig, params, tokens, pos, pools, table, write_pages):
    """One batched decode step on the page pool.

    tokens (B, 1) int; pos (B,) int32 -- row b's token sits at position
    pos[b]; table (B, nb) int32 page tables; write_pages (B,) the page that
    holds position pos[b] (the sink page for a dead row). Writes each
    layer's K/V at (write_pages[b], pos[b] % ps) and attends positions
    < pos[b] + 1 with kernel K1. Returns logits (B, 1, V); the caller
    advances pos.
    """
    _check_family(cfg)
    ps = pools["k"].shape[2]
    wp = write_pages.long()
    offs = (pos % ps).long()
    x = params["embed"][tokens.long()]
    for li, lp in enumerate(params["layers"]):
        h = L.norm_apply(cfg, lp["attn_norm"], x)
        x = x + L.attn_decode_apply(cfg, lp["attn"], h, pos=pos,
                                    k_pool=pools["k"][li], v_pool=pools["v"][li],
                                    table=table, write_pages=wp, write_offsets=offs)
        x = _mlp_block(cfg, lp, x)
    x = L.norm_apply(cfg, params["final_norm"], x)
    return x @ _head(cfg, params)


# ------------------------------------------------------- chunked prefill ---


def prefill_chunk(cfg: ModelConfig, params, tokens, start: int, length: int,
                  pools, ctx_ids):
    """Advance one sequence through a C-token prompt chunk on the page pool.

    tokens (1, C) int, right-padded past `length` real tokens; the chunk
    sits at positions [start, start+C); ctx_ids (n_ctx,) int32 is the
    sequence's page table, covering every position up to start+C-1. Each
    layer's chunk K/V is written into its pages (padded positions write
    harmless garbage past the true end, which later chunks and decode
    overwrite before any query may attend them), then kernel K2 attends
    the context causally. Returns the logits (1, 1, V) at the last real
    position; the sequence's position advances by `length`.
    """
    _check_family(cfg)
    ps = pools["k"].shape[2]
    C = tokens.shape[1]
    positions = start + torch.arange(C, device=ctx_ids.device)
    wp = ctx_ids[positions // ps].long()
    offs = positions % ps
    x = params["embed"][tokens.long()]
    for li, lp in enumerate(params["layers"]):
        h = L.norm_apply(cfg, lp["attn_norm"], x)
        x = x + L.attn_chunk_apply(cfg, lp["attn"], h, start=start,
                                   k_pool=pools["k"][li], v_pool=pools["v"][li],
                                   ctx_ids=ctx_ids, write_pages=wp,
                                   write_offsets=offs)
        x = _mlp_block(cfg, lp, x)
    x = L.norm_apply(cfg, params["final_norm"], x[:, length - 1:length])
    return x @ _head(cfg, params)
