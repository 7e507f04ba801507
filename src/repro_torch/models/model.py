"""Model assembly in PyTorch: parameters, and the forward passes of the
serving engine on both KV layouts (counterpart of `repro.models.model`:
the dense family, the Mamba1 ssm family, and the moe family with MLA
attention).

Parameters are a nested dict of tensors with the JAX package's names and
shapes, except that each layer stack is a Python list of per-layer dicts
(the JAX package stacks layers on axis 0 for `lax.scan`; PyTorch runs the
layers in a loop). They are stored in `cfg.dtype` (the JAX package keeps
float32 and casts per call). The moe family keeps two stacks, as the JAX
package: "dense_layers" (the first `first_dense_layers`, with an MLP) and
"layers" (MoE); cache and pool index li runs over both, dense first.

Paged layout: the length-indexed KV lives in pools shaped (L, P, ps, Hkv,
D); the serving engine owns them (`cache_ops.PageAllocator`).
`prefill_chunk`, `decode_step` and `verify_chunk` write the new tokens'
K/V into their pages in place and read the context through page tables
with kernels K2, K1 and K4 -- no dense view is gathered, and no page is
scattered back.

Slab layout: a decode cache {"pos", "k", "v"} with k/v (L, B, max_len,
Hkv, D), as the JAX `init_decode_cache` makes it. The JAX functions map to
these: `init_decode_cache` -> `init_decode_cache`, `prefill` -> `prefill`,
slab `decode_step` -> `decode_step_slab` (kernel K5) and slab
`verify_chunk` -> `verify_chunk_slab` (kernel K4 over the slab seen as
pages; `prefill` runs K2 the same way). They write K/V into the cache's
tensors in place and return the dict with its new `pos`, where the JAX
functions return an updated copy.

Mamba1 (`family="ssm"`, falcon-mamba-7b) keeps no length-indexed KV: its
state is the conv window "conv" (L, B, K-1, di) in the model dtype and the
scan state "ssm" (L, B, di, N) in float32 (`init_state_cache`). The paged
functions take that state as `state=` (the engine's per-slot cache, or a
request's B=1 state while it prefills) and update it in place; the pools
and page tables go unused. The slab functions keep it in the cache dict.
Chunked prefill, whole-prompt prefill and verify run the selective scan
through kernel K7; verify also fills `ckpts` -- "ssm" (L, B, C, di, N),
the state after every position, and "conv" (L, B, K-1+C, di), the raw
input history -- which the engine restores a rejected suffix from
(`init_verify_ckpts` allocates them once).

MoE with MLA (`family="moe"`, `use_mla`, deepseek-v2-lite-16b) keeps the
compressed cache "ckv" (L, B, max_len, r) and "krope" (L, B, max_len, rd)
on the slab, and pools of the same two keys on the paged layout. Its
attention is plain PyTorch (`layers.mla_*`): the paged forms gather each
row's view through its page table and write the dirtied blocks back as the
JAX engine does, which is why `verify_chunk` takes the engine's `block0s`.
Every MoE layer gates through kernel K6.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device

from . import layers as L
from . import ssm as S
from .config import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family == "dense" and not (cfg.use_mla or cfg.n_experts):
        return
    if cfg.family == "ssm" and cfg.mamba_version == 1:
        return
    if cfg.family == "moe" and cfg.use_mla:
        return
    if cfg.family == "moe":
        raise NotImplementedError(
            "MoE without MLA attention (grok-1-314b) is not yet ported, see "
            "ROADMAP.md Queue 1")
    raise NotImplementedError(
        f"model family {cfg.family!r} is not yet ported, see ROADMAP.md "
        f"Queue 1 (the port serves the dense family, Mamba1 and MoE with MLA)")


# ------------------------------------------------------------------ init ----


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None, dtype=None) -> dict:
    """Random parameters with the distributions of `repro.models.model.
    init_params` (normal * 0.02, output projections scaled by
    1/sqrt(2L), zero biases, unit norms; Mamba1 blocks as `ssm.
    mamba1_init`, drawn in float32; MLA and MoE blocks as `mla_init` and
    `moe_init`), drawn from `generator` -- a different
    draw from JAX's, made on `device` in `dtype` (default cfg.dtype). A
    generator must live on `device`; None seeds one with 0. On the meta
    device nothing is drawn: the shapes alone, for `param_count` at full
    width."""
    _check_family(cfg)
    dev = resolve_device(device)
    dt = dtype or torch_dtype(cfg.dtype)
    if generator is None and dev.type != "meta":     # meta: shapes only
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
    if cfg.family == "ssm":
        p["layers"] = [{"norm": ones(d), "mamba": S.mamba1_init(cfg, generator, dev, dt)}
                       for _ in range(cfg.num_layers)]
        return p

    def mlp():
        m = {"w_down": normal((ff, d), out_std)}
        if cfg.gated_mlp:
            m.update(w_gate=normal((d, ff), 0.02), w_up=normal((d, ff), 0.02))
        else:
            m["w_in"] = normal((d, ff), 0.02)
        return m

    if cfg.family == "moe":
        r, nd, rd, vd = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        E, eff = cfg.n_experts, cfg.expert_d_ff or cfg.d_ff

        def block(moe):
            b = {"attn_norm": ones(d),
                 "attn": {"wq": normal((d, nq, nd + rd), 0.02),
                          "w_dkv": normal((d, r + rd), 0.02),
                          "w_uk": normal((r, nq, nd), 0.02),
                          "w_uv": normal((r, nq, vd), 0.02),
                          "wo": normal((nq, vd, d), out_std), "kv_norm": ones(r)["w"]},
                 "mlp_norm": ones(d)}
            if not moe:
                b["mlp"] = mlp()
                return b
            b["moe"] = {"router": normal((d, E), 0.02), "w_gate": normal((E, d, eff), 0.02),
                        "w_up": normal((E, d, eff), 0.02),
                        "w_down": normal((E, eff, d), out_std)}
            if cfg.n_shared_experts:
                sh = eff * cfg.n_shared_experts
                b["moe"]["shared"] = {"w_gate": normal((d, sh), 0.02),
                                      "w_up": normal((d, sh), 0.02),
                                      "w_down": normal((sh, d), out_std)}
            return b
        nd_layers = cfg.first_dense_layers
        if nd_layers:
            p["dense_layers"] = [block(False) for _ in range(nd_layers)]
        p["layers"] = [block(True) for _ in range(cfg.num_layers - nd_layers)]
        return p
    layers = []
    for _ in range(cfg.num_layers):
        attn = {"wq": normal((d, nq, hd), 0.02), "wk": normal((d, nkv, hd), 0.02),
                "wv": normal((d, nkv, hd), 0.02), "wo": normal((nq, hd, d), out_std)}
        if cfg.attn_bias:
            attn.update(bq=zeros((nq, hd)), bk=zeros((nkv, hd)), bv=zeros((nkv, hd)))
        if cfg.qk_norm:
            attn.update(q_norm=ones(hd)["w"], k_norm=ones(hd)["w"])
        layers.append({"attn_norm": ones(d), "attn": attn, "mlp_norm": ones(d),
                       "mlp": mlp()})
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


def _blocks(params) -> list:
    """Every attention block in cache order: the moe family's dense layers
    first, then its MoE layers (the JAX package concatenates their caches
    so)."""
    return params.get("dense_layers", []) + params["layers"]


def _trunk(cfg, params, x, attend):
    """Run the attention blocks: x + attend(li, attn params, normed x), then
    the MLP or MoE feed-forward on the residual."""
    for li, lp in enumerate(_blocks(params)):
        x = x + attend(li, lp["attn"], L.norm_apply(cfg, lp["attn_norm"], x))
        h = L.norm_apply(cfg, lp["mlp_norm"], x)
        x = x + (L.moe_apply(cfg, lp["moe"], h) if "moe" in lp
                 else L.mlp_apply(cfg, lp["mlp"], h))
    return x


# ------------------------------------------------------ Mamba1 (ssm) -------


def init_state_cache(cfg: ModelConfig, B: int, dtype=None, device=None) -> dict:
    """The per-slot state that is not indexed by token position: for
    Mamba1 the conv window (L, B, K-1, di) in `dtype` (default cfg.dtype)
    and the scan state (L, B, di, N) float32, zeros; the dense family has
    none."""
    _check_family(cfg)
    if cfg.family != "ssm":
        return {}
    dev = resolve_device(device)
    dt = dtype or torch_dtype(cfg.dtype)
    return {"conv": torch.zeros((cfg.num_layers, B, cfg.ssm_conv - 1, cfg.d_inner),
                                dtype=dt, device=dev),
            "ssm": torch.zeros((cfg.num_layers, B, cfg.d_inner, cfg.ssm_state),
                               dtype=torch.float32, device=dev)}


def init_verify_ckpts(cfg: ModelConfig, B: int, C: int, dtype=None, device=None) -> dict:
    """Buffers a Mamba1 verify forward of B rows x C candidates fills with
    its rollback checkpoints: "ssm" (L, B, C, di, N) float32, the state
    after every position, and "conv" (L, B, K-1+C, di), the raw input
    history with the carried window. Allocated once and reused: at
    falcon-mamba-7b's width and B = 4, C = 5 they hold ~0.7 GB."""
    dev = resolve_device(device)
    dt = dtype or torch_dtype(cfg.dtype)
    Lc, di = cfg.num_layers, cfg.d_inner
    return {"ssm": torch.empty((Lc, B, C, di, cfg.ssm_state), dtype=torch.float32,
                               device=dev),
            "conv": torch.empty((Lc, B, cfg.ssm_conv - 1 + C, di), dtype=dt, device=dev)}


def _logits(cfg, params, x):
    return L.norm_apply(cfg, params["final_norm"], x) @ _head(cfg, params)


def _ssm_decode(cfg, params, tokens, state):
    """One Mamba1 decode step of every row of `state` (plain tensor ops, as
    the JAX step), updating its conv and ssm in place."""
    x = params["embed"][tokens.long()]
    for li, lp in enumerate(params["layers"]):
        y, state["conv"][li], state["ssm"][li] = S.mamba1_decode(
            cfg, lp["mamba"], L.norm_apply(cfg, lp["norm"], x),
            conv_state=state["conv"][li], ssm_state=state["ssm"][li])
        x = x + y
    return _logits(cfg, params, x)


def _ssm_chunk(cfg, params, tokens, length, state):
    """A right-padded Mamba1 prompt chunk through K7 from the carried state
    (updated in place, frozen past `length`); logits at the last real
    position."""
    x = params["embed"][tokens.long()]
    for li, lp in enumerate(params["layers"]):
        y, state["conv"][li], state["ssm"][li] = S.mamba1_chunk(
            cfg, lp["mamba"], L.norm_apply(cfg, lp["norm"], x),
            conv_state=state["conv"][li], ssm_state=state["ssm"][li], length=length)
        x = x + y
    return _logits(cfg, params, x[:, length - 1:length])


def _ssm_verify(cfg, params, tokens, state, ckpts):
    """A Mamba1 verify forward: every position's logits; the state advances
    through all C candidates in place, and `ckpts` (`init_verify_ckpts`)
    receives every position's state and the conv history. Returns the
    logits (B, C, V)."""
    C = tokens.shape[1]
    x = params["embed"][tokens.long()]
    for li, lp in enumerate(params["layers"]):
        y, hist, hs = S.mamba1_chunk_states(
            cfg, lp["mamba"], L.norm_apply(cfg, lp["norm"], x),
            conv_state=state["conv"][li], ssm_state=state["ssm"][li],
            states=ckpts["ssm"][li])
        ckpts["conv"][li] = hist
        state["conv"][li] = hist[:, C:]
        state["ssm"][li] = hs[:, -1]
        x = x + y
    return _logits(cfg, params, x)


# ------------------------------------------------------------- decode ------


def decode_step(cfg: ModelConfig, params, tokens, pos, pools, table, write_pages,
                state=None):
    """One batched decode step on the page pool.

    tokens (B, 1) int; pos (B,) int32 -- row b's token sits at position
    pos[b]; table (B, nb) int32 page tables; write_pages (B,) the page that
    holds position pos[b] (the sink page for a dead row). Writes each
    layer's K/V at (write_pages[b], pos[b] % ps) and attends positions
    < pos[b] + 1 with kernel K1. Returns logits (B, 1, V); the caller
    advances pos. Mamba1 steps `state` (conv/ssm, B rows) in place
    instead, with plain tensor ops; pools and tables go unused. MLA attends
    each row's gathered view and writes the block holding pos back to
    write_pages (`layers.mla_decode_apply`).
    """
    _check_family(cfg)
    if cfg.family == "ssm":
        return _ssm_decode(cfg, params, tokens, state)
    x = params["embed"][tokens.long()]
    if cfg.use_mla:
        def attend(li, p, h):
            return L.mla_decode_apply(cfg, p, h, pos=pos, ckv_pool=pools["ckv"][li],
                                      krope_pool=pools["krope"][li], table=table,
                                      write_pages=write_pages)
    else:
        ps = pools["k"].shape[2]
        wp = write_pages.long()
        offs = (pos % ps).long()

        def attend(li, p, h):
            return L.attn_decode_apply(cfg, p, h, pos=pos, k_pool=pools["k"][li],
                                       v_pool=pools["v"][li], table=table,
                                       write_pages=wp, write_offsets=offs)
    return _logits(cfg, params, _trunk(cfg, params, x, attend))


# ------------------------------------------------------- chunked prefill ---


def prefill_chunk(cfg: ModelConfig, params, tokens, start: int, length: int,
                  pools, ctx_ids, state=None):
    """Advance one sequence through a C-token prompt chunk on the page pool.

    tokens (1, C) int, right-padded past `length` real tokens; the chunk
    sits at positions [start, start+C); ctx_ids (n_ctx,) int32 is the
    sequence's page table, covering every position up to start+C-1. Each
    layer's chunk K/V is written into its pages (padded positions write
    harmless garbage past the true end, which later chunks and decode
    overwrite before any query may attend them), then kernel K2 attends
    the context causally. Returns the logits (1, 1, V) at the last real
    position; the sequence's position advances by `length`. Mamba1
    advances the sequence's B=1 `state` in place through K7, frozen past
    `length`; pools and ctx_ids go unused. MLA attends the sequence's
    gathered view (`layers.mla_chunk_apply`).
    """
    _check_family(cfg)
    if cfg.family == "ssm":
        return _ssm_chunk(cfg, params, tokens, length, state)
    x = params["embed"][tokens.long()]
    if cfg.use_mla:
        def attend(li, p, h):
            return L.mla_chunk_apply(cfg, p, h, start=start, ckv_pool=pools["ckv"][li],
                                     krope_pool=pools["krope"][li], ctx_ids=ctx_ids)
    else:
        ps = pools["k"].shape[2]
        positions = start + torch.arange(tokens.shape[1], device=ctx_ids.device)
        wp = ctx_ids[positions // ps].long()
        offs = positions % ps

        def attend(li, p, h):
            return L.attn_chunk_apply(cfg, p, h, start=start, k_pool=pools["k"][li],
                                      v_pool=pools["v"][li], ctx_ids=ctx_ids,
                                      write_pages=wp, write_offsets=offs)
    x = _trunk(cfg, params, x, attend)
    return _logits(cfg, params, x[:, length - 1:length])


# -------------------------------------------------- speculative verify -----


def verify_chunk(cfg: ModelConfig, params, tokens, pos, pools, table,
                 write_pages, write_offsets, state=None, ckpts=None, block0s=None):
    """Speculative-decoding verification forward on the page pool.

    tokens (B, C) int: each row's pending token plus its drafts, right-
    padded; pos (B,) int32 -- row b's candidate c sits at position
    pos[b] + c; table (B, nb) int32 page tables covering every candidate
    position; write_pages / write_offsets (B, C) the page and slot of each
    candidate position (the sink page past the row's table). Each layer
    writes the candidates' K/V in place, then kernel K4 attends causally
    from pos[b]. Unlike `prefill_chunk` it returns the logits at every
    position, (B, C, V): the acceptance test needs the greedy target after
    each candidate. The dense family keeps no recurrent state, so there
    are no checkpoints; rollback is the engine's page truncation. Mamba1
    advances `state` (B rows) in place through all C candidates with K7
    and writes the rollback checkpoints into `ckpts` (`init_verify_ckpts`);
    pools and tables go unused. MLA attends each row's gathered view and
    writes its blocks [block0s[b], block0s[b] + nb) back through the table
    (`layers.mla_verify_apply`); block0s (B,) is the JAX engine's.
    """
    _check_family(cfg)
    if cfg.family == "ssm":
        return _ssm_verify(cfg, params, tokens, state, ckpts)
    x = params["embed"][tokens.long()]
    if cfg.use_mla:
        def attend(li, p, h):
            return L.mla_verify_apply(cfg, p, h, pos=pos, ckv_pool=pools["ckv"][li],
                                      krope_pool=pools["krope"][li], table=table,
                                      block0s=block0s)
    else:
        wp, offs = write_pages.long(), write_offsets.long()

        def attend(li, p, h):
            return L.attn_verify_apply(cfg, p, h, pos=pos, k_pool=pools["k"][li],
                                       v_pool=pools["v"][li], table=table,
                                       write_pages=wp, write_offsets=offs)
    return _logits(cfg, params, _trunk(cfg, params, x, attend))


# ------------------------------------------------------------ slab KV ------


def init_decode_cache(cfg: ModelConfig, B: int, max_len: int, dtype=None,
                      device=None) -> dict:
    """Slab decode cache sized for `max_len` tokens, as the JAX package's:
    pos a 0-d int32 (the engine makes it (B,)), k/v (L, B, max_len, Hkv,
    D) zeros in `dtype` (default cfg.dtype); MLA keeps ckv (L, B, max_len,
    r) and krope (L, B, max_len, rd) instead; Mamba1 keeps its state
    (`init_state_cache`)."""
    _check_family(cfg)
    dev = resolve_device(device)
    dt = dtype or torch_dtype(cfg.dtype)
    cache = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.family == "ssm":
        return {**cache, **init_state_cache(cfg, B, dtype=dt, device=dev)}
    Lc = cfg.num_layers
    if cfg.use_mla:
        cache["ckv"] = torch.zeros((Lc, B, max_len, cfg.kv_lora_rank), dtype=dt, device=dev)
        cache["krope"] = torch.zeros((Lc, B, max_len, cfg.qk_rope_dim), dtype=dt, device=dev)
        return cache
    shape = (Lc, B, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    cache["k"] = torch.zeros(shape, dtype=dt, device=dev)
    cache["v"] = torch.zeros(shape, dtype=dt, device=dev)
    return cache


def prefill(cfg: ModelConfig, params, tokens, max_len: int, length=None):
    """Process a prompt into a fresh slab cache; return (last-position
    logits (B, 1, V), cache).

    tokens (B, S) int, right-padded past `length` real tokens when the
    engine buckets the prompt (None: all S are real). Every position's K/V
    is written (padded positions hold K/V no query attends before a later
    write replaces it), each layer's causal attention runs kernel K2 over
    the slab from position 0, and cache["pos"] = length. MLA runs the
    non-absorbed causal attention over the prompt (`layers.mla_apply`) and
    writes its c_kv/k_rope. Mamba1 runs the prompt as one chunk through K7
    from the fresh cache's zero state, frozen past `length`.
    """
    _check_family(cfg)
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"prompt ({S}) exceeds cache max_len={max_len}")
    dev = params["embed"].device
    cache = init_decode_cache(cfg, B, max_len, device=dev)
    n = S if length is None else int(length)
    if cfg.family == "ssm":
        # the fresh cache's zero conv window and state are the zero history
        logits = _ssm_chunk(cfg, params, tokens, n, cache)
        cache["pos"] = torch.tensor(n, dtype=torch.int32, device=dev)
        return logits, cache
    x = params["embed"][tokens.long()]
    if cfg.use_mla:
        positions = torch.arange(S, device=dev)[None]

        def attend(li, p, h):
            out, c_kv, k_rope = L.mla_apply(cfg, p, h, positions=positions)
            L.cache_write_chunk(cache["ckv"][li], c_kv, 0)
            L.cache_write_chunk(cache["krope"][li], k_rope, 0)
            return out
    else:
        ps = L.slab_page_size(max_len)
        tables = L.slab_tables(B, max_len, ps, dev)

        def attend(li, p, h):
            return L.attn_apply_slab(cfg, p, h, k_cache=cache["k"][li],
                                     v_cache=cache["v"][li], tables=tables)
    x = _trunk(cfg, params, x, attend)
    cache["pos"] = torch.tensor(n, dtype=torch.int32, device=dev)
    return _logits(cfg, params, x[:, n - 1:n]), cache


def decode_step_slab(cfg: ModelConfig, params, tokens, cache):
    """One decode step on a slab cache (the JAX slab `decode_step`).

    tokens (B, 1) int; cache["pos"] a 0-d int32 (every row at one
    position: the B=1 sub-cache of a prompt suffix or the drafter's
    prefill) or (B,) per-row positions. Writes each layer's K/V at pos
    (rows at or past max_len dropped) and attends positions < pos + 1 with
    kernel K5 (MLA: `layers.mla_decode_apply_slab`). Returns (logits (B,
    1, V), cache) with pos advanced by one. Mamba1 steps the cache's
    conv/ssm in place.
    """
    _check_family(cfg)
    pos = cache["pos"]
    if cfg.family == "ssm":
        cache["pos"] = pos + 1
        return _ssm_decode(cfg, params, tokens, cache), cache
    x = params["embed"][tokens.long()]
    if cfg.use_mla:
        def attend(li, p, h):
            return L.mla_decode_apply_slab(cfg, p, h, pos=pos, ckv_cache=cache["ckv"][li],
                                           krope_cache=cache["krope"][li])
    else:
        def attend(li, p, h):
            return L.attn_decode_apply_slab(cfg, p, h, pos=pos, k_cache=cache["k"][li],
                                            v_cache=cache["v"][li])
    x = _trunk(cfg, params, x, attend)
    cache["pos"] = pos + 1
    return _logits(cfg, params, x), cache


def verify_chunk_slab(cfg: ModelConfig, params, tokens, cache, ckpts=None):
    """Speculative-decoding verification forward on a slab cache (the JAX
    slab `verify_chunk`).

    tokens (B, C) int: each row's pending token plus its drafts, right-
    padded; cache["pos"] (B,) int32 -- row b's candidate c sits at
    pos[b] + c. Each layer writes the candidates' K/V (positions at or past
    max_len dropped, as JAX's `mode="drop"`), then kernel K4 attends
    causally from pos[b] over the slab seen as pages (MLA: `layers.
    mla_chunk_apply_slab`). Returns (logits (B, C, V), cache) with pos
    advanced by C; the dense family keeps no recurrent state, so rollback
    is the engine's position reset. Mamba1 advances the cache's conv/ssm in
    place with K7 and fills `ckpts` as `verify_chunk` does.
    """
    _check_family(cfg)
    pos = cache["pos"]
    if cfg.family == "ssm":
        cache["pos"] = pos + tokens.shape[1]
        return _ssm_verify(cfg, params, tokens, cache, ckpts), cache
    x = params["embed"][tokens.long()]
    if cfg.use_mla:
        def attend(li, p, h):
            return L.mla_chunk_apply_slab(cfg, p, h, start=pos, ckv_cache=cache["ckv"][li],
                                          krope_cache=cache["krope"][li])
    else:
        S = cache["k"].shape[2]
        ps = L.slab_page_size(S)
        tables = L.slab_tables(tokens.shape[0], S, ps, pos.device)

        def attend(li, p, h):
            return L.attn_chunk_apply_slab(cfg, p, h, start=pos, k_cache=cache["k"][li],
                                           v_cache=cache["v"][li], tables=tables)
    x = _trunk(cfg, params, x, attend)
    cache["pos"] = pos + tokens.shape[1]
    return _logits(cfg, params, x), cache
