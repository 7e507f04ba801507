"""Model assembly in PyTorch: parameters, and the forward passes of the
serving engine on both KV layouts (counterpart of `repro.models.model`:
the dense family, the vlm family (a dense decoder behind an image prefix),
the Mamba1 ssm family, the moe family with MLA or standard attention, the
hybrid family: a Mamba2 trunk with shared attention blocks, and the
encdec family: an encoder and a decoder that cross-attends it).

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
Every MoE layer gates through kernel K6. MoE with standard GQA attention
(grok-1-314b) keeps k/v slabs and pools as the dense family and runs K1,
K2, K4 and K5 the same way; the engine makes the dense paged path write
the sink page as the JAX engine does for it (`serving.engine`).

The hybrid family (zamba2-2.7b) runs num_layers Mamba2 blocks (`ssm.
mamba2_*`, plain tensor ops) and, before every attn_every of them, one
application of a shared attention block: application i uses
"shared_blocks"[i % n_shared_attn_blocks] with its own LoRA adapter
"lora"[i] on q, k, v and the output (`layers._project_qkv`,
`layers._out_proj`). Its KV pools and slabs have n_app = num_layers //
attn_every layers, one per application, and its per-slot state is the
Mamba2 conv window "conv" (L, B, K-1, di+2N) and state "ssm" (L, B, h, p,
N) float32; verify checkpoints hold "ssm" (L, B, C, h, p, N) and "conv"
(L, B, K-1+C, di+2N). Chunks and prompts run the SSD matrix form, decode
and verify the sequential recurrence.

The vlm family (llava-next-mistral-7b) is the dense decoder plus "mm_proj",
a two-layer projector from the stub vision tower's patch embeddings
(VISION_DIM wide) to d_model. A sequence's first chunk (`prefill_chunk`)
or whole prompt (`prefill`) may carry `image_embeds` (1, n_image_tokens,
VISION_DIM): the projected rows are prepended to the text, take the first
cache positions and are always real (`length` counts text tokens only).
Every later forward sees positions that already include them.

The encoder-decoder family (whisper) runs `_encoder` over the stub
frontend's frames -- LayerNorm pre-norm blocks whose self-attention sees
every frame (K2's non-causal form) -- and a decoder of LayerNorm blocks
("dec_layers") that add learned positions ("dec_pos") and, after causal
self-attention on the paths above, cross-attend the encoder's K/V. Its
per-slot state is that cross K/V, "ck" and "cv" (L, B, encoder_seq, Hkv,
D), which the engine computes once (`encode_cross_kv`) and the paged
functions read from `state=`; the slab `prefill` runs the encoder itself
and writes the cache's. Chunks, verify rounds and whole prompts
cross-attend through K2's non-causal form, decode steps through K5.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device

from . import layers as L
from . import ssm as S
from .config import ModelConfig

VISION_DIM = 1024  # stub vision-tower output width (llava)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family in ("dense", "vlm") and not (cfg.use_mla or cfg.n_experts):
        return
    if cfg.family == "ssm" and cfg.mamba_version == 1:
        return
    if cfg.family == "hybrid" and cfg.mamba_version == 2:
        return
    if cfg.family in ("moe", "encdec"):
        return
    raise NotImplementedError(
        f"model family {cfg.family!r} (mamba_version {cfg.mamba_version}) is not "
        f"ported: no config of the registry uses it (the port serves the dense, vlm, "
        f"moe, hybrid and encdec families and Mamba1)")


def n_applications(cfg: ModelConfig) -> int:
    """The hybrid family's shared-block applications, one every attn_every
    Mamba2 layers: the layer count of its KV pools and slabs."""
    return cfg.num_layers // cfg.attn_every


# ------------------------------------------------------------------ init ----


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None, dtype=None) -> dict:
    """Random parameters with the distributions of `repro.models.model.
    init_params` (normal * 0.02, output projections scaled by
    1/sqrt(2L), zero biases, unit norms; Mamba1 and Mamba2 blocks as `ssm.
    mamba1_init` and `mamba2_init`, drawn in float32; MLA and MoE blocks as
    `mla_init` and `moe_init`; the vlm projector "mm_proj" normal * 0.02,
    drawn in float32; the hybrid family's per-application LoRA adapters as
    `lora_init`: a_* normal * 0.02, b_* zeros; the encdec family's
    "enc_layers", "enc_final_norm", "dec_layers" with "cross_norm" and
    "cross_attn", and "dec_pos" normal * 0.02; LayerNorm with unit weight
    and zero bias), drawn from `generator` -- a
    different
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

    def norm(n):               # LayerNorm: unit weight, zero bias
        return {**ones(n), "b": zeros((n,))} if cfg.use_layernorm else ones(n)

    p = {"embed": normal((cfg.vocab_size, d), 0.02), "final_norm": norm(d)}
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

    def attn():
        if cfg.use_mla:
            r, nd, rd, vd = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
            return {"wq": normal((d, nq, nd + rd), 0.02),
                    "w_dkv": normal((d, r + rd), 0.02),
                    "w_uk": normal((r, nq, nd), 0.02),
                    "w_uv": normal((r, nq, vd), 0.02),
                    "wo": normal((nq, vd, d), out_std), "kv_norm": ones(r)["w"]}
        a = {"wq": normal((d, nq, hd), 0.02), "wk": normal((d, nkv, hd), 0.02),
             "wv": normal((d, nkv, hd), 0.02), "wo": normal((nq, hd, d), out_std)}
        if cfg.attn_bias:
            a.update(bq=zeros((nq, hd)), bk=zeros((nkv, hd)), bv=zeros((nkv, hd)))
        if cfg.qk_norm:
            a.update(q_norm=ones(hd)["w"], k_norm=ones(hd)["w"])
        return a

    def block(moe=False):
        b = {"attn_norm": norm(d), "attn": attn(), "mlp_norm": norm(d)}
        if not moe:
            b["mlp"] = mlp()
            return b
        E, eff = cfg.n_experts, cfg.expert_d_ff or cfg.d_ff
        b["moe"] = {"router": normal((d, E), 0.02), "w_gate": normal((E, d, eff), 0.02),
                    "w_up": normal((E, d, eff), 0.02),
                    "w_down": normal((E, eff, d), out_std)}
        if cfg.n_shared_experts:
            sh = eff * cfg.n_shared_experts
            b["moe"]["shared"] = {"w_gate": normal((d, sh), 0.02),
                                  "w_up": normal((d, sh), 0.02),
                                  "w_down": normal((sh, d), out_std)}
        return b

    if cfg.family == "moe":
        nd_layers = cfg.first_dense_layers
        if nd_layers:
            p["dense_layers"] = [block() for _ in range(nd_layers)]
        p["layers"] = [block(moe=True) for _ in range(cfg.num_layers - nd_layers)]
        return p
    if cfg.family == "encdec":
        p["enc_layers"] = [block() for _ in range(cfg.n_encoder_layers)]
        p["enc_final_norm"] = norm(d)
        p["dec_layers"] = [{**block(), "cross_norm": norm(d), "cross_attn": attn()}
                           for _ in range(cfg.num_layers)]
        p["dec_pos"] = normal((cfg.max_position, d), 0.02)
        return p
    if cfg.family == "hybrid":
        p["layers"] = [{"norm": ones(d), "mamba": S.mamba2_init(cfg, generator, dev, dt)}
                       for _ in range(cfg.num_layers)]
        p["shared_blocks"] = [block() for _ in range(cfg.n_shared_attn_blocks)]
        r = cfg.shared_lora_rank
        p["lora"] = [{"a_q": normal((d, r), 0.02), "b_q": zeros((r, nq * hd)),
                      "a_k": normal((d, r), 0.02), "b_k": zeros((r, nkv * hd)),
                      "a_v": normal((d, r), 0.02), "b_v": zeros((r, nkv * hd)),
                      "a_o": normal((d, r), 0.02), "b_o": zeros((r, d))}
                     for _ in range(n_applications(cfg))]
        return p
    p["layers"] = [block() for _ in range(cfg.num_layers)]
    if cfg.family == "vlm":
        def normal32(shape):
            return torch.randn(shape, generator=generator, device=dev,
                               dtype=torch.float32).mul_(0.02).to(dt)
        p["mm_proj"] = {"w1": normal32((VISION_DIM, d)), "w2": normal32((d, d))}
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
    so); the encdec family's decoder layers."""
    if "dec_layers" in params:
        return params["dec_layers"]
    return params.get("dense_layers", []) + params["layers"]


def _run(remat: bool, fn, *args):
    """fn(*args), under `torch.utils.checkpoint` (non-reentrant) with
    `remat`: the block's activations are recomputed in the backward pass,
    the counterpart of the JAX `jax.checkpoint(nothing_saveable)`."""
    return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)


def _trunk(cfg, params, x, attend=None, mamba=None, cross=None, *, aux=None,
           remat=False, tp=None, groups=None):
    """Run the blocks on x. Attention blocks: x + attend(li, attn params,
    normed x, lora), then (the encdec family's decoder) x + cross(li,
    cross_attn params, normed x), then the MLP or MoE feed-forward on the
    residual. Mamba blocks: x + mamba(li, mamba params, normed x). The ssm
    family runs only Mamba blocks; the hybrid family runs application i of
    its shared blocks (with adapter "lora"[i], pool layer i) before Mamba
    layers [i * attn_every, (i + 1) * attn_every). With `aux` (a list: the
    training forward) every MoE layer appends its load-balance loss; with
    `remat` every block runs under `_run`'s checkpoint. On a mesh (`tp`, a
    `distributed.sharding.MeshRank`) each block first all-gathers its
    `data`-sharded weights; its MLP, MoE experts and Mamba1 channels run
    on this rank's part of `model`, while a Mamba2 block (the hybrid
    family) gathers its weights whole and runs on every rank. `groups`:
    the training forward's MoE dispatch groups (`layers.moe_apply`)."""
    def attention_block(li, lp, x, lora=None):
        x = x + attend(li, lp["attn"], L.norm_apply(cfg, lp["attn_norm"], x), lora)
        if cross is not None:
            x = x + cross(li, lp["cross_attn"], L.norm_apply(cfg, lp["cross_norm"], x))
        h = L.norm_apply(cfg, lp["mlp_norm"], x)
        if "moe" in lp and aux is not None:
            m, a = L.moe_apply(cfg, lp["moe"], h, return_aux=True, tp=tp, groups=groups)
            return x + m, a
        if "moe" in lp:
            moe_kw = {} if tp is None else {"tp": tp}
            return x + L.moe_apply(cfg, lp["moe"], h, **moe_kw), None
        return x + L.mlp_apply(cfg, lp["mlp"], h, tp), None

    def attention(li, lp, x, lora=None):
        x, a = _run(remat, attention_block, li, lp, x, lora)
        if a is not None:
            aux.append(a)
        return x

    def mamba_layer(li, x):
        lp = params["layers"][li]
        if tp is not None:
            spec = tp.specs["layers"][li]
            lp = tp.gather_whole(lp, spec) if cfg.mamba_version == 2 else tp.gather(lp, spec)
        return x + mamba(li, lp["mamba"], L.norm_apply(cfg, lp["norm"], x))

    def mamba_block(li, x):
        return _run(remat, mamba_layer, li, x)

    if cfg.family == "ssm":
        for li in range(cfg.num_layers):
            x = mamba_block(li, x)
        return x
    if cfg.family == "hybrid":
        for i in range(n_applications(cfg)):
            j = i % cfg.n_shared_attn_blocks
            shared, lora = params["shared_blocks"][j], params["lora"][i]
            if tp is not None:
                shared = tp.gather(shared, tp.specs["shared_blocks"][j])
                lora = tp.gather(lora, tp.specs["lora"][i])
            x = attention(i, shared, x, lora)
            for li in range(i * cfg.attn_every, (i + 1) * cfg.attn_every):
                x = mamba_block(li, x)
        return x
    for li, lp in enumerate(_blocks(params)):
        if tp is not None:
            lp = tp.gather(lp, _blocks(tp.specs)[li])
        x = attention(li, lp, x)
    return x


# ---------------------------- per-slot state (ssm, hybrid; encdec cross K/V) --


def init_state_cache(cfg: ModelConfig, B: int, dtype=None, device=None) -> dict:
    """The per-slot state that is not indexed by token position: the conv
    window (L, B, K-1, c) in `dtype` (default cfg.dtype) -- Mamba1 c = di,
    Mamba2 c = di + 2N -- and the scan state in float32, (L, B, di, N) for
    Mamba1 and (L, B, h, p, N) for Mamba2, zeros; the encdec family's cross
    K/V "ck" and "cv" (L, B, encoder_seq, Hkv, D) in `dtype`, zeros; the
    other families have none."""
    _check_family(cfg)
    if cfg.family not in ("ssm", "hybrid", "encdec"):
        return {}
    dev = resolve_device(device)
    dt = dtype or torch_dtype(cfg.dtype)
    if cfg.family == "encdec":
        shape = (cfg.num_layers, B, cfg.encoder_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"ck": torch.zeros(shape, dtype=dt, device=dev),
                "cv": torch.zeros(shape, dtype=dt, device=dev)}
    Lc, K = cfg.num_layers, cfg.ssm_conv
    return {"conv": torch.zeros((Lc, B, K - 1) + _conv_width(cfg), dtype=dt, device=dev),
            "ssm": torch.zeros((Lc, B) + _state_shape(cfg), dtype=torch.float32, device=dev)}


def _conv_width(cfg: ModelConfig) -> tuple:
    return (cfg.d_inner + 2 * cfg.ssm_state,) if cfg.mamba_version == 2 else (cfg.d_inner,)


def _state_shape(cfg: ModelConfig) -> tuple:
    if cfg.mamba_version == 2:
        return (cfg.n_ssm_heads, cfg.mamba_headdim, cfg.ssm_state)
    return (cfg.d_inner, cfg.ssm_state)


def init_verify_ckpts(cache: dict, C: int) -> dict:
    """Buffers a verify forward of C candidates over the rows of `cache`
    (a per-slot state or slab with Mamba "ssm"/"conv", `init_state_cache`;
    on a mesh rank the rank's shard) fills with its rollback checkpoints:
    "ssm" (L, B, C, *state) float32, the state after every position, and
    "conv" (L, B, K-1+C, c), the raw input history with the carried window,
    in the cache's dtypes. Allocated once and reused: at falcon-mamba-7b's
    width and B = 4, C = 5 they hold ~0.7 GB, at zamba2-2.7b's ~1.4 GB."""
    st, cv = cache["ssm"], cache["conv"]
    return {"ssm": st.new_empty(st.shape[:2] + (C,) + st.shape[2:]),
            "conv": cv.new_empty(cv.shape[:2] + (cv.shape[2] + C,) + cv.shape[3:])}


def _mamba(cfg, S1, S2):
    return S2 if cfg.mamba_version == 2 else S1


def _tp_kw(cfg, tp) -> dict:
    """The mesh argument of a Mamba function: Mamba1 runs on the rank's
    channels (`tp`), Mamba2 whole (none)."""
    return {"tp": tp} if tp is not None and cfg.mamba_version == 1 else {}


def _mamba_decode(cfg, state, tp=None):
    """One decode step of each Mamba layer, updating `state` (conv/ssm, B
    rows) in place: plain tensor ops, as the JAX step."""
    step = _mamba(cfg, S.mamba1_decode, S.mamba2_decode)
    kw = _tp_kw(cfg, tp)

    def run(li, p, h):
        y, state["conv"][li], state["ssm"][li] = step(
            cfg, p, h, conv_state=state["conv"][li], ssm_state=state["ssm"][li], **kw)
        return y
    return run


def _mamba_chunk(cfg, state, length, tp=None):
    """A right-padded chunk through each Mamba layer from the carried state
    (updated in place, frozen past `length`): Mamba1's scan through K7,
    Mamba2's SSD matrix form."""
    chunk = _mamba(cfg, S.mamba1_chunk, S.mamba2_chunk)
    kw = _tp_kw(cfg, tp)

    def run(li, p, h):
        y, state["conv"][li], state["ssm"][li] = chunk(
            cfg, p, h, conv_state=state["conv"][li], ssm_state=state["ssm"][li],
            length=length, **kw)
        return y
    return run


def _mamba_verify(cfg, state, ckpts, C, tp=None):
    """A verify forward through each Mamba layer: the state advances through
    all C candidates in place, and `ckpts` (`init_verify_ckpts`) receives
    every position's state and the conv history. Mamba1 scans through K7,
    Mamba2 steps its decode recurrence."""
    fn = _mamba(cfg, S.mamba1_chunk_states, S.mamba2_chunk_states)
    kw = _tp_kw(cfg, tp)

    def run(li, p, h):
        y, hist, hs = fn(cfg, p, h, conv_state=state["conv"][li],
                         ssm_state=state["ssm"][li], states=ckpts["ssm"][li], **kw)
        ckpts["conv"][li] = hist
        state["conv"][li] = hist[:, C:]
        state["ssm"][li] = hs[:, -1]
        return y
    return run


def _logits(cfg, params, x, tp=None):
    """Logits over the whole vocabulary. On a mesh (`tp`) the head's
    `data`-sharded dim is all-gathered, and a `model`-sharded vocabulary is
    gathered over `model` after the product."""
    h = L.norm_apply(cfg, params["final_norm"], x)
    if tp is None:
        return h @ _head(cfg, params)
    name = "embed" if cfg.tie_embeddings else "lm_head"
    head = tp.gather(params[name], tp.specs[name])
    vocab_split = tp.on_model(name, 0 if cfg.tie_embeddings else 1)
    if vocab_split:
        h = tp.model_in(h)           # a column-parallel product over the vocabulary
    logits = h @ (head.T if cfg.tie_embeddings else head)
    return tp.model_cat(logits) if vocab_split else logits


def _lookup(params, tokens, tp=None):
    """Token embeddings. On a mesh (`tp`) the table's `data`-sharded dim is
    all-gathered; over a `model`-sharded vocabulary each rank looks up the
    tokens of its rows, zeros elsewhere, and the sum over `model` is
    exact."""
    if tp is None:
        return F.embedding(tokens.long(), params["embed"])
    table = tp.gather(params["embed"], tp.specs["embed"])
    if not tp.on_model("embed", 0):
        return F.embedding(tokens.long(), table)
    n = table.shape[0]
    local = tokens.long() - tp.model_rank * n
    ok = (local >= 0) & (local < n)
    rows = F.embedding(local.clamp(0, n - 1), table)
    return tp.model_sum(torch.where(ok[..., None], rows, torch.zeros_like(rows)))


def _embed(cfg, params, tokens, image_embeds=None, tp=None):
    """Token embeddings, behind the projected image rows when `image_embeds`
    (B, n_img, VISION_DIM) is given: gelu(img @ w1) @ w2 in the model dtype,
    with jax.nn.gelu's default tanh form. Returns (x, n_img). The lookup is
    `F.embedding`, whose backward sums a repeated token's rows in an order
    that does not change from run to run. On a mesh (`tp`) as `_lookup`,
    with the projector's `data`-sharded rows all-gathered."""
    x = _lookup(params, tokens, tp)
    if image_embeds is None:
        return x, 0
    mp = params["mm_proj"] if tp is None else tp.gather(params["mm_proj"],
                                                         tp.specs["mm_proj"])
    img = image_embeds.to(device=x.device, dtype=x.dtype)
    img = L.activation_fn("gelu")(img @ mp["w1"]) @ mp["w2"]
    return torch.cat([img, x], dim=1), img.shape[1]


# ------------------------------------------------ encoder-decoder (encdec) --


def _encoder(cfg, params, frames, *, remat=False, tp=None):
    """The encoder over the stub frontend's frames (B, S, d): fixed
    sinusoidal positions added in the model dtype, then LayerNorm pre-norm
    blocks of non-causal self-attention (kernel K2's non-causal form) and
    the MLP, each block under `_run(remat)`, then the final LayerNorm (the
    JAX `_encoder`). On a mesh (`tp`) every rank runs it, each block
    gathering its `data`-sharded weights, over the rank's heads and MLP
    columns with sums over `model`: the output is whole on every rank."""
    x = frames.to(params["embed"].dtype)
    x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(x.dtype)

    def block(lp, x):
        h = L.norm_apply(cfg, lp["attn_norm"], x)
        x = x + L.attn_apply_bidirectional(cfg, lp["attn"], h, tp)
        return x + L.mlp_apply(cfg, lp["mlp"], L.norm_apply(cfg, lp["mlp_norm"], x), tp)
    for i, lp in enumerate(params["enc_layers"]):
        if tp is not None:
            lp = tp.gather(lp, tp.specs["enc_layers"][i])
        x = _run(remat, block, lp, x)
    return L.norm_apply(cfg, params["enc_final_norm"], x)


def encode_cross_kv(cfg: ModelConfig, params, frames, tp=None):
    """Run the encoder once over frames (B, encoder_seq, d) and project every
    decoder layer's cross K/V: (ck, cv), each (L, B, encoder_seq, Hkv, D)
    in the model dtype -- what `prefill_chunk`, `decode_step` and
    `verify_chunk` read from their state (the slab `prefill` computes them
    inside the decoder blocks). On a mesh (`tp`) the rank's KV heads where
    wk/wv hold them so (`cache_specs` puts ck/cv's heads over `model`)."""
    _check_family(cfg)
    enc = _encoder(cfg, params, frames, tp=tp)
    layers = params["dec_layers"]
    if tp is not None:
        layers = [tp.gather(lp["cross_attn"], tp.specs["dec_layers"][i]["cross_attn"])
                  for i, lp in enumerate(layers)]
    else:
        layers = [lp["cross_attn"] for lp in layers]
    kvs = [L.cross_kv(p, enc) for p in layers]
    return torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs])


def _add_dec_pos(cfg, params, x, positions, *, fill_nan=False):
    """x plus the learned decoder positions at `positions` (broadcast
    against x's leading axes), as the JAX package reads them: clipped into
    the table (a chunk's and a verify round's `jnp.clip`, a scalar decode
    position's `dynamic_slice`), or, for per-row decode positions
    (`fill_nan`), NaN past the table (`jnp.take`'s fill)."""
    if cfg.family != "encdec":
        return x
    table = params["dec_pos"]
    idx = positions.long()
    rows = table[idx.clamp(0, table.shape[0] - 1)]
    if fill_nan:
        rows = torch.where((idx < table.shape[0])[..., None], rows,
                           rows.new_full((), float("nan")))
    return x + rows


def _cross_chunk(cfg, state, tp=None):
    """The decoder's cross-attention of a chunk or verify round over the
    cross K/V in `state` (K2's non-causal form); None for the other
    families."""
    if cfg.family != "encdec":
        return None

    def run(li, p, h):
        return L.cross_attn_apply(cfg, p, h, ck=state["ck"][li], cv=state["cv"][li], tp=tp)
    return run


def _cross_decode(cfg, state, tp=None):
    """The decoder's cross-attention of a decode step over the cross K/V in
    `state` (K5 at length encoder_seq); None for the other families."""
    if cfg.family != "encdec":
        return None

    def run(li, p, h):
        return L.cross_decode_apply(cfg, p, h, ck=state["ck"][li], cv=state["cv"][li],
                                    tp=tp)
    return run


# ------------------------------------------------------------ training -----


def _cast(tree, dtype):
    """Every floating tensor of a parameter tree in `dtype` (the JAX
    `_cast`): float32 masters stay themselves in a float32 model, and
    autograd flows through the cast in a bf16 one."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def forward(cfg: ModelConfig, params, batch, *, remat=False, constrain=None, mesh=None):
    """Full-sequence forward of every family from position 0, with a
    gradient (the JAX `forward`, which training runs). Returns (logits
    (B, S, V) in the model dtype over the text positions, aux: the moe
    family's load-balance loss summed over its MoE layers, else 0), both on
    the parameters' device.

    batch: "tokens" (B, S) int (numpy or a tensor); the vlm family also
    "image_embeds" (B, n_img, VISION_DIM), projected and prepended to the
    text, and the encdec family "frames" (B, encoder_seq, d) for the
    encoder. Every floating parameter is cast to cfg.dtype on entry
    (`_cast`), so the parameters may be float32 masters. Attention runs
    K2 (causal) and K2's non-causal form (the encoder, cross-attention),
    MLA plain PyTorch, MoE gates through K6 (its grouped launch under
    `layers.set_moe_groups`) and Mamba1 scans through K7, each kernel with
    its gradient (`kernels.autograd`); Mamba2 runs the SSD form. `remat`
    recomputes every block's activations in the backward pass
    (`torch.utils.checkpoint`, non-reentrant); its losses and gradients
    equal the plain run's.

    On a (data, model) mesh (`mesh`, a `distributed.sharding.MeshRank`
    over the rank's `shard_params`) `batch` is the global batch and the
    rank runs its rows: `constrain` (default `make_constrain(mesh, B)`)
    puts the batch over `data` where it divides (`MeshRank.train_rows`;
    the moe family's rows only under grouped dispatch). Each block gathers
    its `data`-sharded weights (backward: a reduce-scatter) and runs the
    rank's heads, MLP and expert columns and Mamba1 channels, its
    column-parallel regions entered through `MeshRank.model_in` and its
    row-parallel products summed over `model`; the logits over a
    `model`-sharded vocabulary are gathered whole. Returns the rank's
    rows' logits and its aux. Every rank recomputes the same blocks under
    `remat`, so the collectives inside them meet in the backward pass."""
    _check_family(cfg)
    p = _cast(params, torch_dtype(cfg.dtype))
    dev = p["embed"].device
    # the MoE dispatch groups are read once here, so that a block that
    # `remat` recomputes in the backward pass dispatches as it did forward
    tok = batch["tokens"]
    rows, groups = slice(None), L.moe_groups(tok.shape[0] * tok.shape[1])
    if mesh is not None:
        rows, groups = mesh.train_rows(cfg, tok.shape[0], groups, constrain)
    groups = groups or 0

    def tensor(key):
        return torch.as_tensor(batch[key], device=dev)[rows]
    image = tensor("image_embeds") if cfg.family == "vlm" else None
    x, n_img = _embed(cfg, p, tensor("tokens"), image, mesh)
    n = x.shape[1]
    attend = cross = None
    if cfg.family == "encdec":
        if n > cfg.max_position:
            raise ValueError(f"forward: {n} positions exceed the decoder's position "
                             f"table ({cfg.max_position})")
        x = x + p["dec_pos"][:n]
        enc = _encoder(cfg, p, tensor("frames"), remat=remat, tp=mesh)

        def cross(li, lp, h):
            return L.cross_attn_apply_full(cfg, lp, h, enc, tp=mesh)
    if cfg.use_mla:
        positions = torch.arange(n, device=dev)[None]

        def attend(li, lp, h, lora=None):
            return L.mla_apply(cfg, lp, h, positions=positions, tp=mesh)[0]
    elif cfg.family != "ssm":
        def attend(li, lp, h, lora=None):
            return L.attn_apply(cfg, lp, h, lora=lora, tp=mesh)
    apply = _mamba(cfg, S.mamba1_apply, S.mamba2_apply)
    kw = _tp_kw(cfg, mesh)

    def mamba(li, lp, h):
        return apply(cfg, lp, h, **kw)
    aux = []
    x = _trunk(cfg, p, x, attend, mamba, cross, aux=aux, remat=remat, tp=mesh, groups=groups)
    return _logits(cfg, p, x[:, n_img:], mesh), sum(aux, torch.zeros((), device=dev))


# ------------------------------------------------------------- decode ------


def _mesh_rows(mesh, *tensors):
    """This rank's rows of each tensor (`MeshRank.rows`; None and a 0-d
    tensor as they are), or the tensors off a mesh."""
    if mesh is None:
        return tensors
    r = mesh.rows(tensors[0].shape[0])
    return tuple(t if t is None or t.ndim == 0 else t[r] for t in tensors)


def decode_step(cfg: ModelConfig, params, tokens, pos, pools, table, write_pages,
                state=None, mesh=None):
    """One batched decode step on the page pool.

    tokens (B, 1) int; pos (B,) int32 -- row b's token sits at position
    pos[b]; table (B, nb) int32 page tables; write_pages (B,) the page that
    holds position pos[b]. Writes each layer's K/V at (write_pages[b],
    pos[b] % ps) and attends positions < pos[b] + 1 through the table with
    kernel K1. Returns logits (B, 1, V); the caller advances pos. The engine
    gives a dead row an all-sink table and the sink as its write page; for a
    MoE model it redirects the sink blocks a row writes to private scratch
    pages (`cache_ops.sink_plan`). Mamba1 steps `state` (conv/ssm, B rows)
    in place instead, with plain tensor ops; pools and tables go unused.
    The hybrid family does both: attention on the pools (n_app layers),
    Mamba2 on `state`. MLA attends each row's gathered view and writes the
    block holding pos back to write_pages (`layers.mla_decode_apply`). The
    encdec family adds the learned position of pos[b] (NaN past the table,
    as the JAX package's per-row read) and cross-attends the cross K/V in
    `state` (the engine's per-slot "ck"/"cv") through K5.

    On a serving mesh (`mesh`, a `distributed.sharding.MeshRank`) `params`
    are this rank's shards (`shard_params`), the pools its shard
    (`pool_specs`) and `state` its rows and channels (`cache_specs`); the
    rank runs its rows of the batch (`MeshRank.rows`, all of them where the
    batch replicates over `data`: B = 1, and the moe family) and returns
    their logits, and every row's K/V is written on every rank.
    """
    _check_family(cfg)
    attend = wp = offs = None
    if not cfg.use_mla and cfg.family != "ssm":
        wp = write_pages.long()
        offs = (pos % pools["k"].shape[2]).long()
    tokens, pos, table = _mesh_rows(mesh, tokens, pos, table)
    if cfg.use_mla:
        def attend(li, p, h, lora=None):
            return L.mla_decode_apply(cfg, p, h, pos=pos, ckv_pool=pools["ckv"][li],
                                      krope_pool=pools["krope"][li], table=table,
                                      write_pages=write_pages, tp=mesh)
    elif cfg.family != "ssm":
        def attend(li, p, h, lora=None):
            return L.attn_decode_apply(cfg, p, h, pos=pos, k_pool=pools["k"][li],
                                       v_pool=pools["v"][li], table=table,
                                       write_pages=wp, write_offsets=offs, lora=lora,
                                       tp=mesh)
    x = _add_dec_pos(cfg, params, _lookup(params, tokens, mesh), pos.reshape(-1, 1),
                     fill_nan=True)
    mamba = _mamba_decode(cfg, state, mesh)
    return _logits(cfg, params, _trunk(cfg, params, x, attend, mamba,
                                       _cross_decode(cfg, state, mesh), tp=mesh), mesh)


# ------------------------------------------------------- chunked prefill ---


def prefill_chunk(cfg: ModelConfig, params, tokens, start: int, length: int,
                  pools, ctx_ids, state=None, image_embeds=None, mesh=None):
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
    `length`; pools and ctx_ids go unused. The hybrid family runs its
    attention on the pools and its Mamba2 layers on `state` (the SSD
    form). MLA attends the sequence's gathered view
    (`layers.mla_chunk_apply`). A vlm sequence's first chunk may carry
    `image_embeds` (1, n_img, VISION_DIM): the projected image rows sit at
    [start, start+n_img) ahead of the text, ctx_ids covers
    start+n_img+C-1, the logits are taken at the last real text position
    and the position advances by n_img + `length`. The encdec family adds
    the learned positions of [start, start+C), clipped into the table, and
    cross-attends the cross K/V in the sequence's B=1 `state` ("ck"/"cv",
    `encode_cross_kv`) through K2's non-causal form. On a serving mesh
    (`mesh`, as `decode_step`) every rank runs the chunk (B = 1 replicates
    over `data`) on its shards.
    """
    _check_family(cfg)
    x, n_img = _embed(cfg, params, tokens, image_embeds, mesh)
    x = _add_dec_pos(cfg, params, x, start + torch.arange(x.shape[1], device=x.device))
    attend = None
    if cfg.use_mla:
        def attend(li, p, h, lora=None):
            return L.mla_chunk_apply(cfg, p, h, start=start, ckv_pool=pools["ckv"][li],
                                     krope_pool=pools["krope"][li], ctx_ids=ctx_ids, tp=mesh)
    elif cfg.family != "ssm":
        ps = pools["k"].shape[2]
        positions = start + torch.arange(x.shape[1], device=ctx_ids.device)
        wp = ctx_ids[positions // ps].long()
        offs = positions % ps

        def attend(li, p, h, lora=None):
            return L.attn_chunk_apply(cfg, p, h, start=start, k_pool=pools["k"][li],
                                      v_pool=pools["v"][li], ctx_ids=ctx_ids,
                                      write_pages=wp, write_offsets=offs, lora=lora,
                                      tp=mesh)
    mamba = _mamba_chunk(cfg, state, length, mesh)
    x = _trunk(cfg, params, x, attend, mamba, _cross_chunk(cfg, state, mesh), tp=mesh)
    last = n_img + length
    return _logits(cfg, params, x[:, last - 1:last], mesh)


# -------------------------------------------------- speculative verify -----


def verify_chunk(cfg: ModelConfig, params, tokens, pos, pools, table,
                 write_pages, write_offsets, state=None, ckpts=None, block0s=None,
                 mesh=None):
    """Speculative-decoding verification forward on the page pool.

    tokens (B, C) int: each row's pending token plus its drafts, right-
    padded; pos (B,) int32 -- row b's candidate c sits at position
    pos[b] + c; table (B, nb) int32 page tables covering every candidate
    position; write_pages / write_offsets (B, C) the page and slot of each
    candidate position (the sink page past the row's table; for a MoE
    model the engine's scratch pages and, where the JAX package drops the
    write, a trash page). Each layer writes the candidates' K/V in place,
    then kernel K4 attends causally from pos[b]. Unlike `prefill_chunk` it
    returns the logits at every position, (B, C, V): the acceptance test
    needs the greedy target after each candidate. The dense family keeps no
    recurrent state, so there are no checkpoints; rollback is the engine's
    page truncation. Mamba1 advances `state` (B rows) in place through all
    C candidates with K7 and writes the rollback checkpoints into `ckpts`
    (`init_verify_ckpts`); pools and tables go unused. The hybrid family's
    attention runs on the pools and its Mamba2 layers step their
    recurrence through the candidates, checkpointing likewise. MLA attends
    each row's gathered view and writes its blocks [block0s[b], block0s[b]
    + nb) back through the table (`layers.mla_verify_apply`); block0s (B,)
    is the JAX engine's. The encdec family adds the learned positions of
    pos[b] + c, clipped into the table, and cross-attends the cross K/V in
    `state` through K2's non-causal form. On a serving mesh (`mesh`, as
    `decode_step`) the rank runs its rows and returns their logits, and
    every row's candidates are written on every rank.
    """
    _check_family(cfg)
    attend = wp = offs = None
    if not cfg.use_mla and cfg.family != "ssm":
        wp, offs = write_pages.long(), write_offsets.long()
    tokens, pos, table = _mesh_rows(mesh, tokens, pos, table)
    if cfg.use_mla:
        def attend(li, p, h, lora=None):
            return L.mla_verify_apply(cfg, p, h, pos=pos, ckv_pool=pools["ckv"][li],
                                      krope_pool=pools["krope"][li], table=table,
                                      block0s=block0s, tp=mesh)
    elif cfg.family != "ssm":

        def attend(li, p, h, lora=None):
            return L.attn_verify_apply(cfg, p, h, pos=pos, k_pool=pools["k"][li],
                                       v_pool=pools["v"][li], table=table,
                                       write_pages=wp, write_offsets=offs, lora=lora,
                                       tp=mesh)
    x = _add_dec_pos(cfg, params, _lookup(params, tokens, mesh),
                     L.chunk_positions(pos, tokens.shape[0], tokens.shape[1], tokens.device))
    mamba = _mamba_verify(cfg, state, ckpts, tokens.shape[1], mesh)
    return _logits(cfg, params, _trunk(cfg, params, x, attend, mamba,
                                       _cross_chunk(cfg, state, mesh), tp=mesh), mesh)


# ------------------------------------------------------------ slab KV ------


def init_decode_cache(cfg: ModelConfig, B: int, max_len: int, dtype=None,
                      device=None) -> dict:
    """Slab decode cache sized for `max_len` tokens, as the JAX package's:
    pos a 0-d int32 (the engine makes it (B,)), k/v (L, B, max_len, Hkv,
    D) zeros in `dtype` (default cfg.dtype); MLA keeps ckv (L, B, max_len,
    r) and krope (L, B, max_len, rd) instead; Mamba1 keeps its state
    (`init_state_cache`); the hybrid family keeps its Mamba2 state and k/v
    of n_app layers, one per shared-block application."""
    _check_family(cfg)
    dev = resolve_device(device)
    dt = dtype or torch_dtype(cfg.dtype)
    cache = {"pos": torch.zeros((), dtype=torch.int32, device=dev),
             **init_state_cache(cfg, B, dtype=dt, device=dev)}
    if cfg.family == "ssm":
        return cache
    Lc = n_applications(cfg) if cfg.family == "hybrid" else cfg.num_layers
    if cfg.use_mla:
        cache["ckv"] = torch.zeros((Lc, B, max_len, cfg.kv_lora_rank), dtype=dt, device=dev)
        cache["krope"] = torch.zeros((Lc, B, max_len, cfg.qk_rope_dim), dtype=dt, device=dev)
        return cache
    shape = (Lc, B, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    cache["k"] = torch.zeros(shape, dtype=dt, device=dev)
    cache["v"] = torch.zeros(shape, dtype=dt, device=dev)
    return cache


def prefill(cfg: ModelConfig, params, tokens, max_len: int, length=None,
            image_embeds=None, frames=None, mesh=None):
    """Process a prompt into a fresh slab cache; return (last-position
    logits (B, 1, V), cache).

    tokens (B, S) int, right-padded past `length` real tokens when the
    engine buckets the prompt (None: all S are real). Every position's K/V
    is written (padded positions hold K/V no query attends before a later
    write replaces it), each layer's causal attention runs kernel K2 over
    the slab from position 0, and cache["pos"] = length. MLA runs the
    non-absorbed causal attention over the prompt (`layers.mla_apply`) and
    writes its c_kv/k_rope. Mamba1 runs the prompt as one chunk through K7
    from the fresh cache's zero state, frozen past `length`; Mamba2 (the
    hybrid family) as one SSD chunk from the zero state, as the JAX
    `prefill` runs `mamba2_ssd_ref` over the prompt. The vlm family takes
    the prompt's `image_embeds` (B, n_img, VISION_DIM) ahead of the text
    (`length` counts text tokens only; pos = n_img + length). The encdec
    family takes the stub frontend's `frames` (B, encoder_seq, d): the
    encoder runs on every call, as in the JAX `prefill`; each decoder layer
    adds the learned positions [0, S) (S past the table raises, as the JAX
    slice does), projects its cross K/V of the encoder output into the
    cache's "ck"/"cv" and cross-attends it through K2's non-causal form.

    On a serving mesh (`mesh`, a `distributed.sharding.MeshRank`) every
    rank runs the prompt on its shards, and the cache is the rank's shard
    of the global one (`MeshRank.local_cache`: the sequence of k/v and of
    MLA's ckv/krope over `model`, Mamba1's channels, the cross K/V's heads);
    attention gathers a layer's sequence shards whole for its write and K2,
    and each rank keeps its part.
    """
    _check_family(cfg)
    B, S = tokens.shape
    n_img = 0 if image_embeds is None else image_embeds.shape[1]
    if n_img + S > max_len:
        raise ValueError(f"prompt ({S} + {n_img} image tokens) exceeds cache "
                         f"max_len={max_len}")
    dev = params["embed"].device
    cache = init_decode_cache(cfg, B, max_len, device=dev)
    if mesh is not None:
        cache = mesh.local_cache(cfg, cache, B)
    n = n_img + (S if length is None else int(length))
    x, _ = _embed(cfg, params, tokens, image_embeds, mesh)
    S = x.shape[1]
    attend = cross = None
    if cfg.family == "encdec":
        if frames is None:
            raise ValueError("prefill: the encdec family needs `frames`")
        if S > cfg.max_position:
            raise ValueError(f"prefill: {S} positions exceed the decoder's position "
                             f"table ({cfg.max_position})")
        x = _add_dec_pos(cfg, params, x, torch.arange(S, device=dev))
        enc = _encoder(cfg, params, frames, tp=mesh)

        def cross(li, p, h):
            ck, cv = L.cross_kv(p, enc)
            cache["ck"][li], cache["cv"][li] = ck, cv
            return L.cross_attn_apply(cfg, p, h, ck=ck, cv=cv, tp=mesh)
    if cfg.use_mla:
        positions = torch.arange(S, device=dev)[None]

        def attend(li, p, h, lora=None):
            out, c_kv, k_rope = L.mla_apply(cfg, p, h, positions=positions, tp=mesh)
            for name, new in (("ckv", c_kv), ("krope", k_rope)):
                layer, back = L._seq_whole(mesh, cache[name][li])
                L.cache_write_chunk(layer, new, 0)
                back(layer)
            return out
    elif cfg.family != "ssm":
        ps = L.slab_page_size(max_len)
        tables = L.slab_tables(B, max_len, ps, dev)

        def attend(li, p, h, lora=None):
            return L.attn_apply_slab(cfg, p, h, k_cache=cache["k"][li],
                                     v_cache=cache["v"][li], tables=tables, lora=lora,
                                     tp=mesh)
    # the fresh cache's zero conv window and state are the zero history
    mamba = _mamba_chunk(cfg, cache, n, mesh)
    x = _trunk(cfg, params, x, attend, mamba, cross, tp=mesh)
    cache["pos"] = torch.tensor(n, dtype=torch.int32, device=dev)
    return _logits(cfg, params, x[:, n - 1:n], mesh), cache


def decode_step_slab(cfg: ModelConfig, params, tokens, cache, attn_impl=None, mesh=None):
    """One decode step on a slab cache (the JAX slab `decode_step`).

    tokens (B, 1) int; cache["pos"] a 0-d int32 (every row at one
    position: the B=1 sub-cache of a prompt suffix or the drafter's
    prefill) or (B,) per-row positions. Writes each layer's K/V at pos
    (rows at or past max_len dropped) and attends positions < pos + 1 with
    kernel K5 (MLA: `layers.mla_decode_apply_slab`). Returns (logits (B,
    1, V), cache) with pos advanced by one. Mamba1 and Mamba2 step the
    cache's conv/ssm in place. The encdec family adds the learned position
    of pos (a 0-d pos clamped into the table, per-row positions NaN past
    it, as the JAX package reads them) and cross-attends the cache's
    "ck"/"cv" through K5. `attn_impl` replaces K5 in the self-attention where
    given (`distributed.decode.make_seq_sharded_decode_attn`, as the JAX
    `decode_step(attn_impl=)`).

    On a serving mesh (`mesh`, as `prefill`) the cache is the rank's shard:
    its rows of the batch (`MeshRank.rows`; `pos` stays every row's) and
    its part of the sequence, where the token is written by the rank that
    holds its position and attention is the sequence-sharded combine over
    kernel K5s (`MeshRank.seq_attn`). Returns the rank's rows' logits.
    """
    _check_family(cfg)
    pos_all = cache["pos"]
    tokens, pos = _mesh_rows(mesh, tokens, pos_all)
    if mesh is not None and attn_impl is None:
        attn_impl = mesh.seq_attn
    emb = params["embed"][tokens.long()] if mesh is None else _lookup(params, tokens, mesh)
    x = _add_dec_pos(cfg, params, emb, pos.reshape(-1, 1), fill_nan=pos.ndim > 0)
    attend = None
    if cfg.use_mla:
        def attend(li, p, h, lora=None):
            return L.mla_decode_apply_slab(cfg, p, h, pos=pos, ckv_cache=cache["ckv"][li],
                                           krope_cache=cache["krope"][li], tp=mesh)
    elif cfg.family != "ssm":
        def attend(li, p, h, lora=None):
            return L.attn_decode_apply_slab(cfg, p, h, pos=pos, k_cache=cache["k"][li],
                                            v_cache=cache["v"][li], lora=lora,
                                            attn_impl=attn_impl, tp=mesh)
    mamba = _mamba_decode(cfg, cache, mesh)
    x = _trunk(cfg, params, x, attend, mamba, _cross_decode(cfg, cache, mesh), tp=mesh)
    cache["pos"] = pos_all + 1
    return _logits(cfg, params, x, mesh), cache


def verify_chunk_slab(cfg: ModelConfig, params, tokens, cache, ckpts=None, mesh=None):
    """Speculative-decoding verification forward on a slab cache (the JAX
    slab `verify_chunk`).

    tokens (B, C) int: each row's pending token plus its drafts, right-
    padded; cache["pos"] (B,) int32 -- row b's candidate c sits at
    pos[b] + c. Each layer writes the candidates' K/V (positions at or past
    max_len dropped, as JAX's `mode="drop"`), then kernel K4 attends
    causally from pos[b] over the slab seen as pages (MLA: `layers.
    mla_chunk_apply_slab`). Returns (logits (B, C, V), cache) with pos
    advanced by C; the dense family keeps no recurrent state, so rollback
    is the engine's position reset. Mamba1 and Mamba2 advance the cache's
    conv/ssm in place and fill `ckpts` as `verify_chunk` does. The encdec
    family adds the learned positions (clipped) and cross-attends the
    cache's "ck"/"cv" through K2's non-causal form. On a serving mesh
    (`mesh`, as `decode_step_slab`) each layer's sequence shards are
    gathered whole for the write and K4, and the rank keeps its part.
    """
    _check_family(cfg)
    pos_all = cache["pos"]
    tokens, pos = _mesh_rows(mesh, tokens, pos_all)
    emb = params["embed"][tokens.long()] if mesh is None else _lookup(params, tokens, mesh)
    x = _add_dec_pos(cfg, params, emb,
                     L.chunk_positions(pos, tokens.shape[0], tokens.shape[1], tokens.device))
    attend = None
    if cfg.use_mla:
        def attend(li, p, h, lora=None):
            return L.mla_chunk_apply_slab(cfg, p, h, start=pos, ckv_cache=cache["ckv"][li],
                                          krope_cache=cache["krope"][li], tp=mesh)
    elif cfg.family != "ssm":
        S = cache["k"].shape[2] * (1 if mesh is None else mesh.seq_shards[0])
        ps = L.slab_page_size(S)
        tables = L.slab_tables(tokens.shape[0], S, ps, pos.device)

        def attend(li, p, h, lora=None):
            return L.attn_chunk_apply_slab(cfg, p, h, start=pos, k_cache=cache["k"][li],
                                           v_cache=cache["v"][li], tables=tables, lora=lora,
                                           tp=mesh)
    mamba = _mamba_verify(cfg, cache, ckpts, tokens.shape[1], mesh)
    x = _trunk(cfg, params, x, attend, mamba, _cross_chunk(cfg, cache, mesh), tp=mesh)
    cache["pos"] = pos_all + tokens.shape[1]
    return _logits(cfg, params, x, mesh), cache
