#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--out DIR] [--profile]

Runs from the root of a checkout, imports nothing of JAX or of the JAX
package, and goes through its phases, each printing one JSON line:

  device     the card's name and power limit (nvidia-smi);
  build      nvcc build of the port's CUDA kernels from the checkout's sources;
  main       one QUEST query on qwen2.5-3b at its published width
             (d_model 2048, bf16, random weights from --seed), cut to its
             first MAIN_LAYERS = 12 of 36 layers to fit the time limit,
             through the entry points a user calls: Session.prepare(q).
             submit() -> TwoLevelRetriever over the legal corpus ->
             ServedExtractor -> paged ServingEngine; the kernel launch
             counts are set to 0 just before the query and read just after;
  spec       the same query and cut weights with the settings the system is
             served with: prefix cache on and prompt-lookup speculative
             decoding (spec_k=4), so every decode round is a verify round
             through K4 and prompt suffixes resume after a cached prefix;
             counts set to 0 just before and read just after; agreement
             with the main phase is reported, not asserted (bf16 rounds
             differently in verify rounds and resumed chunks);
  slab       the same query and cut weights on the slab KV layout
             (kv_layout="slab", prefix cache and speculation off): every
             prompt prefills whole, bucketed to chunk_size, through K2 over
             the slab seen as pages, and every decode step runs K5 on the
             slab (one launch a layer); rows and the ledger's token columns
             must equal the main phase's, K1 and K4 must stay at 0;
  draft      on the cut weights, the spec phase's engine with draft-model
             speculation instead of prompt lookup: spec_decode="draft" with
             the target's own weights as the draft (self-drafting, the
             acceptance ceiling). The target prefills in chunks (K2) and
             verifies (K4); the drafter prefills each prompt bucketed (K2)
             and drafts with batched slab decode steps (K5). Acceptance,
             verify rounds and the drafter's steps are reported; rows and
             ledger token columns must equal the main phase's, K1 must
             stay at 0;
  ssm        with the qwen2.5-3b weights freed, the same query on
             falcon-mamba-7b (Mamba1) at its published width and all 64
             layers (d_model 4096, d_inner 8192, bf16, random weights from
             --seed), with the spec phase's served settings and
             chunk_size=128: every prompt chunk and every verify round runs
             the selective scan through K7 (64 launches a forward), verify
             rounds keep per-position state checkpoints and roll rejected
             drafts back from them, prefix entries carry the recurrent
             state. Rows and the ledger's input tokens must equal the main
             phase's (output tokens are reported: another model may end
             elsewhere); K1, K2, K4, K5 and K6 must stay at 0;
  moe        with the falcon-mamba-7b weights freed, the same query on
             deepseek-v2-lite-16b (MLA attention + MoE, 15.7B parameters)
             at its published width and all 27 layers (d_model 2048, 64
             routed experts of which 6 a token, bf16, random weights from
             --seed), with the ssm phase's settings: every prompt chunk and
             verify round gates each of its 26 MoE layers through K6; MLA
             attends the compressed ckv/krope pool in plain PyTorch, as the
             JAX package does. Rows and the ledger's input tokens must equal
             the main phase's; K6 = 26 x (chunks + verify rounds); K1, K2,
             K4, K5 and K7 must stay at 0;
  kernels    every kernel of those paths (K1 paged decode attention, K2
             paged chunk-prefill attention, K3 L2 top-k, K4 paged verify
             attention, K5 dense-cache decode attention, K6 MoE gating, K7
             selective scan) on the inputs of one of its real launches (K6
             and K7: a prefill chunk and a verify round), plus edge cases,
             held against its plain PyTorch version; times with CUDA events
             beside its bound and a PyTorch library yardstick where one call
             computes the same function (none does for K7);
  profile    (only with --profile) torch.profiler over one extraction round
             of each path (main, spec, slab, draft, ssm, moe): device busy
             share, device time by kernel group; on the moe path also the
             device time of MLA attention and of the expert products;
  reference  the same served query code at a small size (SMOKE configs,
             float32, 20 legal documents) on the card and on the CPU's plain
             path: qwen2.5-3b in four modes (speculation and the prefix
             cache off; prompt lookup with the prefix cache; the slab layout
             with the prefix cache, whose snapshot, expand and token-by-
             token suffix decode run on the card; self-drafting),
             falcon-mamba-7b in four (off; prompt lookup with the prefix
             cache; slab with the prefix cache; scripted drafts of which two
             of four are right, so rejected drafts roll back to a checkpoint
             past the first position) and deepseek-v2-lite-16b in
             qwen2.5-3b's four, K6 gating on the card. Rows, ledger token
             columns, engine (and drafter) counters and every generated
             token must be identical across the two devices, and rows and
             tokens identical to the model's first mode in every mode (for
             MoE rows only: capacity is set per call, so a verify round
             drops assignments a decode step does not, and tokens may
             differ by mode); falcon-mamba-7b's recurrent state must also
             agree across the devices.

Every phase raises on a mismatch. Then it prints each phase's seconds,
the `kernels` summary line, the nvidia-smi line, and as its last line
{"ok": true, "device": {...}}. Any failure exits non-zero before that
line. It needs one CUDA device and exits non-zero without one, or when
the repository's `src/repro_torch` is not beside it.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published peaks of one H100 SXM (dense): HBM bytes/s and flop/s by type
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 2e-5, "topk": 1e-4}
# K6's weights against its plain version: float32 throughout, the softmax's
# exponentials and sum rounded in another order (the indices must be equal)
K6_TOL = 1e-6
# the recurrent state of a served SMOKE query, card against CPU, float32:
# the same recurrence, with matmuls summed in another order on the card
STATE_TOL = 1e-4
# exponentials per second on the SFU: 16 per clock per SM (NVIDIA's CUDA
# C++ documentation, the arithmetic instruction throughput table, compute
# capability 9.0) x 132 SMs x the H100 SXM's 1,980 MHz boost clock
SFU_OPS_S = 16 * 132 * 1.98e9


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype: str, exps: float = 0.0) -> tuple:
    """The least time (ms) for the work, and what bounds it: the bytes over
    HBM's rate, or the operations -- flops over the peak for their type,
    exponentials over the SFU's rate, whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = max(flops / PEAK_FLOPS[dtype], exps / SFU_OPS_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


# ------------------------------------------------------------- capture ---


class Capture:
    """Wrap a kernel wrapper (module attribute) to keep a copy of the inputs
    of its most demanding launch. The original wrapper still runs and
    counts the launch."""

    def __init__(self, module, name, size_of):
        self.module, self.name, self.size_of = module, name, size_of
        self.orig = getattr(module, name)
        self.best, self.args = -1, None
        setattr(module, name, self)

    def __call__(self, *args):
        size = self.size_of(*args)
        if size > self.best:
            self.best = size
            self.args = tuple(a.clone() if hasattr(a, "clone") else a for a in args)
        return self.orig(*args)

    def restore(self):
        setattr(self.module, self.name, self.orig)


# --------------------------------------------------------------- phases ---


def _legal_query(core):
    return core.Query(tables=["cases"], select=[("cases", "case_number")],
                      where=core.conj(core.Filter("year", ">=", 2015, table="cases"),
                                      core.Filter("charges", ">", 3, table="cases")))


SPEC = {"prefix_cache": True, "spec_decode": "prompt_lookup", "spec_k": 4}
SLAB = {"kv_layout": "slab"}
# The four qwen2.5-3b phases run the first MAIN_LAYERS of the 36 layers at
# full width, so that the whole command stays well inside its time limit:
# the four paths at 36 layers took 1,128 s of the 1,200 s with --profile
# on one H100 80GB HBM3; main and spec were cut first, then slab and draft
# when the moe phase and its reference modes came in (1,223 s with
# --profile, slab and draft still at 36 layers).
MAIN_LAYERS = 12
# The ssm and moe phases feed prompts in 128-token chunks: at 64 and 27
# layers their walls follow the number of forwards, and each chunk gives K7
# a real sequence and K6 a real batch of tokens.
DEEP_CHUNK = 128


def _cut(cfg, params):
    """The published config and weights cut to their first MAIN_LAYERS."""
    return (cfg.replace(num_layers=MAIN_LAYERS),
            {**params, "layers": params["layers"][:MAIN_LAYERS]})


def _served_query(cfg, params, corpus, device, max_new, chunk_size=32, **engine_kw):
    from repro_torch import core
    from repro_torch.extract import ServedExtractor
    from repro_torch.index.retriever import TwoLevelRetriever
    from repro_torch.serving import ServingEngine
    t0 = time.perf_counter()
    retriever = TwoLevelRetriever(corpus, device=device)
    build_s = time.perf_counter() - t0
    engine = ServingEngine(cfg, params, slots=4, max_len=1024, page_size=16,
                           chunk_size=chunk_size, device=device, **engine_kw)
    extractor = ServedExtractor(corpus, engine, max_new=max_new)
    session = core.Session(retriever, extractor, batch_size=4)
    return session, engine, extractor, build_s


def _ledger(result) -> dict:
    led = result.ledger
    return {"input_tokens": led.input_tokens, "output_tokens": led.output_tokens,
            "llm_calls": led.llm_calls, "extractions": led.extractions,
            "per_phase": led.per_phase}


def _check_like_main(name, result, main_result):
    """Rows and the ledger's token columns must equal the main phase's: the
    KV layout and the drafter change how tokens are computed, not which
    requests are served."""
    if len(result.rows) != len(main_result.rows) or not result.rows:
        raise AssertionError(f"{name}: {len(result.rows)} rows, main had "
                             f"{len(main_result.rows)}")
    for col in ("input_tokens", "output_tokens"):
        a, b = getattr(result.ledger, col), getattr(main_result.ledger, col)
        if a != b:
            raise AssertionError(f"{name}: ledger {col} {a} != main's {b}")


def _launch_counts():
    from repro_torch.kernels import decode_attention as k15
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import moe_gating as k6
    from repro_torch.kernels import ssm_scan as k7
    from repro_torch.kernels import topk_l2 as k3
    from repro_torch.kernels import verify_attention as k4
    return {"K1": k15.launches, "K2": k2.launches, "K3": k3.launches,
            "K4": k4.launches, "K5": k15.dense_launches, "K6": k6.launches,
            "K7": k7.launches}


def _zero_launches():
    from repro_torch.kernels import decode_attention as k15
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import moe_gating as k6
    from repro_torch.kernels import ssm_scan as k7
    from repro_torch.kernels import topk_l2 as k3
    from repro_torch.kernels import verify_attention as k4
    k15.launches = k15.dense_launches = k2.launches = k3.launches = k4.launches = 0
    k6.launches = k7.launches = 0


def _timed_query(session):
    import torch
    from repro_torch import core
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = session.prepare(_legal_query(core)).submit().result()
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0, _launch_counts()


def phase_main(seed: int, captures: dict) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import make_legal_corpus
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import topk_l2 as k3
    from repro_torch.models import init_params, param_count

    full_cfg = get_config("qwen2.5-3b")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    full_params = init_params(full_cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg, params = _cut(full_cfg, full_params)
    corpus = make_legal_corpus(seed=1)
    session, engine, extractor, build_s = _served_query(
        cfg, params, corpus, "cuda", max_new=12)

    captures["K1"] = Capture(k1, "paged_decode_attention",
                             lambda q, kp, vp, tbl, lens: tbl.shape[1] * q.shape[0])
    captures["K2"] = Capture(k2, "chunk_prefill_attention",
                             lambda q, kp, vp, ctx, start: start)
    captures["K3"] = Capture(k3, "topk_l2", lambda db, q, k: db.shape[0] * q.shape[0])
    result, wall, launches = _timed_query(session)
    for c in captures.values():
        c.restore()

    gen_tokens = extractor.stats.generated_tokens
    out = {"phase": "main", "model": cfg.name, "layers": cfg.num_layers,
           "layers_published": full_cfg.num_layers, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "params": param_count(params),
           "params_published": param_count(full_params),
           "docs": len(corpus.docs), "rows": len(result.rows), "ledger": _ledger(result),
           "engine": dict(engine.stats), "served_requests": extractor.stats.requests,
           "generated_tokens": gen_tokens, "weights_init_s": init_s,
           "index_build_s": build_s, "query_wall_s": wall,
           "generated_tokens_per_s": gen_tokens / wall,
           "launches": launches}
    emit(out)
    if not result.rows:
        raise AssertionError("the main-path query returned no rows")
    missing = [k for k in ("K1", "K2", "K3") if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    if not engine.stats["decode_steps"] or not engine.stats["prefill_chunks"]:
        raise AssertionError("the engine ran no decode step or no prefill chunk")
    return out, (session, extractor), (full_params, result, engine)


def _token_agreement(a: dict, b: dict) -> float:
    """Share of generated token positions equal between two runs' finished
    requests (by request id; a position one run lacks counts as unequal)."""
    same = total = 0
    for rid in set(a) | set(b):
        x, y = a.get(rid, []), b.get(rid, [])
        total += max(len(x), len(y))
        same += sum(1 for u, v in zip(x, y) if u == v)
    return same / total if total else 1.0


def phase_spec(main_run, captures: dict) -> dict:
    """The main query on the same weights with the prefix cache and
    prompt-lookup speculative decoding on."""
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import make_legal_corpus
    from repro_torch.kernels import verify_attention as k4

    full_params, main_result, main_engine = main_run
    cfg, params = _cut(get_config("qwen2.5-3b"), full_params)
    corpus = make_legal_corpus(seed=1)
    session, engine, extractor, build_s = _served_query(
        cfg, params, corpus, "cuda", max_new=12, **SPEC)
    captures["K4"] = Capture(k4, "paged_verify_attention",
                             lambda q, kp, vp, tbl, starts: tbl.shape[1] * q.shape[0])
    result, wall, launches = _timed_query(session)
    captures["K4"].restore()

    st = engine.stats
    gen_tokens = extractor.stats.generated_tokens
    out = {"phase": "spec", "model": cfg.name, "layers": cfg.num_layers,
           "engine_options": SPEC, "rows": len(result.rows), "ledger": _ledger(result),
           "engine": dict(st), "served_requests": extractor.stats.requests,
           "generated_tokens": gen_tokens, "index_build_s": build_s,
           "query_wall_s": wall, "generated_tokens_per_s": gen_tokens / wall,
           "acceptance": st["accepted_tokens"] / max(st["draft_tokens"], 1),
           "launches": launches,
           "rows_equal_main": result.rows == main_result.rows,
           "token_agreement_main": _token_agreement(
               {r: q.out for r, q in engine.finished.items()},
               {r: q.out for r, q in main_engine.finished.items()})}
    emit(out)
    if not result.rows:
        raise AssertionError("the spec-path query returned no rows")
    if launches["K4"] <= 0:
        raise AssertionError("K4 never launched on the spec path")
    if launches["K1"] != 0:
        raise AssertionError("K1 launched on the spec path: a decode round skipped verify")
    if st["prefix_hits"] <= 0 or st["spec_rounds"] <= 0:
        raise AssertionError("the spec path had no prefix hit or no verify round")
    return out, (session, extractor)


def phase_slab(main_run) -> tuple:
    """The main query on the slab layout, prefix cache and speculation off."""
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import make_legal_corpus

    full_params, main_result, _ = main_run
    cfg, params = _cut(get_config("qwen2.5-3b"), full_params)
    corpus = make_legal_corpus(seed=1)
    session, engine, extractor, build_s = _served_query(
        cfg, params, corpus, "cuda", max_new=12, **SLAB)
    result, wall, launches = _timed_query(session)
    st = engine.stats
    gen_tokens = extractor.stats.generated_tokens
    out = {"phase": "slab", "model": cfg.name, "layers": cfg.num_layers,
           "engine_options": SLAB, "rows": len(result.rows),
           "rows_main": len(main_result.rows), "ledger": _ledger(result),
           "engine": dict(st), "served_requests": extractor.stats.requests,
           "generated_tokens": gen_tokens, "index_build_s": build_s,
           "query_wall_s": wall, "generated_tokens_per_s": gen_tokens / wall,
           "launches": launches, "rows_equal_main": result.rows == main_result.rows}
    emit(out)
    _check_like_main("slab", result, main_result)
    L = cfg.num_layers
    if launches["K1"] or launches["K4"]:
        raise AssertionError(f"slab: K1/K4 launched on the slab path: {launches}")
    if launches["K5"] != L * st["decode_steps"] or not st["decode_steps"]:
        raise AssertionError(f"slab: K5 launched {launches['K5']} times for "
                             f"{st['decode_steps']} decode steps of {L} layers")
    if launches["K2"] != L * st["prefill_invocations"] or not launches["K3"]:
        raise AssertionError(f"slab: K2 {launches['K2']} for {st['prefill_invocations']} "
                             f"bucketed prefills, K3 {launches['K3']}")
    return out, (session, extractor), {r: q.out for r, q in engine.finished.items()}


def phase_draft(main_run, captures: dict, slab_tokens: dict) -> tuple:
    """The spec phase's engine with self-drafting instead of prompt lookup."""
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import make_legal_corpus
    from repro_torch.kernels import decode_attention as k15

    full_params, main_result, main_engine = main_run
    cfg, params = _cut(get_config("qwen2.5-3b"), full_params)
    corpus = make_legal_corpus(seed=1)
    opts = {**SPEC, "spec_decode": "draft"}
    session, engine, extractor, build_s = _served_query(
        cfg, params, corpus, "cuda", max_new=12, draft_model=(cfg, params), **opts)
    seen = [0]

    def late_launch(q, kc, vc, lens):            # keep a late launch, no sync
        seen[0] += 1
        return seen[0] if seen[0] == 1 or seen[0] % 900 == 0 else -1
    captures["K5"] = Capture(k15, "decode_attention", late_launch)
    result, wall, launches = _timed_query(session)
    captures["K5"].restore()
    if captures["K5"].args is None:
        raise AssertionError("draft: K5 captured no launch")
    st, dst = engine.stats, engine.drafter.stats
    gen_tokens = extractor.stats.generated_tokens
    out = {"phase": "draft", "model": cfg.name, "layers": cfg.num_layers,
           "engine_options": {**opts, "draft_model": "the target (self-draft)"},
           "rows": len(result.rows), "rows_main": len(main_result.rows),
           "ledger": _ledger(result), "engine": dict(st), "drafter": dict(dst),
           "served_requests": extractor.stats.requests,
           "generated_tokens": gen_tokens, "index_build_s": build_s,
           "query_wall_s": wall, "generated_tokens_per_s": gen_tokens / wall,
           "verify_rounds": st["spec_rounds"], "main_decode_steps": main_engine.stats["decode_steps"],
           "drafted": st["draft_tokens"], "accepted": st["accepted_tokens"],
           "acceptance": st["accepted_tokens"] / max(st["draft_tokens"], 1),
           "launches": launches, "rows_equal_main": result.rows == main_result.rows,
           "token_agreement_slab": _token_agreement(
               {r: q.out for r, q in engine.finished.items()}, slab_tokens)}
    emit(out)
    _check_like_main("draft", result, main_result)
    L = cfg.num_layers
    if launches["K1"]:
        raise AssertionError("draft: K1 launched: a decode round skipped verify")
    if launches["K5"] != L * dst["draft_model_steps"] or not launches["K5"]:
        raise AssertionError(f"draft: K5 launched {launches['K5']} times for "
                             f"{dst['draft_model_steps']} drafter steps of {L} layers")
    if not (launches["K2"] and launches["K3"] and launches["K4"]):
        raise AssertionError(f"draft: a kernel of the path never launched: {launches}")
    if st["spec_rounds"] <= 0 or st["draft_tokens"] <= 0:
        raise AssertionError("draft: no verify round or no draft token")
    return out, (session, extractor)


def phase_ssm(seed: int, captures: dict, main_result) -> tuple:
    """The main query on falcon-mamba-7b at full width and depth with the
    served settings (prefix cache, prompt lookup) and 128-token chunks."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import make_legal_corpus
    from repro_torch.kernels import ssm_scan as k7
    from repro_torch.models import init_params, param_count

    cfg = get_config("falcon-mamba-7b")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    corpus = make_legal_corpus(seed=1)
    session, engine, extractor, build_s = _served_query(
        cfg, params, corpus, "cuda", max_new=12, chunk_size=DEEP_CHUNK, **SPEC)
    # K7's inputs on two kinds of launch: the first full prompt chunk (B = 1,
    # S = DEEP_CHUNK, from a carried state) and the first verify round of all
    # four slots (B = 4, S = spec_k + 1, per-position states written)
    captures["K7_verify"] = Capture(
        k7, "ssm_scan", lambda x, dt, A, Bm, Cm, D, h0=None, states=None:
        1 if states is not None and x.shape[0] == 4 else -1)
    captures["K7"] = Capture(
        k7, "ssm_scan", lambda x, dt, A, Bm, Cm, D, h0=None, states=None:
        x.shape[1] if states is None and h0 is not None else -1)
    result, wall, launches = _timed_query(session)
    captures["K7"].restore()
    captures["K7_verify"].restore()
    if captures["K7"].args is None or captures["K7_verify"].args is None:
        raise AssertionError("ssm: K7 captured no prefill chunk or no verify launch")
    st = engine.stats
    gen_tokens = extractor.stats.generated_tokens
    out = {"phase": "ssm", "model": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "d_inner": cfg.d_inner, "ssm_state": cfg.ssm_state,
           "dtype": cfg.dtype, "params": param_count(params),
           "engine_options": {**SPEC, "chunk_size": DEEP_CHUNK},
           "rows": len(result.rows), "rows_main": len(main_result.rows),
           "rows_equal_main": result.rows == main_result.rows, "ledger": _ledger(result),
           "engine": dict(st), "served_requests": extractor.stats.requests,
           "generated_tokens": gen_tokens, "weights_init_s": init_s,
           "index_build_s": build_s, "query_wall_s": wall,
           "generated_tokens_per_s": gen_tokens / wall,
           "verify_rounds": st["spec_rounds"], "drafted": st["draft_tokens"],
           "accepted": st["accepted_tokens"], "prefix_hits": st["prefix_hits"],
           "kv_bytes_peak": st["kv_bytes_peak"], "launches": launches}
    emit(out)
    if not result.rows or result.rows != main_result.rows:
        raise AssertionError(f"ssm: {len(result.rows)} rows, not the main phase's "
                             f"{len(main_result.rows)}")
    if result.ledger.input_tokens != main_result.ledger.input_tokens:
        raise AssertionError(f"ssm: ledger input_tokens {result.ledger.input_tokens} != "
                             f"main's {main_result.ledger.input_tokens}")
    stray = {k: launches[k] for k in ("K1", "K2", "K4", "K5", "K6") if launches[k]}
    if stray or not launches["K3"]:
        raise AssertionError(f"ssm: attention or gating kernels launched or K3 did not: "
                             f"{launches}")
    forwards = st["prefill_chunks"] + st["spec_rounds"]
    if launches["K7"] != cfg.num_layers * forwards or not st["spec_rounds"]:
        raise AssertionError(f"ssm: K7 launched {launches['K7']} times for {forwards} "
                             f"chunk and verify forwards of {cfg.num_layers} layers")
    if st["prefix_hits"] <= 0:
        raise AssertionError("ssm: no prefix hit")
    return out, (session, extractor)


def phase_moe(seed: int, captures: dict, main_result) -> tuple:
    """The main query on deepseek-v2-lite-16b (MLA + MoE) at full width and
    depth with the served settings (prefix cache, prompt lookup) and
    128-token chunks: every forward gates each of its 26 MoE layers through
    K6, and MLA attends the compressed pool in plain PyTorch."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import make_legal_corpus
    from repro_torch.kernels import moe_gating as k6
    from repro_torch.models import init_params, param_count

    cfg = get_config("deepseek-v2-lite-16b")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    corpus = make_legal_corpus(seed=1)
    session, engine, extractor, build_s = _served_query(
        cfg, params, corpus, "cuda", max_new=12, chunk_size=DEEP_CHUNK, **SPEC)
    # K6's inputs on two kinds of launch: the first prompt chunk (T =
    # DEEP_CHUNK tokens) and the first verify round of all four slots (T =
    # 4 x (spec_k + 1))
    verify_T = 4 * (SPEC["spec_k"] + 1)
    captures["K6_verify"] = Capture(k6, "moe_gating", lambda lg, k: 1 if lg.shape[0] == verify_T
                                    else -1)
    captures["K6"] = Capture(k6, "moe_gating", lambda lg, k: 1 if lg.shape[0] == DEEP_CHUNK
                             else -1)
    result, wall, launches = _timed_query(session)
    captures["K6"].restore()
    captures["K6_verify"].restore()
    if captures["K6"].args is None or captures["K6_verify"].args is None:
        raise AssertionError("moe: K6 captured no prefill chunk or no verify launch")
    st = engine.stats
    gen_tokens = extractor.stats.generated_tokens
    n_moe = len(params["layers"])
    out = {"phase": "moe", "model": cfg.name, "layers": cfg.num_layers, "moe_layers": n_moe,
           "d_model": cfg.d_model, "experts": cfg.n_experts, "top_k": cfg.moe_top_k,
           "kv_lora_rank": cfg.kv_lora_rank, "dtype": cfg.dtype,
           "params": param_count(params),
           "engine_options": {**SPEC, "chunk_size": DEEP_CHUNK},
           "rows": len(result.rows), "rows_main": len(main_result.rows),
           "rows_equal_main": result.rows == main_result.rows, "ledger": _ledger(result),
           "engine": dict(st), "served_requests": extractor.stats.requests,
           "generated_tokens": gen_tokens, "weights_init_s": init_s,
           "index_build_s": build_s, "query_wall_s": wall,
           "generated_tokens_per_s": gen_tokens / wall,
           "verify_rounds": st["spec_rounds"], "drafted": st["draft_tokens"],
           "accepted": st["accepted_tokens"], "prefix_hits": st["prefix_hits"],
           "kv_bytes_peak": st["kv_bytes_peak"], "launches": launches}
    emit(out)
    if out["params"] != 15_706_484_224:
        raise AssertionError(f"moe: {out['params']} parameters, not deepseek-v2-lite-16b's")
    if not result.rows or result.rows != main_result.rows:
        raise AssertionError(f"moe: {len(result.rows)} rows, not the main phase's "
                             f"{len(main_result.rows)}")
    if result.ledger.input_tokens != main_result.ledger.input_tokens:
        raise AssertionError(f"moe: ledger input_tokens {result.ledger.input_tokens} != "
                             f"main's {main_result.ledger.input_tokens}")
    stray = {k: launches[k] for k in ("K1", "K2", "K4", "K5", "K7") if launches[k]}
    if stray or not launches["K3"]:
        raise AssertionError(f"moe: attention or scan kernels launched or K3 did not: "
                             f"{launches}")
    forwards = st["prefill_chunks"] + st["spec_rounds"]
    if launches["K6"] != n_moe * forwards or not st["spec_rounds"]:
        raise AssertionError(f"moe: K6 launched {launches['K6']} times for {forwards} "
                             f"chunk and verify forwards of {n_moe} MoE layers")
    if st["prefix_hits"] <= 0:
        raise AssertionError("moe: no prefix hit")
    return out, (session, extractor)


class _Spans:
    """Name the MoE path's two plain-PyTorch hot spots for the profiler,
    while the block is open: "mla_attention" (gathering each row's page
    view, the absorbed scores, softmax and context, writing the blocks
    back: what a paged MLA kernel would replace) and "moe_expert_bmm" (the
    experts' three batched products; `torch.bmm` has no other caller on
    the path)."""
    NAMES = ("mla_attention", "moe_expert_bmm")

    def __enter__(self):
        import torch
        from repro_torch.models import layers

        def named(fn, name):
            def run(*a, **kw):
                with torch.profiler.record_function(name):
                    return fn(*a, **kw)
            return run
        self.saved = [(layers, n, getattr(layers, n))
                      for n in ("page_view", "_mla_attend", "write_view_blocks")]
        self.saved.append((torch, "bmm", torch.bmm))
        for mod, n, fn in self.saved:
            setattr(mod, n, named(fn, "moe_expert_bmm" if n == "bmm" else "mla_attention"))
        return self

    def __exit__(self, *exc):
        for mod, n, fn in self.saved:
            setattr(mod, n, fn)


def phase_profile(session, extractor, out_dir, path: str) -> dict:
    """torch.profiler over one extraction round of a path's served model
    (4 legal documents, attribute `year`): wall time, the device's busy
    share, and device time by kernel group; on the moe path also the device
    time of MLA attention and of the expert products (`_Spans`)."""
    import contextlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    retriever = session.retriever
    docs = sorted(retriever.corpus.docs)[:4]
    items = [(d, "year", retriever.segments(d, "year", "cases")) for d in docs]
    extractor.extract_batch(items)                 # warm-up round
    torch.cuda.synchronize()
    spans = _Spans() if path == "moe" else contextlib.nullcontext()
    with spans, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        extractor.extract_batch(items)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups = {"K1 paged_decode": "paged_decode_kernel",
              "K2 chunk_prefill": "chunk_prefill_kernel",
              "K3 topk_l2": "topk_l2_kernel",
              "K4 paged_verify": "paged_verify_",      # its span and merge kernels
              "K5 dense_decode": "dense_decode_",      # its span and merge kernels
              "K6 moe_gating": "moe_gating_kernel",
              "K7 ssm_scan": "ssm_scan_kernel"}
    by_group = dict.fromkeys(list(groups) + ["gemm", "other"], 0.0)
    count_by_group = dict.fromkeys(by_group, 0)
    by_span = {}
    launches = 0
    for e in prof.key_averages():
        if e.key in _Spans.NAMES:                  # the span's kernels, summed; its
            if e.device_type != DeviceType.CUDA:   # device-side row is its extent
                by_span[e.key] = getattr(e, "device_time_total", None) or e.cuda_time_total
            continue
        if e.device_type != DeviceType.CUDA:       # device kernels only: an
            continue                               # op's own row repeats them
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        launches += e.count
        name = e.key
        g = next((g for g, k in groups.items() if k in name), None)
        if g is None:
            g = "gemm" if any(w in name.lower() for w in ("gemm", "nvjet", "cutlass", "sm90_xmma")) \
                else "other"
        by_group[g] += t
        count_by_group[g] += e.count
    busy = sum(by_group.values())
    out = {"phase": "profile", "path": path, "requests": len(items),
           "wall_ms": wall_us / 1e3,
           "device_busy_ms": busy / 1e3, "device_busy_share": busy / wall_us,
           "device_kernels": launches,
           "device_ms_by_group": {g: t / 1e3 for g, t in by_group.items()},
           "device_launches_by_group": count_by_group}
    if path == "moe":
        out["device_ms_by_span"] = {n: by_span.get(n, 0.0) / 1e3 for n in _Spans.NAMES}
    emit(out)
    if out_dir:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        ev = prof.key_averages()
        key = "self_device_time_total" if ev and hasattr(ev[0], "self_device_time_total") \
            else "self_cuda_time_total"
        (Path(out_dir) / f"profile_table_{path}.txt").write_text(
            ev.table(sort_by=key, row_limit=40))
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    return out


def phase_kernels(captures: dict, launches: dict) -> list:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import topk_l2 as k3
    from repro_torch.kernels import verify_attention as k4

    rows = []

    # ------------------------------------------------------------- K1 --
    q, kp, vp, tbl, lens = captures["K1"].args
    dt = str(q.dtype).removeprefix("torch.")
    errs = {}
    errs[dt] = max_err(k1.paged_decode_attention(q, kp, vp, tbl, lens),
                       k1.paged_decode_attention_plain(q, kp, vp, tbl, lens))
    q32, kp32, vp32 = q.float(), kp.float(), vp.float()
    errs["float32"] = max_err(k1.paged_decode_attention(q32, kp32, vp32, tbl, lens),
                              k1.paged_decode_attention_plain(q32, kp32, vp32, tbl, lens))
    # edge cases: a dead row (all-sink table, length past nb * ps) and a
    # zero length
    tbl_e, lens_e = tbl.clone(), lens.clone()
    tbl_e[0] = 0
    lens_e[0] = tbl.shape[1] * kp.shape[1] * 3
    lens_e[-1] = 0
    got = k1.paged_decode_attention(q32, kp32, vp32, tbl_e, lens_e)
    errs["edge"] = max_err(got, k1.paged_decode_attention_plain(q32, kp32, vp32, tbl_e, lens_e))
    if float(got[-1].abs().max()) != 0.0:
        raise AssertionError("K1: lengths == 0 must give zeros")
    B, H, D = q.shape
    Hkv, ps = kp.shape[2], kp.shape[1]
    vis = torch.clamp(lens.long(), max=tbl.shape[1] * ps)
    nbytes = (2 * int(vis.sum()) * Hkv * D + 2 * B * H * D) * q.element_size() \
        + tbl.numel() * 4 + lens.numel() * 4
    flops = 4 * int(vis.sum()) * H * D
    b_ms, b_by = bound(nbytes, flops, dt)
    idx = tbl.long()
    S = tbl.shape[1] * ps
    kg = kp[idx].reshape(B, S, Hkv, D).transpose(1, 2).repeat_interleave(H // Hkv, 1)
    vg = vp[idx].reshape(B, S, Hkv, D).transpose(1, 2).repeat_interleave(H // Hkv, 1)
    mask = (torch.arange(S, device=q.device)[None, :] < lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    rows.append(dict(
        name="paged_decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:101",
        launches=launches["K1"], shape=f"q{tuple(q.shape)} table{tuple(tbl.shape)} {dt}",
        max_abs_err=errs[dt], tol=TOL[dt], max_abs_err_float32=errs["float32"],
        max_abs_err_edge_float32=errs["edge"], tol_float32=TOL["float32"],
        ms=cuda_ms(lambda: k1.paged_decode_attention(q, kp, vp, tbl, lens)),
        plain_ms=cuda_ms(lambda: k1.paged_decode_attention_plain(q, kp, vp, tbl, lens)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q4, kg, vg,
                                                                  attn_mask=mask)),
        library_call="F.scaled_dot_product_attention over a pre-gathered view",
        bound_ms=b_ms, bound_by=b_by))

    # ------------------------------------------------------------- K2 --
    q, kp, vp, ctx, start = captures["K2"].args
    dt = str(q.dtype).removeprefix("torch.")
    errs = {dt: max_err(k2.chunk_prefill_attention(q, kp, vp, ctx, start),
                        k2.chunk_prefill_attention_plain(q, kp, vp, ctx, start))}
    q32, kp32, vp32 = q.float(), kp.float(), vp.float()
    errs["float32"] = max_err(k2.chunk_prefill_attention(q32, kp32, vp32, ctx, start),
                              k2.chunk_prefill_attention_plain(q32, kp32, vp32, ctx, start))
    # edge case: the first chunk of a sequence (start = 0)
    errs["edge"] = max_err(k2.chunk_prefill_attention(q32, kp32, vp32, ctx, 0),
                           k2.chunk_prefill_attention_plain(q32, kp32, vp32, ctx, 0))
    C, H, D = q.shape
    Hkv, ps = kp.shape[2], kp.shape[1]
    pairs = sum(start + i + 1 for i in range(C))
    nbytes = (2 * (start + C) * Hkv * D + 2 * C * H * D) * q.element_size() + ctx.numel() * 4
    flops = 4 * pairs * H * D
    b_ms, b_by = bound(nbytes, flops, dt)
    S = ctx.shape[0] * ps
    idx = ctx.long()
    kg = kp[idx].reshape(S, Hkv, D).transpose(0, 1).repeat_interleave(H // Hkv, 0)[None]
    vg = vp[idx].reshape(S, Hkv, D).transpose(0, 1).repeat_interleave(H // Hkv, 0)[None]
    qpos = start + torch.arange(C, device=q.device)
    mask = (torch.arange(S, device=q.device)[None, :] <= qpos[:, None])[None, None]
    q4 = q.transpose(0, 1)[None]
    rows.append(dict(
        name="chunk_prefill_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/chunk_prefill_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:71",
        launches=launches["K2"],
        shape=f"q{tuple(q.shape)} start={start} ctx{tuple(ctx.shape)} {dt}",
        max_abs_err=errs[dt], tol=TOL[dt], max_abs_err_float32=errs["float32"],
        max_abs_err_edge_float32=errs["edge"], tol_float32=TOL["float32"],
        ms=cuda_ms(lambda: k2.chunk_prefill_attention(q, kp, vp, ctx, start)),
        plain_ms=cuda_ms(lambda: k2.chunk_prefill_attention_plain(q, kp, vp, ctx, start)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q4, kg, vg,
                                                                  attn_mask=mask)),
        library_call="F.scaled_dot_product_attention over a pre-gathered view",
        bound_ms=b_ms, bound_by=b_by))

    # ------------------------------------------------------------- K3 --
    db, qq, k = captures["K3"].args
    d, i = k3.topk_l2(db, qq, k)
    dp, ip = k3.topk_l2_plain(db, qq, k)
    err = max_err(d, dp)
    # the indices must realise the reported distances (near-ties may swap)
    d2 = ((qq[:, None, :] - db[None]) ** 2).sum(-1)
    realised = torch.sqrt(torch.clamp(torch.gather(d2, 1, i.long()), min=0.0))
    err = max(err, max_err(realised, d))
    # edge case: exact ties (duplicated rows) resolve lowest index first
    dup = torch.cat([db[:100], db[:100], db[50:150]])
    qd = torch.cat([qq[:2], db[10:11]])
    de, ie = k3.topk_l2(dup, qd, dup.shape[0])
    dpe, ipe = k3.topk_l2_plain(dup, qd, dup.shape[0])
    if not torch.equal(ie, ipe):
        raise AssertionError("K3: exact ties must order lowest index first")
    err = max(err, max_err(de, dpe))
    M, D = qq.shape
    N = db.shape[0]
    nbytes = (N * D + M * D) * 4 + M * k * 8
    b_ms, b_by = bound(nbytes, 3 * M * N * D, "float32")
    rows.append(dict(
        name="topk_l2", route="cuda", source="src/repro_torch/kernels/csrc/topk_l2.cu",
        replaces="src/repro/kernels/topk_l2.py:55", launches=launches["K3"],
        shape=f"db{tuple(db.shape)} q{tuple(qq.shape)} k={k} float32",
        max_abs_err=err, tol=TOL["topk"],
        ms=cuda_ms(lambda: k3.topk_l2(db, qq, k)),
        plain_ms=cuda_ms(lambda: k3.topk_l2_plain(db, qq, k)),
        library_ms=cuda_ms(lambda: torch.sort(torch.cdist(qq, db), dim=1, stable=True)),
        library_call="torch.cdist + torch.sort(stable=True)",
        bound_ms=b_ms, bound_by=b_by))

    # ------------------------------------------------------------- K4 --
    q, kp, vp, tbl, starts = captures["K4"].args
    dt = str(q.dtype).removeprefix("torch.")
    errs = {dt: max_err(k4.paged_verify_attention(q, kp, vp, tbl, starts),
                        k4.paged_verify_attention_plain(q, kp, vp, tbl, starts))}
    q32, kp32, vp32 = q.float(), kp.float(), vp.float()
    errs["float32"] = max_err(k4.paged_verify_attention(q32, kp32, vp32, tbl, starts),
                              k4.paged_verify_attention_plain(q32, kp32, vp32, tbl, starts))
    # edge cases on the captured pools: a start that is not page-aligned
    # with candidates crossing a page, a dead all-sink row with a stale
    # start, start 0; then the JAX package's own K4 test shapes (ps = 256
    # at D = 128 among them) on seeded inputs
    B, H, C, D = q.shape
    Hkv, ps = kp.shape[2], kp.shape[1]
    nb = tbl.shape[1]
    tbl_e, st_e = tbl.clone(), starts.clone()
    st_e[0] = ps - C // 2 - 1 + ps * (nb // 2 - 1)
    tbl_e[1 % B] = 0
    st_e[1 % B] = nb * ps * 3
    st_e[-1] = 0
    errs["edge"] = max_err(k4.paged_verify_attention(q32, kp32, vp32, tbl_e, st_e),
                           k4.paged_verify_attention_plain(q32, kp32, vp32, tbl_e, st_e))
    gen = torch.Generator(device="cuda").manual_seed(7)
    for (b, h, hkv, c, d, p, pgs, n) in ((2, 4, 2, 5, 64, 16, 128, 4),
                                         (3, 2, 1, 3, 128, 9, 256, 2)):
        for tdt in (torch.float32, torch.bfloat16):
            qe = torch.randn((b, h, c, d), generator=gen, device="cuda").to(tdt)
            ke = torch.randn((p, pgs, hkv, d), generator=gen, device="cuda").to(tdt)
            ve = torch.randn((p, pgs, hkv, d), generator=gen, device="cuda").to(tdt)
            te = torch.randperm(p, generator=gen, device="cuda")[: b * n].reshape(b, n).int()
            se = torch.tensor([(n * pgs * (i + 1)) // (b + 1) - c // 2 for i in range(b)],
                              dtype=torch.int32, device="cuda")
            err = max_err(k4.paged_verify_attention(qe, ke, ve, te, se),
                          k4.paged_verify_attention_plain(qe, ke, ve, te, se))
            key = "edge" if tdt == torch.float32 else "edge_bf16"
            errs[key] = max(errs.get(key, 0.0), err)
    if errs["edge_bf16"] > TOL["bfloat16"]:
        raise AssertionError(f"K4: bf16 error {errs['edge_bf16']} at the test shapes")
    vis = torch.clamp(starts.long() + C, max=nb * ps)
    pairs = int(sum(torch.clamp(starts.long() + c + 1, max=nb * ps).sum() for c in range(C)))
    nbytes = (2 * int(vis.sum()) * Hkv * D + 2 * B * H * C * D) * q.element_size() \
        + tbl.numel() * 4 + starts.numel() * 4
    flops = 4 * pairs * H * D
    b_ms, b_by = bound(nbytes, flops, dt)
    idx = tbl.long()
    S = nb * ps
    kg = kp[idx].reshape(B, S, Hkv, D).transpose(1, 2).repeat_interleave(H // Hkv, 1)
    vg = vp[idx].reshape(B, S, Hkv, D).transpose(1, 2).repeat_interleave(H // Hkv, 1)
    qpos = starts.long()[:, None] + torch.arange(C, device=q.device)[None, :]
    mask = (torch.arange(S, device=q.device)[None, None, :] <= qpos[:, :, None])[:, None]
    rows.append(dict(
        name="paged_verify_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_verify_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:185",
        launches=launches["K4"],
        shape=f"q{tuple(q.shape)} table{tuple(tbl.shape)} starts {starts.tolist()} {dt}",
        max_abs_err=errs[dt], tol=TOL[dt], max_abs_err_float32=errs["float32"],
        max_abs_err_edge_float32=errs["edge"], max_abs_err_edge_bf16=errs["edge_bf16"],
        tol_float32=TOL["float32"],
        ms=cuda_ms(lambda: k4.paged_verify_attention(q, kp, vp, tbl, starts)),
        plain_ms=cuda_ms(lambda: k4.paged_verify_attention_plain(q, kp, vp, tbl, starts)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, kg, vg,
                                                                  attn_mask=mask)),
        library_call="F.scaled_dot_product_attention over a pre-gathered view "
                     "with the per-candidate causal mask",
        bound_ms=b_ms, bound_by=b_by))

    # ------------------------------------------------------------- K5 --
    q, kc, vc, lens = captures["K5"].args
    dt = str(q.dtype).removeprefix("torch.")
    B, H, D = q.shape
    S, Hkv = kc.shape[1], kc.shape[2]
    errs = {dt: max_err(k1.decode_attention(q, kc, vc, lens),
                        k1.decode_attention_plain(q, kc, vc, lens))}
    q32, kc32, vc32 = q.float(), kc.float(), vc.float()
    errs["float32"] = max_err(k1.decode_attention(q32, kc32, vc32, lens),
                              k1.decode_attention_plain(q32, kc32, vc32, lens))
    # edge cases on the captured slab: per-row lengths 1, S and one past S
    # (a slot that is not live), then a zero length (zeros) and a scalar
    lens_e = torch.tensor([1, S, S + 1, 0][:B] + [S // 2] * max(0, B - 4),
                          dtype=torch.int32, device=q.device)
    got = k1.decode_attention(q32, kc32, vc32, lens_e)
    errs["edge"] = max(max_err(got, k1.decode_attention_plain(q32, kc32, vc32, lens_e)),
                       max_err(k1.decode_attention(q32, kc32, vc32, S // 3),
                               k1.decode_attention_plain(q32, kc32, vc32, S // 3)))
    got_bf = k1.decode_attention(q, kc, vc, lens_e)
    errs["edge_bf16"] = max_err(got_bf, k1.decode_attention_plain(q, kc, vc, lens_e))
    if B >= 4 and (float(got[3].abs().max()) != 0.0 or float(got_bf[3].abs().max()) != 0.0):
        raise AssertionError("K5: a zero length must give zeros")
    if errs["edge_bf16"] > TOL["bfloat16"]:
        raise AssertionError(f"K5: bf16 edge error {errs['edge_bf16']}")
    vis = torch.clamp(lens.long(), 0, S)
    nbytes = (2 * int(vis.sum()) * Hkv * D + 2 * B * H * D) * q.element_size() \
        + lens.numel() * 4
    flops = 4 * int(vis.sum()) * H * D
    b_ms, b_by = bound(nbytes, flops, dt)
    G = H // Hkv
    kg = kc.transpose(1, 2).repeat_interleave(G, 1)
    vg = vc.transpose(1, 2).repeat_interleave(G, 1)
    mask = (torch.arange(S, device=q.device)[None, :] < lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    rows.append(dict(
        name="dense_decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/dense_decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:274",
        launches=launches["K5"], launches_slab=launches.get("K5_slab"),
        shape=f"q{tuple(q.shape)} cache{tuple(kc.shape)} lengths {lens.tolist()} {dt}",
        max_abs_err=errs[dt], tol=TOL[dt], max_abs_err_float32=errs["float32"],
        max_abs_err_edge_float32=errs["edge"], max_abs_err_edge_bf16=errs["edge_bf16"],
        tol_float32=TOL["float32"],
        ms=cuda_ms(lambda: k1.decode_attention(q, kc, vc, lens)),
        plain_ms=cuda_ms(lambda: k1.decode_attention_plain(q, kc, vc, lens)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q4, kg, vg,
                                                                  attn_mask=mask)),
        library_call="F.scaled_dot_product_attention over the slab in (B, H, S, D) "
                     "with a per-row length mask",
        bound_ms=b_ms, bound_by=b_by))

    rows.append(_kernel_k6(captures, launches))
    rows.append(_kernel_k7(captures, launches))

    for r in rows:
        r["kernel_ms"] = r["ms"]
        emit({"phase": "kernels", **r})
        for key in ("max_abs_err", "max_abs_err_float32", "max_abs_err_edge_float32"):
            tol = r["tol"] if key == "max_abs_err" else r.get("tol_float32", r["tol"])
            if key in r and not r[key] <= tol:
                raise AssertionError(f"{r['name']}: {key}={r[key]} > {tol}")
    return rows


def _kernel_k6(captures: dict, launches: dict) -> dict:
    """K6 on the inputs of a captured prefill chunk (T = DEEP_CHUNK) and
    verify round, and on edge cases, against `moe_gating_plain`: the
    weights within K6_TOL (float32 throughout; the softmax's exponentials
    and sum round differently) and the indices identical, in order."""
    import torch
    from repro_torch.kernels import moe_gating as k6

    def errs_of(logits, k):
        wk, ik = k6.moe_gating(logits, k)
        wp, ip = k6.moe_gating_plain(logits, k)
        return max_err(wk, wp), bool(torch.equal(ik, ip))

    gen = torch.Generator(device="cuda").manual_seed(12)

    def r(T, E, scale=1.0):
        return torch.randn((T, E), generator=gen, device="cuda") * scale
    pre, ver = captures["K6"].args, captures["K6_verify"].args
    cases = {"chunk": pre, "verify": ver, "T=1": (r(1, 64), 6), "E=8,k=2": (r(100, 8, 2.0), 2),
             "E=4,k=2": (r(17, 4, 2.0), 2), "E=160": (r(64, 160), 6),
             "E=256,k=8": (r(40, 256), 8),
             "all equal": (torch.full((9, 64), 0.37, device="cuda"), 6),
             "bf16-rounded": (r(512, 64, 0.9).bfloat16().float(), 6), "T=37": (r(37, 64), 6)}
    errs, same = {}, {}
    for name, (lg, k) in cases.items():
        errs[name], same[name] = errs_of(lg, k)
    w_eq, i_eq = k6.moe_gating(cases["all equal"][0], 6)
    if not torch.equal(i_eq.cpu(), torch.arange(6, dtype=torch.int32).expand(9, 6)) or \
            max_err(w_eq, torch.full_like(w_eq, 1 / 6)) > K6_TOL:
        raise AssertionError("K6: equal logits must give indices 0..k-1 and weights 1/k")
    bad = {n: (errs[n], same[n]) for n in cases if not (errs[n] <= K6_TOL and same[n])}
    if bad:
        raise AssertionError(f"K6 disagrees with its plain version (error, indices equal): {bad}")

    def work(logits, k):
        """bytes (logits read, weights and indices written), flops (exp
        argument, sum, divide, k rounds of compares), exponentials"""
        T, E = logits.shape
        return T * E * 4 + T * k * 8, T * E * (3 + k), T * E

    def library(logits, k):
        w, _ = torch.topk(torch.softmax(logits, dim=-1), k)
        return w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    nbytes, flops, exps = work(*pre)
    b_ms, b_by = bound(nbytes, flops, "float32", exps)
    vb_ms, vb_by = bound(*work(*ver)[:2], "float32", work(*ver)[2])
    edges = [n for n in cases if n not in ("chunk", "verify")]
    return dict(
        name="moe_gating", route="cuda", source="src/repro_torch/kernels/csrc/moe_gating.cu",
        replaces="src/repro/kernels/moe_gating.py:47", launches=launches["K6"],
        shape=f"logits{tuple(pre[0].shape)} k={pre[1]} float32 (a prefill chunk)",
        shape_verify=f"logits{tuple(ver[0].shape)} k={ver[1]} float32 (a verify round)",
        max_abs_err=errs["chunk"], tol=K6_TOL, max_abs_err_verify=errs["verify"],
        max_abs_err_edge_float32=max(errs[n] for n in edges), tol_float32=K6_TOL,
        indices_identical=all(same.values()), edge_cases=edges,
        ms=cuda_ms(lambda: k6.moe_gating(*pre)),
        plain_ms=cuda_ms(lambda: k6.moe_gating_plain(*pre)),
        ms_verify=cuda_ms(lambda: k6.moe_gating(*ver)),
        plain_ms_verify=cuda_ms(lambda: k6.moe_gating_plain(*ver)),
        library_ms=cuda_ms(lambda: library(*pre)),
        library_call="torch.softmax + torch.topk + renormalise",
        bound_ms=b_ms, bound_by=b_by, bound_ms_verify=vb_ms, bound_by_verify=vb_by,
        bound_bytes=nbytes)


def _k7_work(x, N, h0, states) -> tuple:
    """Bytes K7 must move (each input read once, each output written once),
    its flops and its exponentials, for x (B, S, di) and state size N."""
    B, S, di = x.shape
    e = x.element_size()
    nbytes = (3 * B * S * di + 2 * B * S * N + di) * e + di * N * 4 + B * di * N * 4 \
        + (B * di * N * 4 if h0 is not None else 0) \
        + (B * S * di * N * 4 if states is not None else 0)
    return nbytes, B * S * di * (6 * N + 3), B * S * di * N


def _kernel_k7(captures: dict, launches: dict) -> dict:
    """K7 on the inputs of a captured prefill chunk and verify round, and on
    edge cases, against `ssm_scan_plain`. Tolerances: y in bf16 at 2e-2
    (one bf16 rounding of an fp32 value the kernel and the plain version
    sum in another order), as the other kernels; in float32, y and the fp32
    states at 2e-5 (the state update rounds as the plain version's
    unfused ops; only the order of y's sum over N differs). With random
    weights y is mostly D * x and the captured launches' scan term
    sum_n h C is far below either tolerance (reported, not relied on), so
    the edge cases run at unit scale at the captured widths, where the
    scan term must exceed ten times the float32 tolerance: a y without
    it fails there."""
    import torch
    from repro_torch.kernels import ssm_scan as k7

    def errs_of(args, states=None):
        """(y error, final-state error, states error) of kernel vs plain."""
        x, dt, A, Bm, Cm, D, h0 = (list(args) + [None])[:7]
        st_k = st_p = None
        if states is not None:
            st_k, st_p = torch.empty_like(states), torch.empty_like(states)
        yk, hk = k7.ssm_scan(x, dt, A, Bm, Cm, D, h0, st_k)
        yp, hp = k7.ssm_scan_plain(x, dt, A, Bm, Cm, D, h0, st_p)
        return (max_err(yk, yp), max_err(hk, hp),
                max_err(st_k, st_p) if states is not None else 0.0)

    def f32(args):
        return tuple(a.float() if a is not None and a.dtype == torch.bfloat16 else a
                     for a in args)

    pre = captures["K7"].args                      # (x, dt, A, B, C, D, h0)
    ver = captures["K7_verify"].args               # (..., h0, states)
    x, dt, A, Bm, Cm, D, h0 = pre
    dtn = str(x.dtype).removeprefix("torch.")
    N = A.shape[1]
    errs = {}
    errs[dtn], errs["state"], _ = errs_of(pre)
    e_y, e_h, e_s = errs_of(ver[:7], ver[7])
    errs["verify"], errs["state"] = e_y, max(errs["state"], e_h, e_s)
    y32, h32, _ = errs_of(f32(pre))
    vy32, vh32, vs32 = errs_of(f32(ver[:7]), ver[7])
    errs["float32"] = max(y32, h32, vy32, vh32, vs32)

    def scan_term(args):
        """max |y - D x| of the plain version in float32: the part of y
        the scan contributes."""
        xf, dtf, Af, Bf, Cf, Df, h0f = f32(args[:7])
        yp, _ = k7.ssm_scan_plain(xf, dtf, Af, Bf, Cf, Df, h0f)
        return (yp - Df * xf).abs().max().item()
    errs["scan_term"] = max(scan_term(pre), scan_term(ver))
    # edge cases at unit scale (the JAX package's K7 test distributions) on
    # the captured widths and on SMOKE's: h0 = None, S = 1, a verify-shaped
    # S = 5 from a carried state, dt zeroed past a true length (the state
    # must freeze), N = 8 with di = 128
    gen = torch.Generator(device="cuda").manual_seed(11)

    def unit(B, S, di, n, dtype):
        def r(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device="cuda") * scale
        xs = r(B, S, di, scale=0.5)
        dts = torch.nn.functional.softplus(r(B, S, di) - 1.0)
        As = -torch.exp(r(di, n, scale=0.3))
        return [xs.to(dtype), dts.to(dtype), As, r(B, S, n, scale=0.5).to(dtype),
                r(B, S, n, scale=0.5).to(dtype), torch.ones(di, device="cuda").to(dtype),
                r(B, di, n)]
    di = x.shape[2]
    edge32, edge_bf, edge_scan = 0.0, 0.0, float("inf")
    for B, S, width, n, h0_none, cut in ((1, 128, di, N, True, None), (4, 1, di, N, False, None),
                                         (4, 5, di, N, False, None),
                                         (1, 128, di, N, False, 77), (2, 37, 128, 8, False, 20),
                                         (3, 5, 96, 4, True, None)):
        for dtype in (torch.float32, torch.bfloat16):
            args = unit(B, S, width, n, dtype)
            if cut is not None:
                args[1][:, cut:] = 0
            if h0_none:
                args[6] = None
            states = torch.empty((B, S, width, n), device="cuda")
            ey, eh, es = errs_of(args, states)
            if dtype == torch.float32:
                edge32 = max(edge32, ey, eh, es)
                edge_scan = min(edge_scan, scan_term(args))
            else:
                edge_bf = max(edge_bf, ey)
                edge32 = max(edge32, eh, es)
            if cut is not None:                       # frozen past the length
                st_k = torch.empty_like(states)
                k7.ssm_scan(*args[:7], st_k)
                if not torch.equal(st_k[:, cut:], st_k[:, cut - 1:cut].expand_as(st_k[:, cut:])):
                    raise AssertionError("K7: the state moved where dt is zero")
    errs["edge"], errs["edge_bf16"] = edge32, edge_bf
    for key, tol in ((dtn, TOL[dtn]), ("verify", TOL[dtn]), ("edge_bf16", TOL["bfloat16"]),
                     ("state", TOL["float32"]), ("float32", TOL["float32"]),
                     ("edge", TOL["float32"])):
        if not errs[key] <= tol:
            raise AssertionError(f"K7: {key} error {errs[key]} > {tol}")
    if not edge_scan > 10 * TOL["float32"]:
        raise AssertionError(f"K7: the edge cases' scan term {edge_scan} is too small for "
                             f"the float32 check to see it")
    nbytes, flops, exps = _k7_work(x, N, h0, None)
    b_ms, b_by = bound(nbytes, flops, "float32", exps)
    vx, vh0, vst = ver[0], ver[6], ver[7]
    vbytes, vflops, vexps = _k7_work(vx, N, vh0, vst)
    vb_ms, vb_by = bound(vbytes, vflops, "float32", vexps)
    return dict(
        name="ssm_scan", route="cuda", source="src/repro_torch/kernels/csrc/ssm_scan.cu",
        replaces="src/repro/kernels/ssm_scan.py:55", launches=launches["K7"],
        shape=f"x{tuple(x.shape)} N={N} h0 {dtn} (a prefill chunk)",
        shape_verify=f"x{tuple(vx.shape)} N={N} h0 + states {dtn} (a verify round)",
        max_abs_err=errs[dtn], tol=TOL[dtn], max_abs_err_verify=errs["verify"],
        max_abs_err_state=errs["state"], max_abs_err_float32=errs["float32"],
        max_abs_err_edge_float32=errs["edge"], max_abs_err_edge_bf16=errs["edge_bf16"],
        tol_float32=TOL["float32"], scan_term_max_abs=errs["scan_term"],
        edge_scan_term_min=edge_scan,
        ms=cuda_ms(lambda: k7.ssm_scan(*pre)),
        plain_ms=cuda_ms(lambda: k7.ssm_scan_plain(*pre), iters=10, warmup=2),
        ms_verify=cuda_ms(lambda: k7.ssm_scan(*ver)),
        plain_ms_verify=cuda_ms(lambda: k7.ssm_scan_plain(*ver), iters=10, warmup=2),
        library_ms=None, library_call="none: no single PyTorch call computes a selective scan",
        bound_ms=b_ms, bound_by=b_by, bound_ms_verify=vb_ms, bound_by_verify=vb_by,
        bound_bytes=nbytes, bound_exps=exps)


class _Scripted:
    """Drafter proposing each request's known greedy continuation (the
    off mode's tokens) with every token from index `good` on corrupted, so
    every round accepts some drafts and rolls the rest back: the Mamba1
    state is restored from a checkpoint past the first position."""

    def __init__(self, truth: dict, good: int, vocab: int):
        self.truth, self.good, self.vocab = truth, good, vocab

    def on_insert(self, slot, req):
        pass

    def on_free(self, slot):
        pass

    def draft_round(self, reqs, k_eff):
        out = {}
        for slot, req in reqs.items():
            d = self.truth[req.rid][len(req.out):][: k_eff.get(slot, 0)]
            out[slot] = [t if i < self.good else (t + 1) % self.vocab for i, t in enumerate(d)]
        return out


def phase_reference(seed: int) -> dict:
    """The served path at a small size, card against the CPU's plain path:
    qwen2.5-3b in four modes (off, prompt lookup with the prefix cache, the
    slab layout with the prefix cache, self-drafting), falcon-mamba-7b
    in four (off, prompt lookup with the prefix cache, slab with the prefix
    cache, and scripted drafts that accept two of four, so that rejected
    drafts roll back to a checkpoint past the first position) and
    deepseek-v2-lite-16b in four (qwen2.5-3b's modes; K6 gates every MoE
    layer on the card).
    Falcon-mamba-7b's per-slot recurrent state after the query must
    also agree across the devices to STATE_TOL: with random SMOKE weights
    the skip path D * x dominates each block, so its tokens alone say little
    about the state."""
    import torch
    from repro_torch import core
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import lm_data
    from repro_torch.data.corpus import make_legal_corpus
    from repro_torch.kernels import moe_gating as k6
    from repro_torch.models import init_params

    full = make_legal_corpus(seed=1)
    corpus = full.subset(sorted(full.docs)[:20])
    models = {"qwen2.5-3b": {"off": {}, "spec": SPEC, "slab": {**SLAB, "prefix_cache": True},
                             "draft": {"spec_decode": "draft", "spec_k": 4}},
              "falcon-mamba-7b": {"off": {}, "spec": SPEC,
                                  "slab": {**SLAB, "prefix_cache": True},
                                  "rollback": {"prefix_cache": True, "spec_k": 4}},
              "deepseek-v2-lite-16b": {"off": {}, "spec": SPEC,
                                       "slab": {**SLAB, "prefix_cache": True},
                                       "draft": {"spec_decode": "draft", "spec_k": 4}}}
    runs, states, gating = {}, {}, {}
    for arch, modes in models.items():
        cfg = get_smoke_config(arch).replace(vocab_size=lm_data.VOCAB)
        cpu_params = init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
        for mode, engine_kw in modes.items():
            for device in ("cuda", "cpu"):
                params = _to(cpu_params, device)
                if mode == "draft":
                    engine_kw = {**engine_kw, "draft_model": (cfg, params)}
                if mode == "rollback":
                    engine_kw = {**engine_kw, "spec_decode": _Scripted(
                        runs[arch, "off", "cpu"][5], good=2, vocab=cfg.vocab_size)}
                session, engine, _, _ = _served_query(cfg, params, corpus, device,
                                                      max_new=6, **engine_kw)
                k6.launches = 0
                res = session.prepare(_legal_query(core)).submit().result()
                gating[arch, mode, device] = k6.launches
                runs[arch, mode, device] = (
                    res.rows, res.ledger.input_tokens, res.ledger.output_tokens,
                    res.ledger.per_phase, dict(engine.stats),
                    {r: q.out for r, q in engine.finished.items()},
                    dict(getattr(engine.drafter, "stats", {})))
                if "ssm" in engine.cache:
                    states[arch, mode, device] = {k: engine.cache[k].cpu()
                                                  for k in ("conv", "ssm")}
    keys = [(arch, mode) for arch, modes in models.items() for mode in modes]
    same = {f"{a}/{m}": runs[a, m, "cuda"] == runs[a, m, "cpu"] for a, m in keys}
    # rows and tokens equal the off mode's; for MoE rows only: capacity is
    # set per call, so a verify round of 20 tokens drops assignments that a
    # decode step of 4 never does, and tokens may differ by mode (as in the
    # JAX package); the card must still equal the CPU in every mode
    cut = {a: 1 if a == "deepseek-v2-lite-16b" else 2 for a in models}
    invariant = {f"{a}/{m}/{dev}": (runs[a, "off", dev][0], runs[a, "off", dev][5])[:cut[a]] ==
                 (runs[a, m, dev][0], runs[a, m, dev][5])[:cut[a]]
                 for a, m in keys if m != "off" for dev in ("cuda", "cpu")}
    moe_tokens = {f"{m}/{dev}": _token_agreement(runs["deepseek-v2-lite-16b", "off", dev][5],
                                                 runs["deepseek-v2-lite-16b", m, dev][5])
                  for m in models["deepseek-v2-lite-16b"] if m != "off"
                  for dev in ("cuda", "cpu")}
    state_err = {f"{a}/{m}": max(max_err(states[a, m, "cuda"][k], states[a, m, "cpu"][k])
                                 for k in ("conv", "ssm"))
                 for a, m in keys if (a, m, "cpu") in states}
    st = {f"{a}/{m}": runs[a, m, "cuda"][4] for a, m in keys}
    out = {"phase": "reference", "docs": len(corpus.docs),
           "rows": len(runs["qwen2.5-3b", "off", "cpu"][0]),
           "identical": same, "same_rows_and_tokens_as_off": invariant,
           "moe_token_agreement_with_off": moe_tokens,
           "state_max_abs_err": state_err, "state_tol": STATE_TOL, "engine": st,
           "drafter": {a: runs[a, "draft", "cuda"][6] for a in models if "draft" in models[a]},
           "k6_launches": {f"{a}/{m}/{dev}": gating[a, m, dev] for a, m in keys
                           for dev in ("cuda", "cpu") if gating[a, m, dev]}}
    emit(out)
    if not all(same.values()) or not all(runs[a, "off", "cpu"][0] for a in models):
        raise AssertionError(f"the card's served query differs from the CPU reference: {same}")
    if not all(invariant.values()):
        raise AssertionError(f"rows or tokens differ from the plain mode: {invariant}")
    if not all(e <= STATE_TOL for e in state_err.values()):
        raise AssertionError(f"the card's recurrent state differs from the CPU's: {state_err}")
    for arch in models:
        if st[f"{arch}/spec"]["spec_rounds"] <= 0 or st[f"{arch}/spec"]["prefix_hits"] <= 0:
            raise AssertionError(f"{arch}: the reference spec run had no verify round "
                                 f"or no prefix hit")
        if st[f"{arch}/spec"]["draft_tokens"] <= 0:
            raise AssertionError(f"{arch}: prompt lookup drafted nothing in the reference")
        if st[f"{arch}/slab"]["prefix_hits"] <= 0:
            raise AssertionError(f"{arch}: the reference slab run had no prefix hit")
    rb = st["falcon-mamba-7b/rollback"]
    if not 0 < rb["accepted_tokens"] < rb["draft_tokens"]:
        raise AssertionError(f"falcon-mamba-7b: the scripted drafts did not roll back in "
                             f"part: {rb['accepted_tokens']} of {rb['draft_tokens']} accepted")
    for arch in ("qwen2.5-3b", "deepseek-v2-lite-16b"):
        draft = st[f"{arch}/draft"]
        if draft["spec_rounds"] <= 0 or draft["draft_tokens"] <= 0:
            raise AssertionError(f"{arch}: the reference draft run had no verify round or "
                                 f"no draft")
    moe = [m for a, m in keys if a == "deepseek-v2-lite-16b"]
    if not all(gating["deepseek-v2-lite-16b", m, "cuda"] > 0 for m in moe) or \
            any(n for (a, m, dev), n in gating.items()
                if dev == "cpu" or a != "deepseek-v2-lite-16b"):
        raise AssertionError(f"K6 did not gate every MoE run on the card alone: {gating}")
    return out


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="weights seed")
    ap.add_argument("--out", default=None, help="directory for the full report")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one extraction round of every path")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False      # fp32 comparisons in fp32
    torch.backends.cudnn.allow_tf32 = False

    report = {}
    try:
        smi = nvidia_smi()
        kind = torch.cuda.get_device_name(0)
        report["device"] = {"phase": "device", "name": kind, "nvidia_smi": smi,
                            "count": torch.cuda.device_count(),
                            "torch": torch.__version__, "cuda": torch.version.cuda}
        emit(report["device"])

        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        _build.library()
        ptxas = [ln.strip() for ln in _build.build_info.get("ptxas", "").splitlines()
                 if "registers" in ln or "spill" in ln]
        report["build"] = {"phase": "build", "seconds": time.perf_counter() - t0,
                           "nvcc_seconds": _build.build_info["seconds"],
                           "cached": _build.build_info["cached"], "ptxas": ptxas[:12]}
        emit(report["build"])

        captures: dict = {}
        seconds = {"build": report["build"]["seconds"]}
        clock = [time.perf_counter()]

        def lap(name):
            now = time.perf_counter()
            seconds[name] = now - clock[0]
            clock[0] = now
        report["main"], served, main_run = phase_main(args.seed, captures)
        lap("main")
        report["spec"], served_spec = phase_spec(main_run, captures)
        lap("spec")
        report["slab"], served_slab, slab_tokens = phase_slab(main_run)
        lap("slab")
        report["draft"], served_draft = phase_draft(main_run, captures, slab_tokens)
        lap("draft")
        if args.profile:
            for path, served_path in (("main", served), ("spec", served_spec),
                                      ("slab", served_slab), ("draft", served_draft)):
                key = "profile" if path == "main" else f"profile_{path}"
                report[key] = phase_profile(*served_path, args.out, path)
            lap("profile")
        main_result = main_run[1]
        # free the qwen2.5-3b weights and engines before falcon-mamba-7b's
        del main_run, served, served_spec, served_slab, served_draft
        torch.cuda.empty_cache()
        report["ssm"], served_ssm = phase_ssm(args.seed, captures, main_result)
        lap("ssm")
        if args.profile:
            report["profile_ssm"] = phase_profile(*served_ssm, args.out, "ssm")
            lap("profile_ssm")
        # free the falcon-mamba-7b weights before deepseek-v2-lite-16b's
        del served_ssm
        torch.cuda.empty_cache()
        report["moe"], served_moe = phase_moe(args.seed, captures, main_result)
        lap("moe")
        if args.profile:
            report["profile_moe"] = phase_profile(*served_moe, args.out, "moe")
            lap("profile_moe")
        del served_moe
        torch.cuda.empty_cache()
        launches = {**report["main"]["launches"], "K4": report["spec"]["launches"]["K4"],
                    "K5": report["draft"]["launches"]["K5"],
                    "K5_slab": report["slab"]["launches"]["K5"],
                    "K6": report["moe"]["launches"]["K6"],
                    "K7": report["ssm"]["launches"]["K7"]}
        report["kernels"] = phase_kernels(captures, launches)
        lap("kernels")
        report["reference"] = phase_reference(args.seed)
        lap("reference")
        seconds["total"] = time.perf_counter() - t_start
        report["seconds"] = {"phase": "seconds", **seconds}
        emit(report["seconds"])
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        if leaked:
            raise AssertionError(f"JAX or the JAX package was imported: {leaked[:5]}")
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        if args.out:
            Path(args.out).mkdir(parents=True, exist_ok=True)
            (Path(args.out) / "chip_smoke_report.json").write_text(
                json.dumps(report, indent=1, default=str))

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "tol",
            "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: r[k] for k in keys} for r in report["kernels"]]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
