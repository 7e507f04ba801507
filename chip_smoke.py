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
  slab       the same query at all 36 layers on the slab KV layout
             (kv_layout="slab", prefix cache and speculation off): every
             prompt prefills whole, bucketed to chunk_size, through K2 over
             the slab seen as pages, and every decode step runs K5 on the
             slab (36 launches a step); rows and the ledger's token columns
             must equal the main phase's, K1 and K4 must stay at 0;
  draft      at all 36 layers, the spec phase's engine with draft-model
             speculation instead of prompt lookup: spec_decode="draft" with
             the target's own weights as the draft (self-drafting, the
             acceptance ceiling). The target prefills in chunks (K2) and
             verifies (K4); the drafter prefills each prompt bucketed (K2)
             and drafts with batched slab decode steps (K5). Acceptance,
             verify rounds and the drafter's steps are reported; rows and
             ledger token columns must equal the main phase's, K1 must
             stay at 0;
  kernels    every kernel of those paths (K1 paged decode attention, K2
             paged chunk-prefill attention, K3 L2 top-k, K4 paged verify
             attention, K5 dense-cache decode attention) on the inputs of
             one of its real launches, plus edge cases, held against its
             plain PyTorch version; times with CUDA events beside its bound
             and a PyTorch library yardstick;
  profile    (only with --profile) torch.profiler over one extraction round
             of each path (main, spec, slab, draft): device busy share,
             device time by kernel;
  reference  the same served query code at a small size (SMOKE config,
             float32, 20 legal documents) on the card and on the CPU's plain
             path, in four modes: speculation and the prefix cache off;
             prompt lookup with the prefix cache; the slab layout with the
             prefix cache (snapshot, expand and token-by-token suffix decode
             on the card); self-drafting. Rows, ledger token columns, engine
             (and drafter) counters and every generated token must be
             identical across the two devices, and rows and tokens
             identical to the first mode's in every mode.

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


def bound(nbytes: float, flops: float, dtype: str) -> tuple:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
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
# The main and spec phases run the first MAIN_LAYERS of the 36 layers at
# full width, so that the whole command, slab and draft at full depth
# included, stays well inside its time limit (the four paths at 36 layers
# took 1,128 s of the 1,200 s with --profile on one H100 80GB HBM3).
MAIN_LAYERS = 12


def _cut(cfg, params):
    """The published config and weights cut to their first MAIN_LAYERS."""
    return (cfg.replace(num_layers=MAIN_LAYERS),
            {**params, "layers": params["layers"][:MAIN_LAYERS]})


def _served_query(cfg, params, corpus, device, max_new, **engine_kw):
    from repro_torch import core
    from repro_torch.extract import ServedExtractor
    from repro_torch.index.retriever import TwoLevelRetriever
    from repro_torch.serving import ServingEngine
    t0 = time.perf_counter()
    retriever = TwoLevelRetriever(corpus, device=device)
    build_s = time.perf_counter() - t0
    engine = ServingEngine(cfg, params, slots=4, max_len=1024, page_size=16,
                           chunk_size=32, device=device, **engine_kw)
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
    from repro_torch.kernels import topk_l2 as k3
    from repro_torch.kernels import verify_attention as k4
    return {"K1": k15.launches, "K2": k2.launches, "K3": k3.launches,
            "K4": k4.launches, "K5": k15.dense_launches}


def _zero_launches():
    from repro_torch.kernels import decode_attention as k15
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import topk_l2 as k3
    from repro_torch.kernels import verify_attention as k4
    k15.launches = k15.dense_launches = k2.launches = k3.launches = k4.launches = 0


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

    params, main_result, _ = main_run
    cfg = get_config("qwen2.5-3b")
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

    params, main_result, main_engine = main_run
    cfg = get_config("qwen2.5-3b")
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


def phase_profile(session, extractor, out_dir, path: str) -> dict:
    """torch.profiler over one extraction round of a path's served model
    (4 legal documents, attribute `year`): wall time, the device's busy
    share, and device time by kernel group."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    retriever = session.retriever
    docs = sorted(retriever.corpus.docs)[:4]
    items = [(d, "year", retriever.segments(d, "year", "cases")) for d in docs]
    extractor.extract_batch(items)                 # warm-up round
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        extractor.extract_batch(items)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups = {"K1 paged_decode": "paged_decode_kernel",
              "K2 chunk_prefill": "chunk_prefill_kernel",
              "K3 topk_l2": "topk_l2_kernel",
              "K4 paged_verify": "paged_verify_",      # its span and merge kernels
              "K5 dense_decode": "dense_decode_"}      # its span and merge kernels
    by_group = dict.fromkeys(list(groups) + ["gemm", "other"], 0.0)
    launches = 0
    for e in prof.key_averages():
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
    busy = sum(by_group.values())
    out = {"phase": "profile", "path": path, "requests": len(items),
           "wall_ms": wall_us / 1e3,
           "device_busy_ms": busy / 1e3, "device_busy_share": busy / wall_us,
           "device_kernels": launches,
           "device_ms_by_group": {g: t / 1e3 for g, t in by_group.items()}}
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

    for r in rows:
        r["kernel_ms"] = r["ms"]
        emit({"phase": "kernels", **r})
        for key in ("max_abs_err", "max_abs_err_float32", "max_abs_err_edge_float32"):
            tol = r["tol"] if key == "max_abs_err" else r.get("tol_float32", r["tol"])
            if key in r and not r[key] <= tol:
                raise AssertionError(f"{r['name']}: {key}={r[key]} > {tol}")
    return rows


def phase_reference(seed: int) -> dict:
    """The served path at a small size, card against the CPU's plain path,
    in four modes: off, prompt lookup with the prefix cache, the slab layout
    with the prefix cache, and self-drafting."""
    import torch
    from repro_torch import core
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import lm_data
    from repro_torch.data.corpus import make_legal_corpus
    from repro_torch.models import init_params

    cfg = get_smoke_config("qwen2.5-3b").replace(vocab_size=lm_data.VOCAB)
    cpu_params = init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    full = make_legal_corpus(seed=1)
    corpus = full.subset(sorted(full.docs)[:20])
    modes = {"off": {}, "spec": SPEC, "slab": {**SLAB, "prefix_cache": True},
             "draft": {"spec_decode": "draft", "spec_k": 4}}
    runs = {}
    for mode, engine_kw in modes.items():
        for device in ("cuda", "cpu"):
            params = _to(cpu_params, device)
            if mode == "draft":
                engine_kw = {**engine_kw, "draft_model": (cfg, params)}
            session, engine, _, _ = _served_query(cfg, params, corpus, device, max_new=6,
                                                  **engine_kw)
            res = session.prepare(_legal_query(core)).submit().result()
            runs[mode, device] = (res.rows, res.ledger.input_tokens,
                                  res.ledger.output_tokens, res.ledger.per_phase,
                                  dict(engine.stats),
                                  {r: q.out for r, q in engine.finished.items()},
                                  dict(getattr(engine.drafter, "stats", {})))
    same = {mode: runs[mode, "cuda"] == runs[mode, "cpu"] for mode in modes}
    invariant = {f"{mode}/{dev}": (runs["off", dev][0], runs["off", dev][5]) ==
                 (runs[mode, dev][0], runs[mode, dev][5])
                 for mode in modes if mode != "off" for dev in ("cuda", "cpu")}
    st = {mode: runs[mode, "cuda"][4] for mode in modes}
    out = {"phase": "reference", "docs": len(corpus.docs), "rows": len(runs["off", "cpu"][0]),
           "identical": same, "same_rows_and_tokens_as_off": invariant,
           "engine": st["off"], "engine_spec": st["spec"], "engine_slab": st["slab"],
           "engine_draft": st["draft"], "drafter": runs["draft", "cuda"][6]}
    emit(out)
    if not all(same.values()) or not runs["off", "cpu"][0]:
        raise AssertionError(f"the card's served query differs from the CPU reference: {same}")
    if not all(invariant.values()):
        raise AssertionError(f"rows or tokens differ from the plain mode: {invariant}")
    if st["spec"]["spec_rounds"] <= 0 or st["spec"]["prefix_hits"] <= 0:
        raise AssertionError("the reference spec run had no verify round or no prefix hit")
    if st["slab"]["prefix_hits"] <= 0:
        raise AssertionError("the reference slab run had no prefix hit")
    if st["draft"]["spec_rounds"] <= 0 or st["draft"]["draft_tokens"] <= 0:
        raise AssertionError("the reference draft run had no verify round or no draft")
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
                    help="also profile one extraction round of the main path")
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
        del main_run
        launches = {**report["main"]["launches"], "K4": report["spec"]["launches"]["K4"],
                    "K5": report["draft"]["launches"]["K5"],
                    "K5_slab": report["slab"]["launches"]["K5"]}
        report["kernels"] = phase_kernels(captures, launches)
        lap("kernels")
        if args.profile:
            for path, served_path in (("main", served), ("spec", served_spec),
                                      ("slab", served_slab), ("draft", served_draft)):
                key = "profile" if path == "main" else f"profile_{path}"
                report[key] = phase_profile(*served_path, args.out, path)
            lap("profile")
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
