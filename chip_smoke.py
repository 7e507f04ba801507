#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--out DIR] [--profile]

Runs from the root of a checkout, imports nothing of JAX or of the JAX
package, and goes through its phases, each printing one JSON line:

  device     the card's name and power limit (nvidia-smi);
  build      nvcc build of the port's CUDA kernels from the checkout's sources;
  main       one QUEST query on qwen2.5-3b at its published width (36
             layers, d_model 2048, bf16, random weights from --seed) through
             the entry points a user calls: Session.prepare(q).submit() ->
             TwoLevelRetriever over the legal corpus -> ServedExtractor ->
             paged ServingEngine; the kernel launch counts are set to 0
             just before the query and read just after;
  kernels    every kernel of that path (K1 paged decode attention, K2 paged
             chunk-prefill attention, K3 L2 top-k) on the inputs of one of
             its real launches from the main phase, plus edge cases, held
             against its plain PyTorch version; times with CUDA events
             beside its bound and a PyTorch library yardstick;
  profile    (only with --profile) torch.profiler over one extraction round
             of the main path: device busy share, device time by kernel;
  reference  the same served query code at a small size (SMOKE config,
             float32, 20 legal documents) on the card and on the CPU's plain
             path: rows, ledger token columns, engine counters and every
             generated token must be identical.

Then it prints the `kernels` summary line, the nvidia-smi line, and as its
last line {"ok": true, "device": {...}}. Any failure exits non-zero before
that line. It needs one CUDA device and exits non-zero without one, or
when the repository's `src/repro_torch` is not beside it.
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


def _served_query(cfg, params, corpus, device, max_new):
    from repro_torch import core
    from repro_torch.extract import ServedExtractor
    from repro_torch.index.retriever import TwoLevelRetriever
    from repro_torch.serving import ServingEngine
    t0 = time.perf_counter()
    retriever = TwoLevelRetriever(corpus, device=device)
    build_s = time.perf_counter() - t0
    engine = ServingEngine(cfg, params, slots=4, max_len=1024, page_size=16,
                           chunk_size=32, device=device)
    extractor = ServedExtractor(corpus, engine, max_new=max_new)
    session = core.Session(retriever, extractor, batch_size=4)
    return session, engine, extractor, build_s


def phase_main(seed: int, captures: dict) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import make_legal_corpus
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import topk_l2 as k3
    from repro_torch.models import init_params, param_count
    from repro_torch import core

    cfg = get_config("qwen2.5-3b")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    corpus = make_legal_corpus(seed=1)
    session, engine, extractor, build_s = _served_query(
        cfg, params, corpus, "cuda", max_new=12)

    captures["K1"] = Capture(k1, "paged_decode_attention",
                             lambda q, kp, vp, tbl, lens: tbl.shape[1] * q.shape[0])
    captures["K2"] = Capture(k2, "chunk_prefill_attention",
                             lambda q, kp, vp, ctx, start: start)
    captures["K3"] = Capture(k3, "topk_l2", lambda db, q, k: db.shape[0] * q.shape[0])
    k1.launches = k2.launches = k3.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = session.prepare(_legal_query(core)).submit().result()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": k1.launches, "K2": k2.launches, "K3": k3.launches}
    for c in captures.values():
        c.restore()

    gen_tokens = extractor.stats.generated_tokens
    led = result.ledger
    out = {"phase": "main", "model": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype, "params": param_count(params),
           "docs": len(corpus.docs), "rows": len(result.rows),
           "ledger": {"input_tokens": led.input_tokens, "output_tokens": led.output_tokens,
                      "llm_calls": led.llm_calls, "extractions": led.extractions,
                      "per_phase": led.per_phase},
           "engine": dict(engine.stats), "served_requests": extractor.stats.requests,
           "generated_tokens": gen_tokens, "weights_init_s": init_s,
           "index_build_s": build_s, "query_wall_s": wall,
           "generated_tokens_per_s": gen_tokens / wall,
           "launches": launches}
    emit(out)
    if not result.rows:
        raise AssertionError("the main-path query returned no rows")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    if not engine.stats["decode_steps"] or not engine.stats["prefill_chunks"]:
        raise AssertionError("the engine ran no decode step or no prefill chunk")
    return out, (session, extractor)


def phase_profile(session, extractor, out_dir) -> dict:
    """torch.profiler over one extraction round of the main path's served
    model (4 legal documents, attribute `year`): wall time, the device's
    busy share, and device time by kernel group."""
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
              "K3 topk_l2": "topk_l2_kernel"}
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
    out = {"phase": "profile", "requests": len(items), "wall_ms": wall_us / 1e3,
           "device_busy_ms": busy / 1e3, "device_busy_share": busy / wall_us,
           "device_kernels": launches,
           "device_ms_by_group": {g: t / 1e3 for g, t in by_group.items()}}
    emit(out)
    if out_dir:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        ev = prof.key_averages()
        key = "self_device_time_total" if ev and hasattr(ev[0], "self_device_time_total") \
            else "self_cuda_time_total"
        (Path(out_dir) / "profile_table.txt").write_text(ev.table(sort_by=key, row_limit=40))
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    return out


def phase_kernels(captures: dict, launches: dict) -> list:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import topk_l2 as k3

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

    for r in rows:
        r["kernel_ms"] = r["ms"]
        emit({"phase": "kernels", **r})
        for key in ("max_abs_err", "max_abs_err_float32", "max_abs_err_edge_float32"):
            tol = r["tol"] if key == "max_abs_err" else r.get("tol_float32", r["tol"])
            if key in r and not r[key] <= tol:
                raise AssertionError(f"{r['name']}: {key}={r[key]} > {tol}")
    return rows


def phase_reference(seed: int) -> dict:
    """The served path at a small size, card against the CPU's plain path."""
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
    runs = {}
    for device in ("cuda", "cpu"):
        params = _to(cpu_params, device)
        session, engine, _, _ = _served_query(cfg, params, corpus, device, max_new=6)
        res = session.prepare(_legal_query(core)).submit().result()
        runs[device] = (res.rows, res.ledger.input_tokens, res.ledger.output_tokens,
                        res.ledger.per_phase, dict(engine.stats),
                        {r: q.out for r, q in engine.finished.items()})
    same = runs["cuda"] == runs["cpu"]
    out = {"phase": "reference", "docs": len(corpus.docs), "rows": len(runs["cpu"][0]),
           "identical": same, "engine": runs["cuda"][4]}
    emit(out)
    if not same or not runs["cpu"][0]:
        raise AssertionError("the card's served query differs from the CPU reference")
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
        report["main"], served = phase_main(args.seed, captures)
        report["kernels"] = phase_kernels(captures, report["main"]["launches"])
        if args.profile:
            report["profile"] = phase_profile(*served, args.out)
        report["reference"] = phase_reference(args.seed)
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
