#!/usr/bin/env python3
"""One kernel (K3, K6, K7 or K2nc) of two checkouts on one card: device
times in turns and the outputs compared, bit for bit (K3, K6, K7) or
within a tolerance (K2nc).

    python3 tools/kernel_ab.py --kernel K3|K6|K7|K2nc --baseline DIR [--seed N] [--out FILE]

DIR is another checkout of this repository (for example the parent
commit, unpacked with `git archive` into a git-ignored directory). Each
side runs in its own process (its own `src/repro_torch`, its own kernel
build), in the order baseline, change, change, baseline, on the same
inputs made from --seed on the card. Prints one JSON line a run and a
summary line; exits non-zero when a side's outputs differ from the other's
(in any bit; for K2nc by more than chip_smoke.TOL["bfloat16"] in the
allclose form, `close_err`), or without a CUDA device. Device times are
`chip_smoke.device_ms` (a CUDA graph of 20 calls replayed under events).

K3 (L2 top-k): the retriever's launch (db 309 x 256 of unit rows, 4
queries, k = N), N 256, 2,048 (the largest cluster), 2,049 and 16,384
(the two-kernel shape), D 32 and 64, M 1 and 8, k < N, and duplicated
rows; outputs: distances and indices.

K6 (MoE gating): chip_smoke.py's ten cases (deepseek-v2-lite-16b's chunk
and verify launches, T = 1, E 8 / 4 / 160 / 256, equal logits, bf16-
rounded logits, T = 37) and the chunk in bf16, each with the capacity
`moe_capacity` gives; outputs: weights, indices, slots and kept weights.
A side whose `moe_gating` takes no capacity (before the fused numbering)
gates the logits in float32 (the cast `moe_apply` made) and numbers them
with `moe_apply`'s plain ops, so the slots are held against the plain
numbering. Timed: what `moe_apply` runs for gating and numbering (`route`),
and the gating alone (`gate`), at the chunk and verify launches.

K7 (selective scan): falcon-mamba-7b's launches (di 8192, N 16: a
128-token prefill chunk from a carried state, and a verify round, B 4 x
S 5, writing its states) in bf16 and float32, at the unit scale of the
JAX package's K7 test, plus edge shapes (N 32, B 8, a ragged di 200, an
unaligned di 100, S 0); outputs: y, the final state and the states.

K2nc (K2's non-causal form, `flash_attention.bidirectional_attention`, bf16):
whisper-medium's three launch shapes, the encoder (1,500 frames over
1,500, 16 heads over 16, D 64), a chunk's cross-attention (128 queries
over the 1,500 cross keys) and a verify round's (4 rows x 5 candidates),
on seeded unit-scale inputs; output: the attention. A side routes each
launch as its own wrapper does (a tree without `bidirectional_route` runs
every launch on the paged-attention core). The comparison is not bitwise:
the Hopper kernel rounds the unnormalised probabilities to bf16 where the
core keeps them as two bf16 halves, which changes low bits by design; the
sides must agree within TOL["bfloat16"] in the allclose form. A side with
the Hopper kernel also times, over the 1,500 cross keys, both kernels at Sq
128 to 1,024 query rows a head, 16 query heads over 16 and over 4 KV heads
(`sweep`), the numbers behind `flash_attention.SM90_MIN_ROWS`, and the
encoder's launch at n_keys 128 to 1,500 (`keys_sweep`: a launch's fixed
cost and the cost of each 128-key tile).
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
# K3: (name, N, D, M, k or None for N, duplicated rows, timed)
K3_CASES = (("retriever", 309, 256, 4, None, False, True),
            ("N256", 256, 256, 4, None, False, False),
            ("N2048", 2048, 256, 4, None, False, True),
            ("N2049", 2049, 64, 2, None, False, True),
            ("N16384", 16384, 32, 1, None, False, True),
            ("D32_M8", 309, 32, 8, None, False, False),
            ("D64_M1", 309, 64, 1, None, False, False),
            ("k10", 309, 256, 4, 10, False, False),
            ("duplicated", 300, 256, 3, None, True, False))
# K6: (name, T, E, k, logits scale, input) with input "f32", "bf16" (the
# model dtype) or "bf16-rounded" (float32 holding bf16 values); "equal" = 0.37
K6_CASES = (("chunk", 128, 64, 6, 0.9, "bf16-rounded"),
            ("verify", 20, 64, 6, 0.9, "bf16-rounded"),
            ("T1", 1, 64, 6, 1.0, "f32"),
            ("E8_k2", 100, 8, 2, 2.0, "f32"),
            ("E4_k2", 17, 4, 2, 2.0, "f32"),
            ("E160", 64, 160, 6, 1.0, "f32"),
            ("E256_k8", 40, 256, 8, 1.0, "f32"),
            ("all_equal", 9, 64, 6, None, "f32"),
            ("bf16_rounded", 512, 64, 6, 0.9, "bf16-rounded"),
            ("T37", 37, 64, 6, 1.0, "f32"),
            ("chunk_bf16", 128, 64, 6, 0.9, "bf16"))
K6_TIMED = ("chunk_bf16", "verify")
# K7: (name, B, S, di, N, dtype, h0, states, timed)
K7_CASES = (("chunk", 1, 128, 8192, 16, "bfloat16", True, False, True),
            ("verify", 4, 5, 8192, 16, "bfloat16", True, True, True),
            ("chunk_f32", 1, 128, 8192, 16, "float32", True, False, False),
            ("verify_f32", 4, 5, 8192, 16, "float32", True, True, False),
            ("N32", 1, 64, 8192, 32, "bfloat16", False, True, False),
            ("B8", 8, 5, 8192, 16, "bfloat16", True, True, False),
            ("ragged_di200", 2, 37, 200, 16, "float32", True, True, False),
            ("unaligned_di100", 2, 19, 100, 8, "bfloat16", False, True, False),
            ("S0", 2, 0, 8192, 16, "bfloat16", True, True, False))
# K2nc: (name, B, Sq, Skv, H, Hkv, n_keys), bf16, D 64
K2NC_CASES = (("encoder", 1, 1500, 1500, 16, 16, 1500),
              ("cross_chunk", 1, 128, 1500, 16, 16, 1500),
              ("cross_verify", 4, 5, 1500, 16, 16, 1500))
K2NC_SWEEP = (128, 160, 192, 224, 256, 384, 512, 858, 1024)
K2NC_SWEEP_GROUPS = (1, 4)      # query heads a KV head: whisper's 16 over 16, and 16 over 4
K2NC_KEYS_SWEEP = (128, 256, 512, 1024, 1500)
CASES = {"K3": K3_CASES, "K6": K6_CASES, "K7": K7_CASES, "K2nc": K2NC_CASES}


def _gen(torch, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale
    return r


def _k3_inputs(torch, seed, N, D, M, k, duplicated):
    r = _gen(torch, seed)
    db = r(N, D)
    db = db / db.norm(dim=1, keepdim=True)           # unit rows, as the embedder's
    if duplicated:
        db = torch.cat([db[:100], db[:100], db[50:150]])
    q = r(M, D)
    q = q / q.norm(dim=1, keepdim=True)
    if duplicated:
        q[-1] = db[10]
    return db, q, k or db.shape[0]


def _k6_inputs(torch, seed, T, E, k, scale, kind):
    logits = (torch.full((T, E), 0.37, device="cuda") if scale is None
              else _gen(torch, seed)(T, E, scale=scale))
    if kind != "f32":
        logits = logits.bfloat16()
    if kind == "bf16-rounded":
        logits = logits.float()
    from repro_torch.models.layers import moe_capacity       # the side's own
    cfg = SimpleNamespace(capacity_factor=1.25, moe_top_k=k, n_experts=E)
    return logits, k, moe_capacity(cfg, T)


def _k7_inputs(torch, seed, B, S, di, N, dtype, h0, states):
    r = _gen(torch, seed)
    dt_ = getattr(torch, dtype)
    x = r(B, S, di, scale=0.5).to(dt_)
    dt = torch.nn.functional.softplus(r(B, S, di) - 1.0).to(dt_)
    A = -torch.exp(r(di, N, scale=0.3))
    Bm, Cm = r(B, S, N, scale=0.5).to(dt_), r(B, S, N, scale=0.5).to(dt_)
    D = torch.ones(di, device="cuda").to(dt_)
    return (x, dt, A, Bm, Cm, D, r(B, di, N) if h0 else None,
            torch.empty((B, S, di, N), device="cuda") if states else None)


def _k2nc_inputs(torch, seed, B, Sq, Skv, H, Hkv):
    r = _gen(torch, seed)
    return tuple(r(*shape).bfloat16() for shape in ((B, Sq, H, 64), (B, Skv, Hkv, 64),
                                                     (B, Skv, Hkv, 64)))


def _k6_route(torch, k6):
    """What `moe_apply` runs for the gating and the numbering on this side:
    the fused launch, or (before it) the float32 cast, the gating launch
    and the numbering in plain PyTorch."""
    if "capacity" in inspect.signature(k6.moe_gating).parameters:
        return lambda logits, k, cap: k6.moe_gating(logits, k, cap)
    F = torch.nn.functional

    def route(logits, k, cap):
        w, i = k6.moe_gating(logits.float(), k)
        flat_e = i.reshape(-1).long()
        pos = (F.one_hot(flat_e, logits.shape[1]).cumsum(0) - 1).gather(1, flat_e[:, None])[:, 0]
        keep = pos < cap
        return w, i, torch.where(keep, flat_e * cap + pos, logits.shape[1] * cap), \
            w.reshape(-1) * keep
    return route


def side(src: str, kernel: str, seed: int, out: str) -> None:
    """One side's run: outputs of every case to `out`, times on stdout."""
    sys.path.insert(0, src)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from repro_torch.kernels import _build
    times, results, extra = {}, {}, {}
    if kernel == "K3":
        from repro_torch.kernels import topk_l2 as k3
        for i, (name, N, D, M, k, dup, timed) in enumerate(K3_CASES):
            args = _k3_inputs(torch, seed + i, N, D, M, k, dup)
            results[name] = [t.cpu() for t in k3.topk_l2(*args)]
            if timed:
                times[name] = chip_smoke.device_ms(lambda: k3.topk_l2(*args))
    elif kernel == "K6":
        from repro_torch.kernels import moe_gating as k6
        route = _k6_route(torch, k6)
        for i, (name, T, E, k, scale, kind) in enumerate(K6_CASES):
            args = _k6_inputs(torch, seed + i, T, E, k, scale, kind)
            results[name] = [t.cpu() for t in route(*args)]
            if name in K6_TIMED:
                times[f"{name}_route"] = chip_smoke.device_ms(lambda: route(*args))
                f32 = args[0].float()
                times[f"{name}_gate"] = chip_smoke.device_ms(lambda: k6.moe_gating(f32, args[1]))
    elif kernel == "K2nc":
        from repro_torch.kernels import flash_attention as k2
        for i, (name, B, Sq, Skv, H, Hkv, n) in enumerate(K2NC_CASES):
            q, k, v = _k2nc_inputs(torch, seed + i, B, Sq, Skv, H, Hkv)
            results[name] = [k2.bidirectional_attention(q, k, v, n).cpu()]
            times[name] = chip_smoke.device_ms(lambda: k2.bidirectional_attention(q, k, v, n))
        if hasattr(k2, "bidirectional_route"):
            extra["route"] = {name: k2.bidirectional_route(torch.bfloat16, B, Sq, H, Hkv, 64)
                              for name, B, Sq, Skv, H, Hkv, n in K2NC_CASES}
            extra["sweep"] = {}
            for G in K2NC_SWEEP_GROUPS:
                for Sq in K2NC_SWEEP:
                    q, k, v = _k2nc_inputs(torch, seed + Sq, 1, Sq, 1500, 16, 16 // G)
                    dst = torch.empty_like(q)
                    extra["sweep"][f"G{G} Sq{Sq}"] = {
                        "core": chip_smoke.device_ms(lambda: k2._launch_core(q, k, v, dst, 1500)),
                        "sm90": chip_smoke.device_ms(lambda: k2._launch_sm90(q, k, v, dst, 1500)),
                        "route": k2.bidirectional_route(torch.bfloat16, 1, Sq, 16, 16 // G, 64)}
            q, k, v = _k2nc_inputs(torch, seed, 1, 1500, 1500, 16, 16)
            extra["keys_sweep"] = {n: chip_smoke.device_ms(
                lambda: k2.bidirectional_attention(q, k, v, n)) for n in K2NC_KEYS_SWEEP}
            extra["ptxas"] = chip_smoke.sm90_ptxas(_build.build_info["ptxas"])
    else:
        from repro_torch.kernels import ssm_scan as k7
        for i, (name, B, S, di, N, dtype, h0, states, timed) in enumerate(K7_CASES):
            args = _k7_inputs(torch, seed + i, B, S, di, N, dtype, h0, states)
            y, h = k7.ssm_scan(*args)
            results[name] = [t.cpu() for t in (y, h, args[7]) if t is not None]
            if timed:
                times[name] = chip_smoke.device_ms(lambda: k7.ssm_scan(*args))
        extra["ptxas"] = chip_smoke.scan_ptxas(_build.build_info["ptxas"])
    torch.cuda.synchronize()
    torch.save(results, out)
    print(json.dumps({"src": src, "device_ms": times, **extra}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(CASES), default="K7")
    ap.add_argument("--baseline", help="root of the other checkout")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="file for the summary JSON")
    ap.add_argument("--side", nargs=2, metavar=("SRC", "OUT"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.side:
        side(args.side[0], args.kernel, args.seed, args.side[1])
        return 0
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    if not torch.cuda.is_available() or not args.baseline:
        print("kernel_ab: needs a CUDA device and --baseline", file=sys.stderr)
        return 2
    roots = {"baseline": Path(args.baseline).resolve(), "change": ROOT}
    runs, outputs = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate(("baseline", "change", "change", "baseline")):
            out = str(Path(tmp) / f"{i}.pt")
            proc = subprocess.run([sys.executable, __file__, "--kernel", args.kernel,
                                   "--seed", str(args.seed), "--side",
                                   str(roots[name] / "src"), out],
                                  capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return 1
            run = {"run": i + 1, "side": name, **json.loads(proc.stdout.splitlines()[-1])}
            print(json.dumps(run), flush=True)
            runs.append(run)
            outputs.setdefault(name, torch.load(out))
    if args.kernel == "K2nc":   # not bitwise: the P rounding differs by design
        def same(a, b):
            return a.shape == b.shape and chip_smoke.close_err(a, b) <= chip_smoke.TOL["bfloat16"]
    else:
        same = torch.equal
    differ = [c for c in outputs["baseline"]
              if len(outputs["baseline"][c]) != len(outputs["change"][c])
              or not all(same(a, b) for a, b in zip(outputs["baseline"][c],
                                                    outputs["change"][c]))]
    agree = "within_tol_bf16" if args.kernel == "K2nc" else "identical"
    summary = {"kernel": args.kernel, agree: not differ, "differ": differ,
               "cases": [c[0] for c in CASES[args.kernel]],
               "device_ms": {name: [r["device_ms"] for r in runs if r["side"] == name]
                             for name in roots},
               "device": torch.cuda.get_device_name(0), "nvidia_smi": chip_smoke.nvidia_smi()}
    if args.kernel == "K2nc":
        summary["max_close_err"] = {
            c: max(chip_smoke.close_err(a, b) for a, b in zip(outputs["baseline"][c],
                                                              outputs["change"][c]))
            for c in outputs["baseline"]}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"runs": runs, **summary}, indent=1))
    return 0 if not differ else 1


if __name__ == "__main__":
    sys.exit(main())
