#!/usr/bin/env python3
"""K7 (the selective scan) of two checkouts on one card: device times in
turns and the outputs compared bit for bit.

    python3 tools/ssm_scan_ab.py --baseline DIR [--seed N] [--out FILE]

DIR is another checkout of this repository (for example the parent
commit, unpacked with `git archive` into a git-ignored directory). Each
side runs in its own process (its own `src/repro_torch`, its own kernel
build), in the order baseline, change, change, baseline, on the same
inputs made from --seed on the card: falcon-mamba-7b's launches (di 8192,
N 16: a 128-token prefill chunk from a carried state, and a verify round,
B 4 x S 5, writing its states) in bf16 and float32, at the unit scale of
the JAX package's K7 test, plus edge shapes (N 32, B 8, a ragged di 200,
an unaligned di 100, S 0). Prints one JSON line a run and a summary line;
exits non-zero when a side's y, final state or states differ from the
other's in any bit, or without a CUDA device. Device times are
`chip_smoke.device_ms` (a CUDA graph of 20 calls replayed under events).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (name, B, S, di, N, dtype, h0, states, timed)
CASES = (("chunk", 1, 128, 8192, 16, "bfloat16", True, False, True),
         ("verify", 4, 5, 8192, 16, "bfloat16", True, True, True),
         ("chunk_f32", 1, 128, 8192, 16, "float32", True, False, False),
         ("verify_f32", 4, 5, 8192, 16, "float32", True, True, False),
         ("N32", 1, 64, 8192, 32, "bfloat16", False, True, False),
         ("B8", 8, 5, 8192, 16, "bfloat16", True, True, False),
         ("ragged_di200", 2, 37, 200, 16, "float32", True, True, False),
         ("unaligned_di100", 2, 19, 100, 8, "bfloat16", False, True, False),
         ("S0", 2, 0, 8192, 16, "bfloat16", True, True, False))


def _inputs(torch, seed, B, S, di, N, dtype, h0, states):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale
    dt_ = getattr(torch, dtype)
    x = r(B, S, di, scale=0.5).to(dt_)
    dt = torch.nn.functional.softplus(r(B, S, di) - 1.0).to(dt_)
    A = -torch.exp(r(di, N, scale=0.3))
    Bm, Cm = r(B, S, N, scale=0.5).to(dt_), r(B, S, N, scale=0.5).to(dt_)
    D = torch.ones(di, device="cuda").to(dt_)
    return (x, dt, A, Bm, Cm, D, r(B, di, N) if h0 else None,
            torch.empty((B, S, di, N), device="cuda") if states else None)


def side(src: str, seed: int, out: str) -> None:
    """One side's run: outputs of every case to `out`, times on stdout."""
    sys.path.insert(0, src)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from repro_torch.kernels import ssm_scan as k7
    times = {}
    results = {}
    for i, (name, B, S, di, N, dtype, h0, states, timed) in enumerate(CASES):
        args = _inputs(torch, seed + i, B, S, di, N, dtype, h0, states)
        y, h = k7.ssm_scan(*args)
        torch.cuda.synchronize()
        results[name] = [t.cpu() for t in (y, h, args[7]) if t is not None]
        if timed:
            times[name] = chip_smoke.device_ms(lambda: k7.ssm_scan(*args))
    torch.save(results, out)
    from repro_torch.kernels import _build
    print(json.dumps({"src": src, "device_ms": times,
                      "ptxas": chip_smoke.scan_ptxas(_build.build_info["ptxas"])}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", help="root of the other checkout")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="file for the summary JSON")
    ap.add_argument("--side", nargs=2, metavar=("SRC", "OUT"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.side:
        side(args.side[0], args.seed, args.side[1])
        return 0
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    if not torch.cuda.is_available() or not args.baseline:
        print("ssm_scan_ab: needs a CUDA device and --baseline", file=sys.stderr)
        return 2
    roots = {"baseline": Path(args.baseline).resolve(), "change": ROOT}
    runs, outputs = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate(("baseline", "change", "change", "baseline")):
            out = str(Path(tmp) / f"{i}.pt")
            proc = subprocess.run([sys.executable, __file__, "--seed", str(args.seed), "--side",
                                   str(roots[name] / "src"), out],
                                  capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return 1
            run = {"run": i + 1, "side": name, **json.loads(proc.stdout.splitlines()[-1])}
            print(json.dumps(run), flush=True)
            runs.append(run)
            outputs.setdefault(name, torch.load(out))
    differ = [c for c in outputs["baseline"]
              if len(outputs["baseline"][c]) != len(outputs["change"][c])
              or not all(torch.equal(a, b) for a, b in zip(outputs["baseline"][c],
                                                             outputs["change"][c]))]
    summary = {"identical": not differ, "differ": differ, "cases": [c[0] for c in CASES],
               "device_ms": {name: [r["device_ms"] for r in runs if r["side"] == name]
                             for name in roots},
               "device": torch.cuda.get_device_name(0), "nvidia_smi": chip_smoke.nvidia_smi()}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"runs": runs, **summary}, indent=1))
    return 0 if not differ else 1


if __name__ == "__main__":
    sys.exit(main())
