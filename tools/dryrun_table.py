#!/usr/bin/env python3
"""Print the dry run's records (`python -m repro_torch.launch.dryrun`) as one
markdown table: a row per architecture, a column per shape and mesh
(single, multi), each cell rank 0's "argument + temp GB / flops /
collective GB" ("*" where argument + temp passes one H100's 80 GB), or
"skip" where JAX's `applicable` skips the cell.

    python3 tools/dryrun_table.py single.json multi.json
"""
import json
import sys

HBM = 80e9          # one H100's device memory, bytes


def _cell(rec) -> str:
    if rec is None:
        return ""
    if rec["status"] != "ok":
        return "skip" if rec["status"] == "skipped" else rec["status"]
    mem = rec["memory"]
    arg, temp = mem["argument_size_in_bytes"], mem["temp_size_in_bytes"]
    star = "*" if arg + temp > HBM else ""
    return (f"{arg / 1e9:.2f}+{temp / 1e9:.2f}{star} / {rec['cost']['flops']:.2e} / "
            f"{rec['collectives']['_total'] / 1e9:.2f}")


def main(paths) -> None:
    rows, cols = {}, []
    for path in paths:
        for rec in json.load(open(path)).values():
            col = (rec["shape"], rec["mesh"])
            if col not in cols:
                cols.append(col)
            rows.setdefault(rec["arch"], {})[col] = rec
    cols.sort(key=lambda c: (["train_4k", "prefill_32k", "decode_32k", "long_500k"]
                             .index(c[0]), c[1] != "single"))
    print("| arch | " + " | ".join(f"{s} {m}" for s, m in cols) + " |")
    print("|---|" + "---|" * len(cols))
    for arch, recs in rows.items():
        print(f"| {arch} | " + " | ".join(_cell(recs.get(c)) for c in cols) + " |")


if __name__ == "__main__":
    main(sys.argv[1:])
