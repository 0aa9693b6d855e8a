"""Comparison-table generator (reference scripts/tables/generate_tables.jl).

Joins two suite-result JSON files (from benchmarks/run_suite.py --out),
keeps instances solved (status == 1) in BOTH runs, and emits a markdown or
LaTeX longtable with per-instance time ratios
(reference generate_tables.jl:55-72).

Usage:
    python benchmarks/make_tables.py host.json gpu.json --labels host gpu
    python benchmarks/make_tables.py a.json b.json --format latex -o t.tex
"""

from __future__ import annotations

import argparse
import json


def load(path):
    with open(path) as f:
        data = json.load(f)
    return {r["name"]: r for r in data}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("run_a")
    ap.add_argument("run_b")
    ap.add_argument("--labels", nargs=2, default=["a", "b"])
    ap.add_argument("--format", choices=["markdown", "latex"], default="markdown")
    ap.add_argument("--metric", default="total_time",
                    choices=["total_time", "linear_solver_time",
                             "warm_time"],
                    help="warm_time = in-process warm re-solve wall "
                         "(run_suite --repeat N); falls back to "
                         "total_time when a record lacks it")
    ap.add_argument("--matched-only", action="store_true",
                    help="keep instances where both runs took the same "
                         "iteration count (BASELINE: wall-clock parity at "
                         "MATCHED iteration counts)")
    ap.add_argument("-o", "--out", default="")
    args = ap.parse_args()

    a = load(args.run_a)
    b = load(args.run_b)
    la, lb = args.labels
    met = args.metric

    def get(r):
        v = r.get(met)
        if v is None or (isinstance(v, float) and v < 0):
            v = r.get("total_time")
        return v

    # both-solved instances only (reference generate_tables.jl:66-68)
    names = sorted(
        nm for nm in a.keys() & b.keys()
        if a[nm].get("status") == 1 and b[nm].get("status") == 1
    )
    if args.matched_only:
        names = [nm for nm in names if a[nm]["iter"] == b[nm]["iter"]]

    rows = []
    for nm in names:
        ra, rb = a[nm], b[nm]
        va, vb = get(ra), get(rb)
        ratio = va / vb if vb and vb > 0 else float("nan")
        rows.append(
            (nm, ra["nvar"], ra["ncon"], ra["iter"], rb["iter"],
             va, vb, ratio)
        )

    header = (
        ["instance", "nvar", "ncon", f"iter({la})", f"iter({lb})",
         f"{met}({la})", f"{met}({lb})", f"ratio {la}/{lb}"]
    )
    lines = []
    if args.format == "markdown":
        lines.append("| " + " | ".join(header) + " |")
        lines.append("|" + "---|" * len(header))
        for r in rows:
            lines.append(
                f"| {r[0]} | {r[1]} | {r[2]} | {r[3]} | {r[4]} "
                f"| {r[5]:.3f} | {r[6]:.3f} | {r[7]:.2f} |"
            )
    else:
        lines.append(r"\begin{longtable}{l" + "r" * (len(header) - 1) + "}")
        lines.append(" & ".join(header) + r" \\ \hline")
        for r in rows:
            lines.append(
                f"{r[0]} & {r[1]} & {r[2]} & {r[3]} & {r[4]} & "
                f"{r[5]:.3f} & {r[6]:.3f} & {r[7]:.2f} " + r"\\"
            )
        lines.append(r"\end{longtable}")

    if rows:
        import math

        ratios = [r[7] for r in rows if math.isfinite(r[7]) and r[7] > 0]
        if ratios:
            gmean = math.exp(sum(math.log(x) for x in ratios) / len(ratios))
            lines.append("")
            lines.append(
                f"{len(rows)} instances solved by both; "
                f"geometric-mean {met} ratio {la}/{lb}: {gmean:.2f}"
            )

    text = "\n".join(lines)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    else:
        print(text)


if __name__ == "__main__":
    main()
