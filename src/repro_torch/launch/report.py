"""Render the dry run's tables (the JAX package's ``launch/report.py``,
ported) from ``results/dryrun_torch.json``: the roofline table of one
mesh, the cells with their trace time, peak and collectives, and the
summary, whose memory budget is the H100's own.

Run:  python -m repro_torch.launch.report --table roofline
"""

from __future__ import annotations

import argparse
import json
import os

# The card's memory (torch.cuda.get_device_properties(0).total_memory of
# the H100 80GB HBM3), the budget of the per-device peak estimate.
HBM_BYTES = 85.02e9


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}us"


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def roofline_table(results: dict, mesh: str = "16x16") -> list[str]:
    rows = []
    header = ("| arch | shape | t_compute | t_memory | t_collective | "
              "dominant | MODEL/HLO flops | roofline frac | peak mem/dev |")
    rows.append(header)
    rows.append("|" + "---|" * 9)
    for key in sorted(results):
        rec = results[key]
        if rec.get("mesh") != mesh or not rec.get("ok"):
            continue
        r = rec["roofline"]
        mem = rec["memory"]["peak_estimate_bytes"] / 2**30
        rows.append(
            f"| {rec['arch']} | {rec['shape']} | {fmt_s(r['t_compute_s'])} "
            f"| {fmt_s(r['t_memory_s'])} | {fmt_s(r['t_collective_s'])} "
            f"| {r['dominant']} | {r['useful_flops_ratio']:.2f} "
            f"| {r['roofline_fraction']:.3f} | {mem:.2f} GiB |")
    return rows


def dryrun_table(results: dict) -> list[str]:
    rows = ["| cell | mesh | ok | trace | peak mem/dev | collectives |",
            "|" + "---|" * 6]
    for key in sorted(results):
        rec = results[key]
        ok = "yes" if rec.get("ok") else f"NO: {rec.get('error', '?')[:60]}"
        if rec.get("ok"):
            mem = f"{rec['memory']['peak_estimate_bytes'] / 2**30:.2f} GiB"
            cc = rec["analysis"]["collective_counts"]
            coll = ", ".join(f"{k}x{int(v)}" for k, v in sorted(cc.items()))
            comp = f"{rec['trace_s']}s"
        else:
            mem = coll = comp = "-"
        rows.append(f"| {rec['arch']}/{rec['shape']} | {rec['mesh']} | {ok} "
                    f"| {comp} | {mem} | {coll[:90]} |")
    return rows


def summary(results: dict) -> list[str]:
    ok = [r for r in results.values() if r.get("ok")]
    single = [r for r in ok if r["mesh"] == "16x16"]
    rows = [
        f"- cells compiled OK: {len(ok)}/{len(results)} "
        f"({len(single)} single-pod, {len(ok) - len(single)} multi-pod)",
        f"- max per-device memory: "
        f"{max(r['memory']['peak_estimate_bytes'] for r in ok) / 2**30:.2f} GiB "
        f"(the H100's {HBM_BYTES / 1e9:.2f} GB)",
    ]
    doms = {}
    for r in single:
        doms.setdefault(r["roofline"]["dominant"], []).append(
            f"{r['arch']}/{r['shape']}")
    for d, cells in sorted(doms.items()):
        rows.append(f"- {d}-bound cells: {len(cells)}")
    worst = sorted(single, key=lambda r: r["roofline"]["roofline_fraction"])
    rows.append("- worst roofline fractions: " + ", ".join(
        f"{r['arch']}/{r['shape']}={r['roofline']['roofline_fraction']:.3f}"
        for r in worst[:3]))
    colly = sorted(single, key=lambda r: -r["roofline"]["t_collective_s"])
    rows.append("- most collective-bound: " + ", ".join(
        f"{r['arch']}/{r['shape']}={fmt_s(r['roofline']['t_collective_s'])}"
        for r in colly[:3]))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=os.path.join(
        os.path.dirname(__file__), "..", "..", "..", "results",
        "dryrun_torch.json"))
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--table", choices=["roofline", "dryrun", "summary"],
                    default="summary")
    args = ap.parse_args()
    results = load(os.path.abspath(args.results))
    if args.table == "roofline":
        print("\n".join(roofline_table(results, args.mesh)))
    elif args.table == "dryrun":
        print("\n".join(dryrun_table(results)))
    else:
        print("\n".join(summary(results)))


if __name__ == "__main__":
    main()
