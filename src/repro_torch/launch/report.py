"""Aggregate the dry run's records (``build/dryrun/*.json``) into the
roofline table (single-pod baselines) and the dry-run pass matrix (port
of ``repro/launch/report.py``; the same tables, the compute lever naming
the H100's tensor cores).

  PYTHONPATH=src python -m repro_torch.launch.report [--dir build/dryrun]
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def _fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-6:
        return f"{x*1e9:.1f}ns"
    if x < 1e-3:
        return f"{x*1e6:.1f}us"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def _fmt_b(x: float) -> str:
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x/div:.1f}{unit}"
    return f"{x:.0f}B"


LEVERS = {
    "collective": "cut collective volume (reshard/overlap/compress)",
    "memory": "cut HBM traffic (remat policy, fusion, dtype)",
    "compute": "at roofline for tensor cores; raise MFU via tiling/overlap",
}


def load(dir_: str):
    recs = []
    for f in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def roofline_table(recs, *, tag: str = "") -> str:
    rows = ["| arch | shape | kind | flops/dev | T_comp | T_mem | T_coll "
            "| bound | comp.frac | 6ND/HLO | lever |",
            "|---|---|---|---|---|---|---|---|---|---|---|"[:-4]]
    for r in recs:
        if r.get("multi_pod") or "skipped" in r:
            continue
        if (r.get("tag") or "") != tag:
            continue
        ro = r["roofline"]
        mfr = r.get("model_flops_ratio")
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['kind']} "
            f"| {ro['flops']:.2e} | {_fmt_s(ro['t_compute'])} "
            f"| {_fmt_s(ro['t_memory'])} | {_fmt_s(ro['t_collective'])} "
            f"| **{ro['bottleneck']}** | {ro['compute_fraction']:.2f} "
            f"| {mfr:.2f} |" if mfr else
            f"| {r['arch']} | {r['shape']} | {r['kind']} "
            f"| {ro['flops']:.2e} | {_fmt_s(ro['t_compute'])} "
            f"| {_fmt_s(ro['t_memory'])} | {_fmt_s(ro['t_collective'])} "
            f"| **{ro['bottleneck']}** | {ro['compute_fraction']:.2f} "
            f"| n/a |")
        rows[-1] += f" {LEVERS[ro['bottleneck']]} |"
    return "\n".join(rows)


def dryrun_matrix(recs) -> str:
    cells: dict = {}
    for r in recs:
        if (r.get("tag") or ""):
            continue
        key = (r["arch"], r["shape"])
        mesh = "multi" if r.get("multi_pod") else "single"
        if "skipped" in r:
            cells.setdefault(key, {})[mesh] = "SKIP"
            cells.setdefault(key, {})["why"] = r["skipped"]
        else:
            peak = r["memory"]["peak_est"]
            cells.setdefault(key, {})[mesh] = f"OK({_fmt_b(peak)})"
    rows = ["| arch | shape | 16x16 (peak/dev) | 2x16x16 (peak/dev) |",
            "|---|---|---|---|"]
    for (a, s), v in sorted(cells.items()):
        rows.append(f"| {a} | {s} | {v.get('single','?')} "
                    f"| {v.get('multi','?')} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join(
        os.path.dirname(__file__), "..", "..", "..", "build", "dryrun"))
    args = ap.parse_args(argv)
    recs = load(args.dir)
    print("## Dry-run matrix\n")
    print(dryrun_matrix(recs))
    print("\n## Roofline (single-pod 16x16 baselines)\n")
    print(roofline_table(recs))


if __name__ == "__main__":
    main()
