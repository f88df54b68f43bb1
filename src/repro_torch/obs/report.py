"""Human-readable rendering of the obs surfaces (port of
``repro.obs.report``): ``python -m repro_torch.obs.report`` prints a
metrics-snapshot table, the top-N slowest traces with their per-stage
breakdown, and the quality plane's recall/funnel report.

    PYTHONPATH=src python -m repro_torch.obs.report \
        [--snapshot obs_snapshots.jsonl] [--traces traces.json] \
        [--quality quality.json] [--top 5]

``--snapshot`` takes a JSONL file written by
:func:`repro_torch.obs.exporters.write_jsonl_snapshot` (the LAST line is
rendered); ``--traces`` a Chrome trace-event JSON file (as exported by
``Tracer.export_chrome`` / the ``/traces`` endpoint); ``--quality`` a
``ShadowAuditor.snapshot()`` JSON file (as served at
``/quality.json``). All renderers are importable so the serving
example and tests reuse them.
"""
from __future__ import annotations

import argparse
import json
import sys


def snapshot_table(snapshot: dict, *, max_rows: int = 200) -> str:
    """Registry snapshot dict -> aligned text table (one row per
    sample; histograms show count/mean/p50/p95/p99)."""
    rows = [("metric", "labels", "value")]
    for name in sorted(snapshot):
        fam = snapshot[name]
        for s in fam.get("samples", []):
            labels = ",".join(f"{k}={v}"
                              for k, v in sorted(s["labels"].items()))
            if fam["type"] == "histogram":
                val = (f"n={s['count']} mean={s['mean']:.3g} "
                       f"p50={s['p50']:.3g} p95={s['p95']:.3g} "
                       f"p99={s['p99']:.3g}")
            else:
                v = s["value"]
                val = f"{v:.6g}" if isinstance(v, float) else str(v)
            rows.append((name, labels, val))
    rows = rows[:max_rows + 1]
    widths = [max(len(r[i]) for r in rows) for i in range(2)]
    return "\n".join(f"{r[0]:<{widths[0]}}  {r[1]:<{widths[1]}}  {r[2]}"
                     for r in rows)


def traces_from_chrome(chrome: dict) -> list[dict]:
    """Group Chrome trace events back into per-trace summaries:
    ``{"trace_id", "name", "duration_s", "spans": [(name, dur_s,
    parent_id, span_id), ...]}``, root first."""
    by_trace: dict = {}
    for ev in chrome.get("traceEvents", []):
        args = ev.get("args", {})
        tid = args.get("trace_id")
        if tid is None:
            continue
        by_trace.setdefault(tid, []).append(ev)
    out = []
    for tid, events in by_trace.items():
        roots = [e for e in events if e["args"].get("parent_id") is None]
        if not roots:
            continue
        root = roots[0]
        spans = sorted(events, key=lambda e: e["ts"])
        out.append({
            "trace_id": tid,
            "name": root["name"],
            "duration_s": root["dur"] / 1e6,
            "spans": [(e["name"], e["dur"] / 1e6,
                       e["args"].get("parent_id"),
                       e["args"].get("span_id")) for e in spans],
        })
    return out


def slowest_traces(chrome: dict, n: int = 5) -> list[dict]:
    """The ``n`` slowest traces in a Chrome trace-event export,
    slowest first."""
    traces = traces_from_chrome(chrome)
    traces.sort(key=lambda t: -t["duration_s"])
    return traces[:n]


def slowest_traces_table(chrome: dict, n: int = 5) -> str:
    lines = []
    for t in slowest_traces(chrome, n):
        lines.append(f"trace {t['trace_id']}  {t['name']}  "
                     f"{t['duration_s'] * 1e3:.3f} ms")
        root_id = next((sid for name, _, pid, sid in t["spans"]
                        if pid is None), None)
        for name, dur, pid, _ in t["spans"]:
            if pid is None:
                continue
            depth = 1 if pid == root_id else 2
            lines.append(f"{'  ' * depth}- {name:<16} "
                         f"{dur * 1e3:.3f} ms")
    return "\n".join(lines) if lines else "(no traces)"


def funnel_table(quality: dict) -> str:
    """Render a ``ShadowAuditor.snapshot()`` dict as a text report:
    live recall with its Wilson interval, the SLO verdict, and the
    per-stage loss funnel (share of attributed misses per stage)."""
    win = quality.get("window", {})
    target = quality.get("target")
    lines = [
        f"live recall@{quality.get('k')}: "
        f"{win.get('live_recall', 0.0):.4f}  "
        f"wilson=[{win.get('wilson_lo', 0.0):.4f}, "
        f"{win.get('wilson_hi', 1.0):.4f}]  "
        f"({win.get('trials', 0)} trials / "
        f"{win.get('audited', 0)} audited)",
        f"SLO: {quality.get('slo_state', 'ok')}"
        + (f"  (target {target:.3f})" if target is not None
           else "  (no target attached)"),
        f"audits={quality.get('audits', 0)}  "
        f"dropped={quality.get('dropped', 0)}  "
        f"errors={quality.get('errors', 0)}",
    ]
    loss = quality.get("loss", {})
    misses = quality.get("misses", 0)
    total = sum(loss.values())
    lines.append(f"loss funnel ({misses} attributed misses):")
    for stage in ("router", "selector", "scorer", "refine"):
        cnt = loss.get(stage, 0)
        share = cnt / total if total else 0.0
        bar = "#" * round(share * 40)
        lines.append(f"  {stage:<9} {cnt:>6}  {share:>6.1%}  {bar}")
    drift = quality.get("drift")
    if drift is not None:
        lines.append(
            f"drift: nnz x{drift['nnz_ratio']:.3f}  "
            f"l1 x{drift['l1_ratio']:.3f}  "
            f"topcoord_tv={drift['topcoord_tv']:.3f}  "
            f"in_sample={drift['in_sample']:.2f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render obs snapshots and trace exports as text.")
    ap.add_argument("--snapshot", default=None,
                    help="JSONL snapshot file (last line is rendered)")
    ap.add_argument("--traces", default=None,
                    help="Chrome trace-event JSON file")
    ap.add_argument("--quality", default=None,
                    help="ShadowAuditor snapshot JSON file "
                         "(the /quality.json payload)")
    ap.add_argument("--top", type=int, default=5,
                    help="slowest traces to show (default 5)")
    args = ap.parse_args(argv)
    if not args.snapshot and not args.traces and not args.quality:
        ap.error("nothing to do: pass --snapshot, --traces and/or "
                 "--quality")
    if args.snapshot:
        with open(args.snapshot, encoding="utf-8") as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        if not lines:
            print(f"{args.snapshot}: empty", file=sys.stderr)
            return 1
        rec = json.loads(lines[-1])
        print(f"== metrics snapshot ({args.snapshot}, "
              f"{len(lines)} records, showing last) ==")
        print(snapshot_table(rec["metrics"]))
    if args.traces:
        with open(args.traces, encoding="utf-8") as f:
            chrome = json.load(f)
        print(f"== top {args.top} slowest traces ({args.traces}) ==")
        print(slowest_traces_table(chrome, args.top))
    if args.quality:
        with open(args.quality, encoding="utf-8") as f:
            quality = json.load(f)
        # either a bare ShadowAuditor.snapshot() or an artifact that
        # wraps several (e.g. serving_load's {"tuned": ..., "mistuned":
        # ...} obs_quality.json) — render every snapshot found
        sections = [("", quality)] if "window" in quality else \
            [(f" [{k}]", v) for k, v in quality.items()
             if isinstance(v, dict) and "window" in v]
        for tag, snap in sections:
            print(f"== quality plane ({args.quality}{tag}) ==")
            print(funnel_table(snap))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
