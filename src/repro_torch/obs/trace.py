"""Per-request tracing: span trees, a bounded trace ring buffer, and
Chrome trace-event export (port of ``repro.obs.trace``).

A *trace* is one request's (or one sync launch's) tree of spans. The
id is minted at ``AsyncSeismicServer.submit`` and rides the request
through the queue, the micro-batcher, and — on sampled launches — down
into per-stage and per-refine-round child spans of
``run_pipeline_staged``. Completed traces land in a bounded ring
buffer (oldest evicted) and export as Chrome trace-event JSON that
loads directly in Perfetto / ``chrome://tracing``.

Span model::

    request                      one per submit; root span
    ├─ queue_wait                submit -> dispatch
    └─ launch                    dispatch -> results ready
       ├─ stage_prep ...         6 children, batch leader only,
       ├─ stage_refine           on SAMPLED launches
       │  ├─ refine_round_0      per-round children of stage_refine
       │  └─ refine_round_1
       └─ ...

A batch launch runs ONCE for up to ``max_batch`` requests: every
member request gets its own ``launch`` span (same wall interval,
``batch_seq`` attr links them), and the per-stage children attach to
the *batch leader*'s launch span — stages ran once, so they are
recorded once. Coalesced followers carry ``coalesced_into=<primary
trace id>`` on their root span.

All span timestamps are ``time.monotonic()`` seconds (the serving
layer's clock); Chrome export converts to microseconds.
"""
from __future__ import annotations

import itertools
import json
import threading
from collections import deque
from dataclasses import dataclass, field


@dataclass
class Span:
    """One timed operation inside a trace."""

    trace_id: int
    span_id: int
    parent_id: int | None
    name: str
    t0: float                       # monotonic seconds
    t1: float | None = None         # None while open
    attrs: dict = field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return (self.t1 if self.t1 is not None else self.t0) - self.t0


@dataclass
class Trace:
    """One request's span tree. ``spans[0]`` is the root."""

    trace_id: int
    spans: list[Span] = field(default_factory=list)

    @property
    def root(self) -> Span:
        return self.spans[0]

    @property
    def duration_s(self) -> float:
        return self.root.duration_s

    def span_map(self) -> dict[int, Span]:
        return {s.span_id: s for s in self.spans}


class Tracer:
    """Thread-safe span factory + bounded finished-trace ring buffer.

    ``capacity`` bounds RETAINED finished traces, not tracing rate —
    every request is traced; old traces are evicted FIFO. The ring
    holds small plain-python objects (~a few hundred bytes per trace),
    so the default keeps memory in the low MBs.
    """

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._ring: deque[Trace] = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self.dropped = 0            # finished traces evicted from the ring

    # ------------------------------------------------------ span API

    def start_trace(self, name: str, t0: float, **attrs) -> Trace:
        """Mint a trace whose root span is ``name``, open at ``t0``."""
        with self._lock:
            tid = next(self._ids)
            sid = next(self._ids)
        tr = Trace(trace_id=tid)
        tr.spans.append(Span(trace_id=tid, span_id=sid, parent_id=None,
                             name=name, t0=t0, attrs=dict(attrs)))
        return tr

    def add_span(self, trace: Trace, name: str, t0: float,
                 t1: float | None = None, parent: Span | None = None,
                 **attrs) -> Span:
        """Append a span (retroactively closed when ``t1`` is given).
        ``parent`` defaults to the trace root."""
        with self._lock:
            sid = next(self._ids)
        p = parent if parent is not None else trace.root
        s = Span(trace_id=trace.trace_id, span_id=sid,
                 parent_id=p.span_id, name=name, t0=t0, t1=t1,
                 attrs=dict(attrs))
        trace.spans.append(s)
        return s

    def end_span(self, span: Span, t1: float, **attrs) -> None:
        span.t1 = t1
        if attrs:
            span.attrs.update(attrs)

    def end_trace(self, trace: Trace, t1: float, **attrs) -> None:
        """Close the root span and retire the trace into the ring."""
        self.end_span(trace.root, t1, **attrs)
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(trace)

    # ----------------------------------------------------- inspection

    def finished(self) -> list[Trace]:
        """Snapshot of retained finished traces, oldest first."""
        with self._lock:
            return list(self._ring)

    def drain(self) -> list[Trace]:
        with self._lock:
            out = list(self._ring)
            self._ring.clear()
            return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -------------------------------------------------------- export

    def export_chrome(self) -> dict:
        """Chrome trace-event JSON of every retained trace (viewable in
        Perfetto / about:tracing)."""
        return chrome_trace(self.finished())


def chrome_trace(traces: list[Trace]) -> dict:
    """Traces -> Chrome trace-event JSON (``ph: "X"`` complete events).

    Each trace gets its own ``tid`` so its spans nest visually;
    ``args`` carries the span/parent ids so the tree survives the
    (flat) event format round-trip.
    """
    events = []
    for tr in traces:
        for s in tr.spans:
            t1 = s.t1 if s.t1 is not None else s.t0
            events.append({
                "name": s.name,
                "cat": "seismic",
                "ph": "X",
                "ts": s.t0 * 1e6,              # Chrome wants microseconds
                "dur": max(0.0, (t1 - s.t0) * 1e6),
                "pid": 1,
                "tid": tr.trace_id,
                "args": {"trace_id": tr.trace_id, "span_id": s.span_id,
                         "parent_id": s.parent_id, **s.attrs},
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate_trace(trace: Trace, *, eps: float = 5e-4) -> None:
    """Assert one trace's span tree is well-formed: exactly one root,
    every parent id resolves in-trace, spans are closed, and children
    lie inside their parent's interval (within ``eps`` seconds of
    timer slop). Raises ``ValueError`` on the first violation."""
    by_id = trace.span_map()
    roots = [s for s in trace.spans if s.parent_id is None]
    if len(roots) != 1 or roots[0] is not trace.root:
        raise ValueError(f"trace {trace.trace_id}: {len(roots)} roots")
    for s in trace.spans:
        if s.t1 is None:
            raise ValueError(
                f"trace {trace.trace_id}: span {s.name} never closed")
        if s.t1 < s.t0:
            raise ValueError(
                f"trace {trace.trace_id}: span {s.name} ends before "
                f"it starts")
        if s.parent_id is None:
            continue
        p = by_id.get(s.parent_id)
        if p is None:
            raise ValueError(
                f"trace {trace.trace_id}: span {s.name} parent "
                f"{s.parent_id} not in trace")
        if s.t0 < p.t0 - eps or (p.t1 is not None and s.t1 > p.t1 + eps):
            raise ValueError(
                f"trace {trace.trace_id}: span {s.name} "
                f"[{s.t0:.6f}, {s.t1:.6f}] outside parent {p.name} "
                f"[{p.t0:.6f}, {p.t1:.6f}]")


def chrome_trace_json(traces: list[Trace]) -> str:
    return json.dumps(chrome_trace(traces))


__all__ = ["Span", "Trace", "Tracer", "chrome_trace",
           "chrome_trace_json", "validate_trace"]
