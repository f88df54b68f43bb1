"""The device trace of the profiled stretch put down to the program's own
stage ranges: ``seismic.search`` over each pipeline call and
``seismic.<stage>`` over each of its six stages, which
``repro_torch.retrieval.pipeline`` opens while a profiler records.

* Each kernel, copy and memset is linked to the runtime call that
  launched it by the trace's ``correlation`` id, and goes to the
  innermost stage range (or ``search`` itself) on that host thread that
  holds the launch; a device operation launched outside every range goes
  to ``OUTSIDE``.
* Each idle gap of the card goes to the innermost range over its middle;
  a gap outside every ``seismic.search`` goes to ``BETWEEN``, the
  benchmark's loop between calls.
* Runtime calls inside ``seismic.search`` are counted: launches (kernel
  launches, asynchronous copies and memsets) and host syncs (the host
  waiting on the card).

A program without these ranges (one older than them) gives None.
``devtrace`` reads the same events for the card's busy and idle time;
this module adds to it and changes nothing there.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import torch

from perfbench import devtrace

PREFIX = "seismic."
SEARCH = "search"
STAGES = ("prep", "router", "selector", "scorer", "merge", "refine")
BETWEEN = "between_calls"
OUTSIDE = "outside"
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "cudaMemset")


@dataclasses.dataclass
class StageSplit:
    """One profiled stretch, split by the program's ranges. ``device_s``
    and ``idle_s`` are keyed by stage, ``search`` (inside the call but
    outside every stage), ``OUTSIDE`` (device time launched outside every
    range) and ``BETWEEN`` (idle outside every call); ``calls`` counts
    the ``seismic.search`` ranges."""

    calls: int
    window_s: float
    busy_s: float
    device_s: dict
    idle_s: dict
    launches: int
    syncs: int

    def per_call_ms(self, seconds: float) -> float:
        return 1e3 * seconds / self.calls

    def stage_ms(self, stage: str) -> float:
        """Device ms a call launched inside ``seismic.<stage>``."""
        return self.per_call_ms(self.device_s.get(stage, 0.0))

    def pipeline_idle_ms(self) -> float:
        """Idle ms a call inside ``seismic.search``."""
        return self.per_call_ms(sum(v for k, v in self.idle_s.items()
                                    if k != BETWEEN))


def is_launch(name: str) -> bool:
    return name.startswith(LAUNCHES) or (
        name.startswith(("cudaMemcpy", "cudaMemset"))
        and name.endswith("Async"))


def is_sync(name: str) -> bool:
    return name in SYNCS


def _key(name: str) -> str | None:
    """The range's stage, or ``search``; None for any other name (a
    refine round counts under its ``refine``)."""
    if not name.startswith(PREFIX):
        return None
    key = name[len(PREFIX):]
    return key if key == SEARCH or key in STAGES else None


def _innermost(ranges: list, t: float) -> str | None:
    """The key of the shortest range of ``ranges`` that holds ``t``."""
    inner = [r for r in ranges if r[0] <= t <= r[1]]
    return min(inner, key=lambda r: r[1] - r[0])[2] if inner else None


def split_events(events: list) -> StageSplit | None:
    """Split a Chrome trace's events (``devtrace.profile``'s, with its
    ``WINDOW``) by the program's ranges; None without a window, a device
    operation or a ``seismic.search`` range in it."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in spans if e.get("name") == devtrace.WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    ranges: dict = {}             # host thread -> [(start, end, key)]
    for e in spans:
        key = _key(e.get("name", ""))
        if e.get("cat") == "user_annotation" and key is not None:
            a = float(e["ts"])
            ranges.setdefault((e.get("pid"), e.get("tid")), []).append(
                (a, a + float(e["dur"]), key))
    calls = sum(1 for rs in ranges.values() for r in rs
                if r[2] == SEARCH and w0 <= r[0] and r[1] <= w1)
    if not calls:
        return None
    owner: dict = {}              # correlation id -> key
    launches = syncs = 0
    for e in spans:
        if e.get("cat") not in RUNTIME_CATS:
            continue
        key = _innermost(ranges.get((e.get("pid"), e.get("tid")), []),
                         float(e["ts"]))
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            owner[corr] = key or OUTSIDE
        if key is not None:
            launches += is_launch(e["name"])
            syncs += is_sync(e["name"])
    dev = []
    for e in spans:
        if e.get("cat") not in devtrace.DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b > a:
            dev.append((a, b, owner.get(e.get("args", {}).get("correlation"),
                                        OUTSIDE)))
    if not dev:
        return None
    dev.sort()
    device_s: dict = {}
    for a, b, key in dev:
        device_s[key] = device_s.get(key, 0.0) + (b - a) * 1e-6
    busy, gaps = 0.0, [(w0, dev[0][0])]
    cur_a, cur_b = dev[0][0], dev[0][1]
    for a, b, _ in dev[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    gaps.append((cur_b, w1))
    every = [r for rs in ranges.values() for r in rs]
    idle_s: dict = {}
    for a, b in gaps:
        if b > a:
            key = _innermost(every, 0.5 * (a + b)) or BETWEEN
            idle_s[key] = idle_s.get(key, 0.0) + (b - a) * 1e-6
    return StageSplit(calls=calls, window_s=(w1 - w0) * 1e-6,
                      busy_s=busy * 1e-6, device_s=device_s, idle_s=idle_s,
                      launches=launches, syncs=syncs)


def profile_events(fn) -> list:
    """The Chrome trace events of ``fn()`` run under the profiler with
    CPU and CUDA activities inside ``devtrace.WINDOW``, as
    ``devtrace.profile`` runs it."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(devtrace.WINDOW):
            fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def stretch_split(ctx) -> StageSplit | None:
    """The profiled stretch of a traced run (each distinct batch
    ``ctx.repeats`` times through the timed entry, ``search_pipeline``,
    the answers left on the card until it ends), profiled again and split
    by the program's ranges; None without a card. Made once for a
    context and kept on it, for every metric that reads it."""
    if not torch.cuda.is_available():
        return None
    if "stage_split" not in vars(ctx):
        from perfbench.systems.seismic import batches_of
        from repro_torch.retrieval.pipeline import search_pipeline
        from repro_torch.sparse.ops import PaddedSparse

        batches = batches_of(ctx.coll, ctx.probes[0]["cand"].shape[0])

        def stretch():
            out = []
            for _ in range(ctx.repeats):
                for c, v in batches:
                    out.append(search_pipeline(
                        ctx.index, PaddedSparse(c, v, ctx.coll.dim),
                        ctx.params))
            return out
        stretch()                 # the batches' host copies warmed
        ctx.stage_split = split_events(profile_events(stretch))
    return ctx.stage_split
