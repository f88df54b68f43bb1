"""``perfbench/spans.py`` on hand-made Chrome events: device operations
put down to the program's stage ranges through ``correlation``, idle
gaps to the range over their middle or to the loop between calls, and
launches and syncs counted inside ``seismic.search`` alone."""
from __future__ import annotations

import pytest

from perfbench import devtrace, spans

HOST = {"pid": 1, "tid": 1}


def rng(name, ts, dur, **where):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, **(where or HOST)}


def rt(name, ts, corr=None, **where):
    ev = {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
          "dur": 1, **(where or HOST)}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def op(ts, dur, corr, cat="kernel", name="k"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7, "args": {"correlation": corr}}


STAGE_RANGES = [("prep", 10, 10), ("router", 20, 10), ("selector", 30, 20),
                ("scorer", 50, 20), ("merge", 70, 10), ("refine", 80, 10)]
EVENTS = [
    rng(devtrace.WINDOW, 0, 200),
    # call A with its six stages, a refine round inside refine
    rng("seismic.search", 10, 80),
    *[rng("seismic." + s, a, d) for s, a, d in STAGE_RANGES],
    rng("seismic.refine_round_0", 81, 8),
    # call B with a scorer alone; the device's copy of a range is no range
    rng("seismic.search", 110, 80),
    rng("seismic.scorer", 120, 60),
    {"ph": "X", "cat": "gpu_user_annotation", "name": "seismic.router",
     "ts": 120, "dur": 60, "pid": 0, "tid": 7},
    rt("cudaLaunchKernel", 12, 1), rt("cudaLaunchKernel", 32, 2),
    rt("cudaLaunchKernel", 52, 3), rt("cudaMemcpyAsync", 72, 4),
    rt("cudaStreamSynchronize", 74),
    rt("cudaLaunchKernel", 95, 5),            # between the calls
    rt("cudaDeviceSynchronize", 100),         # between the calls
    rt("cudaLaunchKernel", 125, 6),
    rt("cudaLaunchKernel", 33, 7, pid=1, tid=2),   # another host thread
    op(14, 4, 1), op(34, 10, 2, name="gather_dot_cand_kernel"),
    op(54, 12, 3, name="gather_dot_cand_kernel"),
    op(73, 2, 4, cat="gpu_memcpy", name="Memcpy DtoH"),
    op(96, 4, 5), op(126, 50, 6), op(180, 5, 7),
]


def test_device_time_goes_to_the_range_that_launched_it():
    s = spans.split_events(EVENTS)
    assert s.calls == 2
    want = {"prep": 4, "selector": 10, "scorer": 12 + 50, "merge": 2,
            spans.OUTSIDE: 4 + 5}
    assert s.device_s == pytest.approx({k: v * 1e-6 for k, v in
                                        want.items()})
    assert s.stage_ms("scorer") == pytest.approx(1e3 * 62e-6 / 2)
    assert s.stage_ms("router") == 0.0
    # the same stretch as devtrace reads it
    t = devtrace.read_events(EVENTS)
    assert s.busy_s == pytest.approx(t.busy_s)
    assert s.window_s == pytest.approx(t.window_s)
    assert sum(s.device_s.values()) == pytest.approx(t.busy_s)


def test_idle_gaps_go_to_the_range_over_their_middle():
    s = spans.split_events(EVENTS)
    want = {spans.BETWEEN: 14 + 15, "router": 16, "selector": 10,
            "scorer": 7 + 4, "refine": 21, "search": 26}
    assert s.idle_s == pytest.approx({k: v * 1e-6 for k, v in
                                      want.items()})
    assert sum(s.idle_s.values()) == pytest.approx(s.window_s - s.busy_s)
    assert s.pipeline_idle_ms() == pytest.approx(1e3 * (113 - 29) * 1e-6
                                                 / 2)


def test_launches_and_syncs_counted_inside_search_alone():
    s = spans.split_events(EVENTS)
    assert (s.launches, s.syncs) == (5, 1)
    assert spans.is_launch("cudaLaunchKernelExC")
    assert spans.is_launch("cudaMemsetAsync")
    assert not spans.is_launch("cudaMemcpy")
    assert spans.is_sync("cudaMemcpy") and not spans.is_sync(
        "cudaMemcpyAsync")


def test_a_program_without_the_ranges_gives_nothing():
    bare = [e for e in EVENTS if not e["name"].startswith("seismic.")]
    assert spans.split_events(bare) is None
    assert spans.split_events(EVENTS[1:]) is None        # no window
