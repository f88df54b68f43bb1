"""The device trace of a short steady stretch: ``torch.profiler`` with
CPU and CUDA activities, read back from its Chrome trace.

The stretch runs inside one ``record_function`` span (``WINDOW``); its
length is ``window_s``. Device operations are the trace's kernels,
memory copies and memory sets; ``busy_s`` is the union of their
intervals inside the window, and the gaps in that union are the device's
idle time, each put down to the innermost host event (operator, runtime
call or span) that spans the gap's middle.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import tempfile

import torch

WINDOW = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
TOP = 10
# what ``card_state`` reads; the throttle reasons are left out where this
# ``nvidia-smi`` does not know the field
CARD_FIELDS = ("name", "power.limit", "power.draw", "clocks.sm", "clocks.mem",
               "temperature.gpu", "clocks_throttle_reasons.active")


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    op_s: dict            # device operation name -> seconds in the window
    idle_s: dict          # host activity during idle gaps -> seconds

    def top_ops(self, n: int = TOP) -> list:
        return [[k, v] for k, v in sorted(self.op_s.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def top_idle(self, n: int = TOP) -> list:
        return [[k, v] for k, v in sorted(self.idle_s.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def kernel_s(self, symbol: str) -> float:
        """Device seconds of every operation whose name holds ``symbol``."""
        return sum(v for k, v in self.op_s.items() if symbol in k)


def profile(fn) -> DeviceTrace | None:
    """Run ``fn()`` under the profiler; None where the trace holds no
    device operation (no card, or no device activity recorded)."""
    from torch.profiler import ProfilerActivity, profile as _profile, \
        record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with _profile(activities=acts) as prof:
        with record_function(WINDOW):
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return read_events(events)


def read_events(events: list) -> DeviceTrace | None:
    """The window, busy time, device time by operation and idle time by
    host activity of a list of Chrome trace events."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in spans if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = sorted((max(float(e["ts"]), w0),
                  min(float(e["ts"]) + float(e["dur"]), w1), e["name"])
                 for e in spans if e.get("cat") in DEVICE_CATS)
    dev = [d for d in dev if d[1] > d[0]]
    if not dev:
        return None
    op_s: dict = {}
    for a, b, name in dev:
        op_s[name] = op_s.get(name, 0.0) + (b - a) * 1e-6
    busy, gaps = 0.0, []
    cur_a, cur_b = dev[0][0], dev[0][1]
    gaps.append((w0, cur_a))
    for a, b, _ in dev[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    gaps.append((cur_b, w1))
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in spans if e.get("cat") in HOST_CATS
            and e.get("name") != WINDOW]
    idle_s: dict = {}
    for a, b in gaps:
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        inner = [h for h in host if h[0] <= mid <= h[1]]
        name = min(inner, key=lambda h: h[1] - h[0])[2] if inner \
            else "host outside any traced call"
        idle_s[name] = idle_s.get(name, 0.0) + (b - a) * 1e-6
    return DeviceTrace(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
                       op_s=op_s, idle_s=idle_s)


def card_state(fields=CARD_FIELDS) -> str:
    """The card's name, power limit and draw, clocks, temperature and
    active throttle reasons as ``nvidia-smi`` reads them now, one line."""
    for want in (fields, fields[:-1]):
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=" + ",".join(want),
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30)
        except (OSError, subprocess.TimeoutExpired) as exc:
            return f"nvidia-smi: {exc}"
        if out.returncode == 0:
            return out.stdout.strip()
    return "nvidia-smi: " + (out.stdout + out.stderr).strip()[-200:]
