"""The benchmark harness: one cell of ``BENCHMARK.json``, run once.

Everything that belongs to one configuration, traffic mix, metric or
planted fault is a file of its own, found by the name it is given:

* ``configs/<config>.json``: a deployment. ``system`` names the module
  under ``systems/`` that sets the program up and calls it, ``reference``
  the plain reference's file, ``limits`` one limit for each number the
  reference's ``check`` gives (``{"max": x}`` or ``{"min": x}``); the
  rest (sizes, search parameters, kernels, control) is the system's.
  ``source``, ``assumed`` and ``reduced`` say where it comes from.
* ``traffic/<mix>.json``: the load. ``client`` names the module under
  ``clients/`` that sends it; the rest (batch, pool, k, recall sample)
  is for the client, the system and the reference.
* ``systems/<system>.py``: ``build_kernels(config)``, ``inputs(config,
  traffic, seed, dev)`` (the benchmark's data, drawn from the seed) and
  ``setup(config, traffic, inputs, dev, control)`` -> the system under
  test: ``batches``, ``size(b)``, ``call(b)`` and ``call_staged(b,
  record)`` (an answer on the host), ``stretch(repeats)`` (the profiled
  stretch), ``context(repeats)`` (what metrics collect from), ``values``
  (what set-up measured) and ``free()``.
* ``clients/<client>.py``: ``warm_up(sut, traffic, call)`` and
  ``window(sut, traffic, seconds, call)`` -> ``answers`` [(b, answer)],
  ``requests``, ``t0``, ``t1`` and ``per_second``.
* the reference's file: ``check(config, traffic, inputs, batches,
  answers, seed)`` -> ({name: value}, requests failed).
* ``metrics/<metric>.py``: one metric, end-to-end or per-layer. It
  states ``LAYER``, ``UNIT``, ``SOURCE`` and ``MOVES``, and has
  ``read(rec: Record) -> float | None`` (None: nothing to read, the
  metric is left out of the line). A per-layer metric may add
  ``collect(ctx)``, called in a traced run with the system's
  ``context``; what it returns is ``rec.collected[<metric>]``.
* ``faults/<fault>.py``: ``plant(sut)`` breaks the timed path underneath
  (for the check's own tests; the benchmark's runs never plant one) and
  returns a callable that undoes it, or None.

A run: the kernels built (or loaded), the inputs drawn on the device from
the seed, the system set up, the cell's batches warmed, then the window
of ``seconds``. A traced run (``trace=True``) sends the window's batches
through ``call_staged`` for stage times, then profiles the system's
stretch. Then the program's state is freed and the answers are held to
the plain reference.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import resource
import sys
import time
from pathlib import Path

import torch

from perfbench import devtrace

ROOT = Path(__file__).resolve().parents[1]
PKG = "perfbench"
PROFILE_CYCLES = 2     # the profiled stretch: each distinct batch this often


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    end_to_end: list       # BENCHMARK.json entries that this cell reports
    per_layer: list
    root: Path


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The workload ``workload`` of ``root``'s BENCHMARK.json with its
    configuration, traffic mix and metrics."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"({sorted(cells)})")
    w = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (root / PKG / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name=workload, config_name=w["config"], config=config,
                traffic_name=w["traffic"], traffic=traffic,
                chips=int(w["chips"]),
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, workload)],
                root=root)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_module(kind: str, name: str, root: Path = ROOT):
    """The module ``perfbench/<kind>/<name>.py`` of ``root``."""
    return _load(root / PKG / kind / f"{name}.py",
                 f"perfbench_{kind}_" + name.replace(".", "_")
                 .replace("-", "_"))


def load_metric(name: str, root: Path = ROOT):
    return load_module("metrics", name, root)


def load_reference(cell: Cell):
    """The configuration's plain reference (its ``reference`` file)."""
    return _load(cell.root / cell.config["reference"],
                 "perfbench_reference_" + cell.config_name.replace("-", "_"))


@dataclasses.dataclass
class Record:
    """What a run recorded, for the metrics' ``read``: ``answers`` are
    the window's, ``values`` what the system's set-up measured and the
    numbers the reference's check gave."""

    setup_s: float
    window_s: float
    requests: int
    peak_bytes: int
    answers: list
    values: dict
    stage_s: dict = dataclasses.field(default_factory=dict)
    device_trace: devtrace.DeviceTrace | None = None
    collected: dict = dataclasses.field(default_factory=dict)


def judge(values: dict, limits: dict) -> dict:
    """Each limited number beside its limit: {name: {value, limit,
    rule}}, ``rule`` "max" (at most the limit) or "min" (at least)."""
    out = {}
    for name, lim in limits.items():
        (rule, limit), = lim.items()
        out[name] = {"value": values.get(name), "limit": limit, "rule": rule}
    return out


def passes(check: dict) -> bool:
    v = check["value"]
    if v is None:
        return False
    return v <= check["limit"] if check["rule"] == "max" \
        else v >= check["limit"]


def host_sample() -> tuple:
    """The wall clock, the process's CPU seconds and its involuntary and
    voluntary context switches, now."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return time.perf_counter(), time.process_time(), ru.ru_nivcsw, \
        ru.ru_nvcsw


def host_delta(a: tuple, b: tuple) -> dict:
    """What the host did between two ``host_sample``s: the process's CPU
    share of the wall time and its context switches (a diagnostic of
    contention for the host)."""
    return {"cpu_share": (b[1] - a[1]) / max(b[0] - a[0], 1e-9),
            "nivcsw": b[2] - a[2], "nvcsw": b[3] - a[3]}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None,
             control: bool = False, fault: str | None = None) -> dict:
    """Run ``cell`` once and return its result line (a dict). ``control``
    runs the program's lower-precision path; ``fault`` plants
    ``faults/<fault>.py`` under the timed path."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    system = load_module("systems", cfg["system"], cell.root)
    client = load_module("clients", traffic["client"], cell.root)
    notes: dict = {}
    if dev.type == "cuda":
        t0 = time.perf_counter()
        system.build_kernels(cfg)
        notes["kernel_build_s"] = time.perf_counter() - t0

    # ---- the inputs, drawn from the seed (the benchmark's work)
    t0 = time.perf_counter()
    data = system.inputs(cfg, traffic, seed, dev)
    _sync(dev)
    notes["inputs_s"] = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # ---- the program's set-up, the warm-up and the window
    sut = system.setup(cfg, traffic, data, dev, control)
    batches = sut.batches
    stage_s: dict = {}

    def record(stage, sec):
        stage_s.setdefault(stage, []).append(sec)

    call = (lambda b: sut.call_staged(b, record)) if trace else sut.call
    undo = load_module("faults", fault, cell.root).plant(sut) \
        if fault else None
    try:
        client.warm_up(sut, traffic, call)
        stage_s.clear()
        h0 = host_sample()
        w = client.window(sut, traffic, seconds, call)
        notes["host_window"] = host_delta(h0, host_sample())
        if dev.type == "cuda":
            notes["card_after_window"] = devtrace.card_state()
        peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
        answers = list(w["answers"])

        # ---- the traced run's device profile and what metrics collect
        dtrace, collected = None, {}
        if trace:
            prof: list = []
            dtrace = devtrace.profile(
                lambda: prof.extend(sut.stretch(PROFILE_CYCLES)))
            answers += [(b, tuple(t.cpu() for t in a)) for b, a in prof]
            ctx = sut.context(PROFILE_CYCLES)
            for m in cell.per_layer:
                mod = load_metric(m["name"], cell.root)
                if hasattr(mod, "collect"):
                    collected[m["name"]] = mod.collect(ctx)
            del prof, ctx
    finally:
        if undo:
            undo()
    values = dict(sut.values)
    attempted = sum(sut.size(b) for b, _ in answers)
    sut.free()
    del sut, call
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the reference, after the window and with the program freed
    t0 = time.perf_counter()
    checked, failed = load_reference(cell).check(cfg, traffic, data, batches,
                                                 answers, seed)
    notes["reference_s"] = time.perf_counter() - t0
    values.update(checked)
    checks = judge(values, cfg["limits"])
    rec = Record(setup_s=w["t0"] - t_start, window_s=w["t1"] - w["t0"],
                 requests=w["requests"], peak_bytes=int(peak),
                 answers=w["answers"], values=values, stage_s=stage_s,
                 device_trace=dtrace, collected=collected)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_metric(m["name"], cell.root).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    notes.update(calls=len(w["answers"]), queries_by_second=w["per_second"],
                 control=control, fault=fault,
                 build_phases=values.get("build_phases"))
    if stage_s:
        notes["stage_ms"] = {k: 1e3 * sum(v) / len(v)
                             for k, v in stage_s.items()}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    line = {"correct": all(passes(c) for c in checks.values()),
            "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": device_info}
    if trace:
        device_info["busy_s"] = dtrace.busy_s if dtrace else None
        device_info["window_s"] = dtrace.window_s if dtrace else None
        if dtrace:
            line["breakdown"] = {"device_ops": dtrace.top_ops(),
                                 "idle_gaps": dtrace.top_idle()}
    line["notes"] = notes
    line["checks"] = checks
    return line
