"""The harness finds cells, mixes and metrics by name, picks up new ones
added as files alone, and prints the contract's keys."""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest
from tiny_cells import ROOT

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
# a client that sends the pool ``rounds`` times, whatever the seconds
ROUNDS_CLIENT = """import time


def warm_up(sut, traffic, call):
    call(0)


def window(sut, traffic, seconds, call):
    t0 = time.perf_counter()
    answers = [(b, call(b)) for _ in range(traffic["rounds"])
               for b in range(len(sut.batches))]
    return {"answers": answers,
            "requests": sum(sut.size(b) for b, _ in answers),
            "t0": t0, "t1": time.perf_counter(), "per_second": []}
"""


def test_benchmark_json_keeps_the_contract():
    bench = harness.load_benchmark(ROOT)
    assert sorted(bench) == sorted(["command", "paths", "run_seconds",
                                    "configs", "workloads", "end_to_end",
                                    "per_layer"])
    assert (ROOT / bench["command"][1]).is_file()
    assert 1 <= bench["run_seconds"] <= 51
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [c["name"] for c in bench["configs"]] \
        + [w["name"] for w in bench["workloads"]] \
        + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert sorted(c) == ["file", "name", "reduced", "source", "why"]
        assert c["file"].startswith("perfbench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["source"] in ("host_clock",
                                                         "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["source"] in SOURCES
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        reported = [m for m in bench["per_layer"] if w["name"]
                    in m["workloads"]]
        assert reported


@pytest.mark.parametrize("name", [m["name"] for m in
                                  harness.load_benchmark(ROOT)["end_to_end"]
                                  + harness.load_benchmark(ROOT)["per_layer"]])
def test_each_metric_file_states_its_entry(name):
    bench = harness.load_benchmark(ROOT)
    entry = {m["name"]: m for m in bench["end_to_end"]
             + bench["per_layer"]}[name]
    mod = harness.load_metric(name, ROOT)
    assert (mod.UNIT, mod.SOURCE) == (entry["unit"], entry["source"])
    assert mod.MOVES == entry.get("moves", name)
    if "layer" in entry:
        assert mod.LAYER == entry["layer"]


def test_lookup_by_name_and_a_new_cell_added_as_files(tiny_root):
    cell = harness.load_cell("tiny-flat", tiny_root)
    assert cell.config["name"] == "tiny-flat"
    assert cell.traffic["batch"] == 64
    assert {m["name"] for m in cell.per_layer} >= {"router_ms", "scorer_ms"}
    # a new mix with its own client, a configuration and a per-layer
    # metric: files and entries only
    pb = tiny_root / "perfbench"
    (pb / "traffic" / "tiny-k5.json").write_text(json.dumps(
        {**cell.traffic, "k": 5, "batch": 32, "client": "rounds",
         "rounds": 3}))
    (pb / "clients" / "rounds.py").write_text(ROUNDS_CLIENT)
    cfg = dict(cell.config, name="tiny-flat-b8",
               search=dict(cell.config["search"], block_budget=8))
    (pb / "configs" / "tiny-flat-b8.json").write_text(json.dumps(cfg))
    (pb / "metrics" / "merge_ms.py").write_text(
        'LAYER = "retrieval/merge"\nUNIT = "ms"\nSOURCE = "program_span"\n'
        'MOVES = "qps"\n\n\ndef read(rec):\n    t = rec.stage_s.get("merge")\n'
        '    return 1e3 * sum(t) / len(t) if t else None\n')
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-flat-b8", "source": "tests",
                             "file": "perfbench/configs/tiny-flat-b8.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "tiny-new", "config": "tiny-flat-b8",
                               "traffic": "tiny-k5", "chips": 1,
                               "why": "tests"})
    bench["per_layer"].append({"name": "merge_ms", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "retrieval/merge", "moves": "qps",
                               "workloads": ["tiny-new"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    new = harness.load_cell("tiny-new", tiny_root)
    assert new.traffic["k"] == 5 and new.config["search"]["block_budget"] == 8
    line = harness.run_cell(new, 7, 0.2, True, device="cpu")
    assert line["correct"] is True
    assert line["notes"]["calls"] == 3 * 256 // 32
    assert line["metrics"]["merge_ms"]["value"] > 0
    assert "router_ms" not in line["metrics"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_contract_keys(tiny_root, trace):
    cell = harness.load_cell("tiny-flat", tiny_root)
    line = harness.run_cell(cell, 2**31 + 17, 0.3, trace, device="cpu")
    keys = list(line)
    assert keys[:5] == LINE_KEYS and keys[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] % cell.traffic["batch"] == 0
    assert line["attempted"] >= cell.traffic["batch"]
    want = {m["name"] for m in (cell.per_layer if trace
                                else cell.end_to_end)}
    assert set(line["metrics"]) <= want
    if not trace:    # on the CPU no device peak is read
        assert set(line["metrics"]) == want - {"peak_gib"}
    for m in line["metrics"].values():
        assert sorted(m) == ["unit", "value"]
    dev = line["device"]
    want_dev = {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(dev) == (want_dev | {"busy_s", "window_s"} if trace
                        else want_dev)
    assert set(line["checks"]) == set(cell.config["limits"])
    for c in line["checks"].values():
        assert sorted(c) == ["limit", "rule", "value"]
    json.dumps(line)


def test_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
         "flat-batch4096", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 3
    assert out.stdout == ""
    assert "CUDA" in out.stderr
