"""The E-SPLADE cell at a CPU's size: the configuration's shapes kept
(passages of an odd width that is no power of two, queries narrower than
the cut), the collection and index cut as the tiny cells' are. A sound
run is correct and times the build's postings phase; half the block
budget falls below the recall floor."""
from __future__ import annotations

import json

import pytest
from tiny_cells import ROOT, TINY_COLLECTION, TINY_INDEX, TINY_TRAFFIC

from perfbench import harness

CELL = "tiny-esplade"
# 45 = 32 * 181 / 128, rounded: the tiny cells' passages widened as
# E-SPLADE's are against SPLADE's; queries 6 wide under the cut of 10;
# half the tiny cells' documents, to keep the CPU's time down
TINY_ESPLADE = {"doc_nnz": 45, "query_nnz": 6, "n_docs": 2048}
# the block budget cut, as the tiny cells', so that recall lies under 1;
# the floor set between sound runs on the CPU (0.809-0.897 over 8 seeds)
# and half the block budget (0.589-0.716 on the same seeds)
TINY_BUDGET = 4
TINY_FLOOR = 0.755


def add_esplade_cell(tiny_root):
    """The tiny benchmark ``tiny_root`` with the cell ``tiny-esplade``
    added."""
    cfg = json.loads((ROOT / "perfbench" / "configs"
                      / "msmarco-esplade-flat.json").read_text())
    assert cfg["collection"]["query_nnz"] < cfg["search"]["cut"]
    cfg["name"] = CELL
    cfg["collection"] = {**cfg["collection"], **TINY_COLLECTION,
                         **TINY_ESPLADE}
    cfg["index"] = {**TINY_INDEX, "superblock_fanout": 0}
    cfg["search"] = dict(cfg["search"], block_budget=TINY_BUDGET)
    cfg["limits"] = dict(cfg["limits"], recall_at_k={"min": TINY_FLOOR})
    path = f"perfbench/configs/{CELL}.json"
    (tiny_root / path).write_text(json.dumps(cfg))
    # the whole pool in one batch: every window answers the recall
    # sample's queries, however few calls it makes on a busy host
    (tiny_root / "perfbench" / "traffic" / f"{CELL}.json").write_text(
        json.dumps(dict(TINY_TRAFFIC, batch=TINY_TRAFFIC["pool"])))
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": CELL, "source": "tests", "file": path,
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": CELL, "config": CELL,
                               "traffic": CELL, "chips": 1,
                               "why": "tests"})
    for m in bench["per_layer"]:
        if "esplade-flat-batch4096" in m.get("workloads", ()):
            m["workloads"] = m["workloads"] + [CELL]
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    return tiny_root


@pytest.fixture
def esplade_root(tiny_root):
    return add_esplade_cell(tiny_root)


def test_sound_run_is_correct_and_times_the_postings_phase(esplade_root):
    c = harness.load_cell(CELL, esplade_root)
    line = harness.run_cell(c, 2**31 + 5, 0.1, False, device="cpu")
    assert line["correct"] is True, line["checks"]
    phases = line["notes"]["build_phases"]
    assert phases["postings"] > 0                 # postings_s reads it
    assert "postings_peak_bytes" not in phases    # a card's counter only


def test_half_the_budget_falls_below_the_floor(esplade_root):
    c = harness.load_cell(CELL, esplade_root)
    half = harness.run_cell(c, 43, 0.1, False, device="cpu",
                            fault="half_budget")
    checks = half["checks"]
    assert half["correct"] is False
    assert not harness.passes(checks["recall_at_k"])
    assert harness.passes(checks["bad_rows"])
    assert harness.passes(checks["score_gap"])
