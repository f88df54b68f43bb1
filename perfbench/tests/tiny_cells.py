"""Two tiny cells for the benchmark's CPU tests: the real
configurations' shapes cut to a CPU's size, added to a copy of the
benchmark as files and entries."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_COLLECTION = {"dim": 1024, "n_docs": 4096, "doc_nnz": 32,
                   "query_nnz": 16, "n_topics": 32, "topic_coords": 128}
TINY_INDEX = {"lam": 128, "beta": 8, "alpha": 0.4, "block_cap": 32,
              "summary_nnz": 32, "fwd_dtype": "bfloat16"}
TINY_TRAFFIC = {"client": "closed_loop", "batch": 64, "pool": 256, "k": 10,
                "recall_sample": 64, "why": "tests"}
TINY_CELLS = {"tiny-flat": "msmarco-splade-flat",
              "tiny-knn": "msmarco-splade-knn"}
# budgets small enough that recall lies well under 1, so that a route or
# refine that loses documents shows in it, and the recall floors set from
# sound and faulty runs of these cells on the CPU: sound runs read
# 0.78-0.86 (flat) and 0.84-0.87 (kNN); half the block budget 0.58-0.63
# (flat), refine skipped 0.62-0.68 (kNN), the merge's k lowest under 0.07
TINY_SEARCH = {"cut": 8, "block_budget": 4}
TINY_KNN_SEARCH = {"superblock_fanout": 2, "superblock_budget": 2,
                   "graph_degree": 4}
TINY_RECALL_FLOOR = {"tiny-flat": 0.70, "tiny-knn": 0.75}


def make_tiny_root(dest: Path) -> Path:
    """A copy of BENCHMARK.json and perfbench/ under ``dest`` with the
    cells ``tiny-flat`` and ``tiny-knn`` added as files and entries."""
    shutil.copytree(ROOT / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell, real in TINY_CELLS.items():
        cfg = json.loads((ROOT / "perfbench" / "configs"
                          / f"{real}.json").read_text())
        cfg["name"] = cell
        cfg["collection"] = {**cfg["collection"], **TINY_COLLECTION}
        knn = cfg["graph"] is not None
        cfg["index"] = {**TINY_INDEX,
                        "superblock_fanout": 2 if knn else 0}
        search = dict(cfg["search"], **TINY_SEARCH)
        if knn:
            search.update(TINY_KNN_SEARCH)
            cfg["graph"] = {"degree": 4, "batch": 1024}
        cfg["search"] = search
        cfg["limits"] = dict(cfg["limits"],
                             recall_at_k={"min": TINY_RECALL_FLOOR[cell]})
        path = f"perfbench/configs/{cell}.json"
        (dest / path).write_text(json.dumps(cfg))
        bench["configs"].append({"name": cell, "source": "tests",
                                 "file": path, "reduced": [],
                                 "why": "tests"})
        bench["workloads"].append({"name": cell, "config": cell,
                                   "traffic": "tiny", "chips": 1,
                                   "why": "tests"})
        for m in bench["per_layer"] + bench["end_to_end"]:
            if "workloads" in m and any(
                    w.startswith(real.split("-")[-1])
                    for w in m["workloads"]):
                m["workloads"] = m["workloads"] + [cell]
    (dest / "perfbench" / "traffic" / "tiny.json").write_text(
        json.dumps(TINY_TRAFFIC))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest
