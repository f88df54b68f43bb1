"""What a cell loads: no module whose top-level name, compared whole, is
JAX's or the JAX package's, and a reference that imports nothing of the
program."""
from __future__ import annotations

import ast
import json
import subprocess
import sys

from tiny_cells import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

DRIVE = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}, {tests!r}]
from pathlib import Path
from tiny_cells import make_tiny_root
from perfbench import harness
root = make_tiny_root(Path({tmp!r}))
line = harness.run_cell(harness.load_cell("tiny-knn", root), 5, 0.2, True,
                        device="cpu")
print(json.dumps({{"correct": line["correct"],
                   "top": sorted({{m.split(".", 1)[0]
                                   for m in sys.modules}})}}))
"""


def _top_level_after(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_cell_loads_neither_jax_nor_the_jax_package(tmp_path):
    got = _top_level_after(DRIVE.format(
        root=str(ROOT), src=str(ROOT / "src"),
        tests=str(ROOT / "perfbench" / "tests"), tmp=str(tmp_path)))
    assert got["correct"] is True
    assert "repro_torch" in got["top"]
    assert not FORBIDDEN & set(got["top"])


def test_run_py_names_jax_modules_by_whole_top_level_name(monkeypatch):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "perfbench_run_entry", ROOT / "perfbench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    assert set(run.FORBIDDEN) == FORBIDDEN
    fake = {"repro_torch.retrieval": None, "reproduce": None,
            "jaxtyping": None}
    monkeypatch.setattr(sys, "modules", {**fake})
    assert run.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", {**fake, "repro.core": None,
                                         "jax.numpy": None})
    assert run.forbidden_modules() == ["jax.numpy", "repro.core"]


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((ROOT / "perfbench" / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".", 1)[0] not in FORBIDDEN | {
                    "repro_torch"}, (path.name, m)
    got = _top_level_after(
        f"import json, sys; sys.path.insert(0, {str(ROOT)!r}); "
        "import perfbench.reference.collection, perfbench.reference.exact, "
        "perfbench.reference.workbytes, perfbench.reference.peaks; "
        "print(json.dumps({'top': sorted({m.split('.', 1)[0] "
        "for m in sys.modules})}))")
    assert not (FORBIDDEN | {"repro_torch"}) & set(got["top"])
