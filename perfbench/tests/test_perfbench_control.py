"""The check refuses the control and each fault a cell can have.

The control is the program's own lower-precision path (the
configuration's ``control``: the forward index in u8 instead of
bfloat16). The faults (``perfbench/faults/``) break the timed path
underneath the harness: half of each batch left out (its answers those
of the other half), an answer altered where it is produced, half the
block budget handed on by the router and selector, the merge keeping the
k lowest of the evaluated documents, and (kNN) the refine step returning
its state unchanged. Each run skips the look for a chip and drives the
rest of a run on the CPU at a tiny size."""
from __future__ import annotations

import pytest

from perfbench import harness


@pytest.mark.parametrize("cell", ["tiny-flat", "tiny-knn"])
def test_sound_run_is_correct_and_the_control_is_not(tiny_root, cell):
    c = harness.load_cell(cell, tiny_root)
    sound = harness.run_cell(c, 11, 0.2, False, device="cpu")
    assert sound["correct"] is True
    gap = sound["checks"]["score_gap"]
    assert gap["value"] < gap["limit"] / 100
    control = harness.run_cell(c, 11, 0.2, False, device="cpu",
                               control=True)
    assert control["correct"] is False
    assert control["checks"]["score_gap"]["value"] > 10 * gap["limit"]
    assert control["failed"] > 0


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered"])
def test_a_broken_timed_path_is_not_correct(tiny_root, fault):
    c = harness.load_cell("tiny-flat", tiny_root)
    line = harness.run_cell(c, 12, 0.2, False, device="cpu", fault=fault)
    assert line["correct"] is False
    assert line["failed"] > 0


@pytest.mark.parametrize("cell,fault", [
    ("tiny-flat", "half_budget"), ("tiny-flat", "merge_lowest"),
    ("tiny-knn", "refine_skipped"), ("tiny-knn", "merge_lowest")])
def test_a_route_that_loses_documents_fails_the_recall_floor(tiny_root, cell,
                                                             fault):
    """Every id and score of these answers matches its document; only the
    recall floor sees that the route, merge or refine chose wrongly."""
    c = harness.load_cell(cell, tiny_root)
    line = harness.run_cell(c, 13, 0.1, False, device="cpu", fault=fault)
    checks = line["checks"]
    assert line["correct"] is False
    assert not harness.passes(checks["recall_at_k"])
    assert harness.passes(checks["bad_rows"])
    assert harness.passes(checks["score_gap"])


def test_a_traced_run_checks_the_recall_floor_too(tiny_root):
    c = harness.load_cell("tiny-knn", tiny_root)
    c.config["limits"]["recall_at_k"]["min"] = 0.999
    line = harness.run_cell(c, 14, 0.2, True, device="cpu")
    assert line["checks"]["recall_at_k"]["value"] < 0.999
    assert line["correct"] is False
