"""The tiny cells on the card, through the CUDA kernels: sound runs are
correct, the control is not, and a traced run reads the device trace.
Run on an H100 host with ``python -m pytest -q -m gpu perfbench/tests``;
skips without a card."""
from __future__ import annotations

import pytest

from perfbench import harness


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["tiny-flat", "tiny-knn"])
def test_tiny_cell_on_the_card(tiny_root, cuda_device, cell):
    c = harness.load_cell(cell, tiny_root)
    sound = harness.run_cell(c, 2**31 + 99, 0.5, False, device=cuda_device)
    assert sound["correct"] is True, sound["checks"]
    control = harness.run_cell(c, 2**31 + 99, 0.5, False, device=cuda_device,
                               control=True)
    assert control["correct"] is False, control["checks"]
    traced = harness.run_cell(c, 2**31 + 98, 0.5, True, device=cuda_device)
    assert traced["correct"] is True
    assert traced["device"]["busy_s"] > 0
    assert 0 < traced["metrics"]["gather_dot_cand_roofline"]["value"] <= 105
