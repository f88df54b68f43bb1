"""Fixtures of the benchmark's CPU tests, and the ``gpu`` marker for
tests that need the card."""
from __future__ import annotations

import pytest
from tiny_cells import make_tiny_root


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on an H100 host)")
    return "cuda"
