"""Shared fixtures. NOTE: no XLA_FLAGS device-count forcing here —
smoke tests must see the single real CPU device; multi-device tests
spawn subprocesses (tests/helpers.py)."""
import numpy as np
import pytest

import jax.numpy as jnp

try:
    # deterministic-seed profile: hypothesis example generation derives
    # from the test body, never from entropy or a shared DB, so the
    # tuner property suites (and every other property test) can't flake
    # across CI runs or machines
    from hypothesis import settings as _hyp_settings
    _hyp_settings.register_profile("deterministic", derandomize=True,
                                   deadline=None, database=None)
    _hyp_settings.load_profile("deterministic")
except ImportError:          # property suites skip cleanly when absent
    pass

from repro.data import SyntheticSparseConfig, make_collection
from repro.sparse.ops import PaddedSparse


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture(scope="session")
def small_collection():
    cfg = SyntheticSparseConfig(dim=1024, n_docs=2048, n_queries=16,
                                doc_nnz=48, query_nnz=16, n_topics=32,
                                topic_coords=128, seed=7)
    docs_np, queries_np, meta = make_collection(cfg)
    docs = PaddedSparse(jnp.asarray(docs_np.coords),
                        jnp.asarray(docs_np.vals), docs_np.dim)
    queries = PaddedSparse(jnp.asarray(queries_np.coords),
                           jnp.asarray(queries_np.vals), queries_np.dim)
    return docs, queries, docs_np, queries_np, cfg


@pytest.fixture(scope="session")
def small_index(small_collection):
    from repro.core import SeismicConfig, build_index
    docs, *_ = small_collection
    cfg = SeismicConfig(lam=128, beta=8, alpha=0.4, block_cap=32,
                        summary_nnz=32)
    return build_index(docs, cfg, list_chunk=16), cfg
