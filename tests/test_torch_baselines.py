"""Port parity: the paper's baselines (``repro_torch.core.baselines``), the
host oracles (``core.oracle.algorithm2``, ``core.graph_baseline``), the
rest of ``sparse.ops`` and ``prng.permutation`` / ``choice``, against the
JAX package on the same seeded inputs.

Tolerances:
* ``prng``: bit for bit; ``densify_one`` equal; ``inner_product_padded``
  and ``l1_mass_fraction`` ``allclose(rtol=1e-6)`` (float32 sums in
  another order);
* ``algorithm2`` and ``IPNSWIndex``: equal (the same numpy code on the
  same arrays);
* ``exact_search``, ``ivf_search``, ``impact_search``: ids equal except
  where the score at that position is not isolated (a neighbour within
  ``rtol=1e-5``), scores ``allclose(rtol=1e-5, atol=1e-6)``;
* ``build_ivf``: the initial ids equal; each final assignment equal
  unless the document's two best centroids lie within a relative gap of
  ``1e-5`` (the inner products are summed in another order); centroids
  ``allclose(rtol=1e-5, atol=1e-6)``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import SeismicConfig as JConfig
from repro.core import baselines as jbase
from repro.core import build_index as jax_build_index
from repro.core import graph_baseline as jgraph
from repro.core import oracle as joracle
from repro.data import SyntheticSparseConfig, make_collection
from repro.sparse import ops as jops
from repro.sparse.ops import PaddedSparse as JPadded
from repro_torch import prng
from repro_torch.core import baselines as pbase
from repro_torch.core import graph_baseline as pgraph
from repro_torch.core import oracle as poracle
from repro_torch.sparse import ops as pops
from repro_torch.sparse.ops import PaddedSparse
from test_torch_pipeline import carry

RTOL, ATOL = 1e-5, 1e-6
GAP = 1e-5
CFG = SyntheticSparseConfig(dim=1024, n_docs=2048, n_queries=16, doc_nnz=48,
                            query_nnz=16, n_topics=32, topic_coords=128,
                            seed=7)


@pytest.fixture(scope="module")
def data():
    docs, queries, _ = make_collection(CFG)
    arrs = tuple(np.array(a) for a in (docs.coords, docs.vals,
                                       queries.coords, queries.vals))
    jd = JPadded(jnp.asarray(arrs[0]), jnp.asarray(arrs[1]), CFG.dim)
    jq = JPadded(jnp.asarray(arrs[2]), jnp.asarray(arrs[3]), CFG.dim)
    pd = PaddedSparse(torch.from_numpy(arrs[0]), torch.from_numpy(arrs[1]),
                      CFG.dim)
    pq = PaddedSparse(torch.from_numpy(arrs[2]), torch.from_numpy(arrs[3]),
                      CFG.dim)
    return arrs, jd, jq, pd, pq


def exact_ip(arrs, q: int, ids: np.ndarray) -> np.ndarray:
    dc, dv, qc, qv = arrs
    dense = np.zeros(CFG.dim)
    np.add.at(dense, qc[q], qv[q].astype(np.float64))
    return np.array([(dense[dc[i]] * dv[i]).sum() if i >= 0 else -np.inf
                     for i in ids])


def assert_ids_except_ties(arrs, ids, want_ids, scores, want_scores):
    """ids equal except where the exact score at that position has a
    neighbour within RTOL (a tie the two summation orders may break
    either way)."""
    scores, want_scores = np.asarray(scores), np.asarray(want_scores)
    fin = np.isfinite(want_scores)
    np.testing.assert_array_equal(np.isfinite(scores), fin)
    np.testing.assert_allclose(scores[fin], want_scores[fin], rtol=RTOL,
                               atol=ATOL)
    ids, want_ids = np.asarray(ids), np.asarray(want_ids)
    for q in range(ids.shape[0]):
        if np.array_equal(ids[q], want_ids[q]):
            continue
        ex = exact_ip(arrs, q, want_ids[q])
        for j in np.nonzero(ids[q] != want_ids[q])[0]:
            near = np.abs(ex - ex[j]) <= RTOL * np.abs(ex[j])
            assert near.sum() > 1, (q, j, ids[q], want_ids[q])


# ---------------------------------------------------------- sparse ops

def test_sparse_ops_match_reference():
    rng = np.random.default_rng(0)
    c = rng.integers(0, 300, (40, 24)).astype(np.int32)
    v = rng.uniform(0, 3, (40, 24)).astype(np.float32)
    v[:, -5:] = 0.0
    v[7] = 0.0                                    # an all-zero row
    c[3, :4] = 17                                 # repeated coordinates
    for i in (0, 3, 7):
        np.testing.assert_array_equal(
            pops.densify_one(torch.from_numpy(c[i]), torch.from_numpy(v[i]),
                             300).numpy(),
            np.asarray(jops.densify_one(jnp.asarray(c[i]),
                                        jnp.asarray(v[i]), 300)))
    q = rng.uniform(0, 1, 300).astype(np.float32)
    np.testing.assert_allclose(
        pops.inner_product_padded(torch.from_numpy(q), torch.from_numpy(c),
                                  torch.from_numpy(v)).numpy(),
        np.asarray(jops.inner_product_padded(jnp.asarray(q), jnp.asarray(c),
                                             jnp.asarray(v))), rtol=1e-6)
    for top in (1, 5, 30):
        got = pops.l1_mass_fraction(v, top).numpy()
        want = jops.l1_mass_fraction(v, top)
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------- prng

@pytest.mark.parametrize("n", [10, 1625, 1626, 1 << 20])
def test_permutation_and_choice_bit_for_bit(n):
    """One shuffle round up to n = 1,625, two from 1,626 (JAX's
    ceil(3 ln n / ln(2^32 - 1))); keys compared as unsigned words."""
    for seed in (0, 5):
        jk = jax.random.PRNGKey(seed)
        pk = prng.key(seed)
        np.testing.assert_array_equal(
            prng.permutation(pk, n).numpy(),
            np.asarray(jax.random.permutation(jk, n)))
        m = min(n, 4096)
        np.testing.assert_array_equal(
            prng.choice(pk, n, (m,), replace=False).numpy(),
            np.asarray(jax.random.choice(jk, n, (m,), replace=False)))
        np.testing.assert_array_equal(
            prng.choice(pk, n, (3, 5)).numpy(),
            np.asarray(jax.random.choice(jk, n, (3, 5))))
    with pytest.raises(ValueError):
        prng.choice(prng.key(0), 4, (5,), replace=False)


# ------------------------------------------------------------- oracles

@pytest.mark.parametrize("fwd_dtype", ["float32", "bfloat16"])
def test_algorithm2_matches_reference(data, fwd_dtype):
    arrs, jd, *_ = data
    jidx = jax_build_index(jd, JConfig(lam=128, beta=8, alpha=0.4,
                                       block_cap=32, summary_nnz=32,
                                       fwd_dtype=fwd_dtype), list_chunk=16)
    jview = joracle.NumpyIndexView(jidx)
    pview = poracle.NumpyIndexView(carry(jidx))
    np.testing.assert_array_equal(pview.fwd_vals, jview.fwd_vals)
    assert pview.fwd_vals.dtype == np.float64
    qc, qv = arrs[2], arrs[3]
    for q in range(6):
        for cut, hf in ((4, 0.9), (8, 1.0)):
            js, ji, jst = joracle.algorithm2(jview, qc[q], qv[q], 10, cut, hf)
            ps, pi, pst = poracle.algorithm2(pview, qc[q], qv[q], 10, cut, hf)
            np.testing.assert_array_equal(pi, ji)
            np.testing.assert_array_equal(ps, js)
            assert pst == jst


def test_algorithm2_widens_u16_coordinates(data):
    """A quantized forward plane (u16 coordinates, u8 values): the view
    widens the coordinates and dequantizes the values."""
    _, jd, *_ = data
    jidx = jax_build_index(jd, JConfig(lam=128, beta=8, alpha=0.4,
                                       block_cap=32, summary_nnz=32,
                                       fwd_quant=True), list_chunk=16)
    index = carry(jidx)
    assert index.fwd.coords.dtype == torch.uint16
    view = poracle.NumpyIndexView(index)
    assert view.fwd_coords.dtype == np.int64
    np.testing.assert_array_equal(view.fwd_coords,
                                  np.asarray(jidx.fwd.coords).astype(np.int64))
    scale = np.asarray(jidx.fwd_scale, np.float32)[:, None]
    zero = np.asarray(jidx.fwd_zero, np.float32)[:, None]
    u8 = np.asarray(jidx.fwd.vals)
    want = np.where(u8 > 0, (u8.astype(np.float32) - 1.0) * scale + zero, 0.0)
    np.testing.assert_array_equal(view.fwd_vals, want.astype(np.float64))


def test_ipnsw_graph_baseline_matches_reference(data):
    arrs = data[0]
    dc, dv = arrs[0][:400], arrs[1][:400]
    j = jgraph.IPNSWIndex(dc, dv, CFG.dim, m=8, chunk=128)
    p = pgraph.IPNSWIndex(dc, dv, CFG.dim, m=8, chunk=128)
    assert p.entries == j.entries
    assert all(np.array_equal(a, b) for a, b in zip(p.adj, j.adj))
    for q in range(4):
        for ef in (16, 64):
            js, ji, je = j.search(arrs[2][q], arrs[3][q], 10, ef)
            ps, pi, pe = p.search(arrs[2][q], arrs[3][q], 10, ef)
            np.testing.assert_array_equal(pi, ji)
            np.testing.assert_array_equal(ps, js)
            assert pe == je


# ----------------------------------------------------------- baselines

def test_exact_search_matches_reference(data):
    arrs, jd, jq, pd, pq = data
    js, ji = jbase.exact_search(jd, jq, 10)
    for chunk in (None, 300):
        ps, pi = pbase.exact_search(pd, pq, 10, doc_chunk=chunk)
        assert pi.dtype == torch.int32
        assert_ids_except_ties(arrs, pi.numpy(), ji, ps.numpy(), js)


@pytest.fixture(scope="module")
def ivf(data):
    arrs, jd, jq, pd, pq = data
    return (jbase.build_ivf(jd, 64, 64, 3, 0),
            pbase.build_ivf(pd, 64, 64, 3, 0, chunk=500))


def test_ivf_init_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is cuda there")
    with pytest.raises(RuntimeError, match="CUDA"):
        pbase.ivf_init(CFG.n_docs, 64, 0)


def test_build_ivf_matches_reference(data, ivf):
    arrs, jd, jq, pd, pq = data
    jv, pv = ivf
    np.testing.assert_array_equal(
        pbase.ivf_init(CFG.n_docs, 64, 0, device="cpu").numpy(),
        np.asarray(jax.random.choice(jax.random.PRNGKey(0), CFG.n_docs,
                                     (64,), replace=False)))
    np.testing.assert_allclose(pv.centroids.numpy(),
                               np.asarray(jv.centroids), rtol=RTOL, atol=ATOL)

    def assignment(member, length):
        a = np.full(CFG.n_docs, -1)
        for c in range(member.shape[0]):
            a[member[c, :min(length[c], 64)]] = c
        return a
    got = assignment(pv.member_docs.numpy(), pv.member_len.numpy())
    want = assignment(np.asarray(jv.member_docs), np.asarray(jv.member_len))
    # the final assignment is made against the centroids of two steps
    prev = np.asarray(jbase.build_ivf(jd, 64, 64, 2, 0).centroids, np.float64)
    dense = np.zeros((CFG.n_docs, CFG.dim))
    np.add.at(dense, (np.arange(CFG.n_docs)[:, None], arrs[0]), arrs[1])
    for i in np.nonzero(got != want)[0]:
        ips = np.sort(dense[i] @ prev.T)[::-1]
        assert ips[0] - ips[1] <= GAP * abs(ips[0]), i
    np.testing.assert_array_equal(pv.member_len.numpy(),
                                  np.asarray(jv.member_len))
    assert pv.member_docs.dtype == torch.int32


@pytest.mark.parametrize("nprobe", [1, 4, 16])
def test_ivf_search_matches_reference(data, ivf, nprobe):
    arrs, jd, jq, pd, pq = data
    jv, pv = ivf
    js, ji, je = jbase.ivf_search(jv, jq, 10, nprobe)
    ps, pi, pe = pbase.ivf_search(pv, pq, 10, nprobe, query_chunk=5)
    assert_ids_except_ties(arrs, pi.numpy(), ji, ps.numpy(), js)
    np.testing.assert_array_equal(pe.numpy(), np.asarray(je))


@pytest.mark.parametrize("postings", [4, 32, 128, 1000])
def test_impact_search_matches_reference(data, small_index, postings):
    """On the same index's lists; each list is one scatter in the
    reference's update order, so the accumulators (and scores) agree."""
    arrs, jd, jq, pd, pq = data
    jidx = small_index[0]
    index = carry(jidx)
    js, ji = jbase.impact_search(jidx.list_docs, jidx.list_vals,
                                 jidx.list_len, jidx.n_docs, jq, 10,
                                 postings)
    ps, pi = pbase.impact_search(index.list_docs, index.list_vals,
                                 index.list_len, index.n_docs, pq, 10,
                                 postings, query_chunk=6)
    assert_ids_except_ties(arrs, pi.numpy(), ji, ps.numpy(), js)


def test_top_k_wide_keeps_lax_order():
    """Many exact ties in wide rows: the lowest indices first, as
    ``lax.top_k`` and the stable sort give."""
    g = torch.Generator().manual_seed(0)
    x = torch.randint(0, 4, (5, 20000), generator=g).float()
    x[1] = 0.0
    for k in (1, 10, 37):
        got = pbase.top_k_wide(x, k)
        want = pops.top_k(x, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
