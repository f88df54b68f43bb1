"""Port parity: the flat index builder (``repro_torch.core.build``)
against the JAX ``build_index`` on ``small_collection``.

* Integer planes (lists, blocks, summary coords and levels) are equal.
* Float planes are equal, except ``sum_scale`` / ``fwd_scale``: inside
  the jitted JAX build XLA divides by 254 as a multiply by its
  reciprocal, the port divides (as the JAX ``quantize_u8`` does when
  called alone), so those agree within 1 ulp (rtol 2e-7). The centroid
  summary sums with a scatter-add whose order differs: allclose 1e-6.
* Geometric blocking takes the JAX representatives (``rep_pos`` from
  ``jax.random.randint(fold_in(PRNGKey(seed), coord))``). Its assignment
  is an argmax over inner products the port sums in another order, so a
  list may differ only at a near-tie (top two products within 1e-6
  relative); such lists are reported and compared by search results.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import SeismicConfig as JConfig
from repro.core import build_index as jax_build
from repro.retrieval import SearchParams as JParams
from repro.retrieval import search_pipeline as jax_search
from repro_torch.core import build_index, live_blocks
from repro_torch.core.build import sample_rep_pos
from repro_torch.core.types import SeismicConfig
from repro_torch.retrieval import SearchParams, search_pipeline
from repro_torch.sparse.ops import PaddedSparse

BASE = dict(lam=128, beta=8, alpha=0.4, block_cap=32, summary_nnz=32)
INT_PLANES = ("list_docs", "list_len", "block_off", "block_len",
              "sum_coords", "sum_q")
ULP_PLANES = ("sum_scale", "fwd_scale")


def port_docs(docs_np) -> PaddedSparse:
    return PaddedSparse(torch.from_numpy(docs_np.coords),
                        torch.from_numpy(docs_np.vals), docs_np.dim)


def jax_rep_pos(jindex, cfg) -> torch.Tensor:
    key = jax.random.PRNGKey(cfg.seed)
    pos = jax.vmap(lambda i, c: jax.random.randint(
        jax.random.fold_in(key, i), (cfg.beta,), 0, jnp.maximum(c, 1)))(
        jnp.arange(jindex.n_lists), jindex.list_len)
    return torch.from_numpy(np.array(pos)).long()


def near_tie_lists(jindex, index, rep_pos, docs_np):
    """Lists whose arrays differ; each must be a near-tie assignment."""
    differ = np.zeros(jindex.n_lists, bool)
    for name in INT_PLANES:
        a = np.asarray(getattr(jindex, name))
        b = getattr(index, name).numpy()
        differ |= (a != b).reshape(a.shape[0], -1).any(axis=1)
    dense = np.zeros((docs_np.coords.shape[0], docs_np.dim))
    np.put_along_axis(dense, docs_np.coords, docs_np.vals, axis=1)
    ld = np.asarray(jindex.list_docs)
    for i in np.nonzero(differ)[0]:
        cnt = int(np.asarray(jindex.list_len)[i])
        members = dense[ld[i, :cnt]]
        reps = dense[ld[i, rep_pos[i].numpy().clip(0, max(cnt - 1, 0))]]
        ips = np.sort(members @ reps.T, axis=1)[:, ::-1]
        gap = (ips[:, 0] - ips[:, 1]) / np.maximum(np.abs(ips[:, 0]), 1e-30)
        assert gap.min() <= 1e-6, f"list {i} differs without a near-tie"
    return np.nonzero(differ)[0]


def assert_planes(jindex, index, skip_lists=()):
    keep = np.ones(jindex.n_lists, bool)
    keep[list(skip_lists)] = False
    for name in INT_PLANES + ("list_vals", "sum_zero"):
        a, b = np.asarray(getattr(jindex, name)), getattr(index, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b[keep], a[keep], err_msg=name)
    for name in ULP_PLANES:
        a = getattr(jindex, name)
        if a is None:
            assert getattr(index, name) is None
            continue
        a, b = np.asarray(a), getattr(index, name).numpy()
        if name == "sum_scale":
            a, b = a[keep], b[keep]
        np.testing.assert_allclose(b, a, rtol=2e-7, atol=0, err_msg=name)
    np.testing.assert_array_equal(
        index.fwd.coords.to(torch.int64).numpy(),
        np.asarray(jindex.fwd.coords).astype(np.int64))
    np.testing.assert_array_equal(
        index.fwd.vals.float().numpy(),
        np.asarray(jindex.fwd.vals).astype(np.float32))


@pytest.mark.parametrize("extra", [
    dict(blocking="fixed"),
    dict(blocking="fixed", fwd_quant=True),
    dict(blocking="fixed", fwd_dtype="bfloat16"),
])
def test_fixed_blocking_build_matches_reference(small_collection, extra):
    docs, _, docs_np, _, _ = small_collection
    jcfg = JConfig(**BASE, **extra)
    jindex = jax_build(docs, jcfg, list_chunk=16)
    index = build_index(port_docs(docs_np),
                        SeismicConfig(**dataclasses.asdict(jcfg)),
                        list_chunk=50)
    assert_planes(jindex, index)
    if jcfg.fwd_quant:
        assert index.fwd.coords.dtype == torch.uint16
        np.testing.assert_array_equal(index.fwd_zero.numpy(),
                                      np.asarray(jindex.fwd_zero))


def test_geometric_build_matches_reference(small_collection, small_index):
    docs, queries, docs_np, _, _ = small_collection
    jindex, jcfg = small_index
    rep_pos = jax_rep_pos(jindex, jcfg)
    timings = {}
    index = build_index(port_docs(docs_np),
                        SeismicConfig(**dataclasses.asdict(jcfg)),
                        list_chunk=37, rep_pos=rep_pos, timings=timings)
    assert set(timings) == {"postings", "prune", "assign", "blocks",
                            "summaries", "forward"}
    ties = near_tie_lists(jindex, index, rep_pos, docs_np)
    if len(ties):
        print(f"near-tie assignments in lists {ties.tolist()}")
    assert_planes(jindex, index, skip_lists=ties)
    np.testing.assert_array_equal(live_blocks(index).numpy(),
                                  (np.asarray(jindex.block_len) > 0).sum(-1))
    if len(ties):   # compare what search returns over the differing lists
        p = dict(k=10, cut=8, block_budget=8, policy="budget")
        want = jax_search(jindex, queries, JParams(**p))
        got = search_pipeline(index, PaddedSparse(
            torch.from_numpy(np.array(queries.coords)),
            torch.from_numpy(np.array(queries.vals)), queries.dim),
            SearchParams(use_kernel=False, fuse_level=0, **p))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-5, atol=1e-6)


def test_default_build_draws_the_jax_representatives(small_collection,
                                                    small_index):
    """Without ``rep_pos`` the port draws JAX's representatives itself
    (``sample_rep_pos``: fold_in per list), so the build gives JAX's
    integer planes, up to the near-tie lists that the test above allows."""
    _, _, docs_np, _, _ = small_collection
    jindex, jcfg = small_index
    rep_pos = jax_rep_pos(jindex, jcfg)
    counts = torch.from_numpy(np.array(jindex.list_len)).long()
    assert torch.equal(sample_rep_pos(counts, SeismicConfig(
        **dataclasses.asdict(jcfg))), rep_pos)
    some = torch.tensor([5, 0, 700])     # lists drawn alone: their rows
    assert torch.equal(sample_rep_pos(counts[some], SeismicConfig(
        **dataclasses.asdict(jcfg)), some), rep_pos[some])
    index = build_index(port_docs(docs_np),
                        SeismicConfig(**dataclasses.asdict(jcfg)),
                        list_chunk=37)
    ties = near_tie_lists(jindex, index, rep_pos, docs_np)
    assert_planes(jindex, index, skip_lists=ties)


def test_centroid_summaries_match_reference(small_collection):
    docs, _, docs_np, _, _ = small_collection
    jcfg = JConfig(**BASE, blocking="fixed", summary_kind="centroid")
    jindex = jax_build(docs, jcfg, list_chunk=16)
    index = build_index(port_docs(docs_np),
                        SeismicConfig(**dataclasses.asdict(jcfg)))
    for name in ("list_docs", "block_len", "sum_coords"):
        np.testing.assert_array_equal(getattr(index, name).numpy(),
                                      np.asarray(getattr(jindex, name)))
    want = np.asarray(jindex.sum_scale)[..., None] * (
        np.asarray(jindex.sum_q).astype(np.float32) - 1)
    got = index.sum_scale.numpy()[..., None] * (
        index.sum_q.numpy().astype(np.float32) - 1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_default_representatives_are_seeded(small_collection):
    _, _, docs_np, _, _ = small_collection
    cfg = SeismicConfig(**BASE)
    a = build_index(port_docs(docs_np), cfg)
    b = build_index(port_docs(docs_np), cfg)
    assert torch.equal(a.list_docs, b.list_docs)
    assert torch.equal(a.sum_coords, b.sum_coords)
    nbytes = a.nbytes()
    assert nbytes["total"] == sum(v for k, v in nbytes.items()
                                  if k != "total")
    assert a.sum_coords.shape == (docs_np.dim, cfg.n_blocks, 32)



def whole_sort_postings(docs: PaddedSparse, lam: int):
    """The postings phase as one stable sort of every posting (the int64
    key of ``_sorted_postings``), cut at ``lam`` a coordinate: the
    reference for the range-by-range phase."""
    nnz, d = docs.coords.shape[1], docs.dim
    v = docs.vals.reshape(-1).to(torch.float32)
    live = v > 0
    c = torch.where(live, docs.coords.reshape(-1).long(), d)
    low = torch.where(live, 0x7FFFFFFF - v.view(torch.int32).long(), 0)
    order = torch.sort((c << 32) | low, stable=True).indices
    counts = torch.bincount(c, minlength=d + 1)[:d]
    first = torch.cumsum(counts, 0) - counts
    keep = torch.cat([torch.arange(int(f), int(f) + min(int(n), lam))
                      for f, n in zip(first, counts)])
    kept = order[keep]
    return v[kept], (kept // nnz).to(torch.int32), counts


def tied_collection(n_docs: int, nnz: int, dim: int, seed: int):
    """Rows of ``nnz`` distinct coordinates (a few popular ones) whose
    values take 4 levels, so that ties of (coordinate, value) are common,
    and a padded tail (value 0, coordinate 0) in every fifth row."""
    g = torch.Generator().manual_seed(seed)
    w = torch.arange(1, dim + 1, dtype=torch.float64).pow(-1.1)
    coords = torch.multinomial(w.expand(n_docs, dim), nnz, generator=g)
    vals = (torch.randint(1, 5, (n_docs, nnz), generator=g) * 0.25).float()
    vals[::5, nnz // 2:] = 0.0
    coords[::5, nnz // 2:] = 0
    return PaddedSparse(coords.to(torch.int32), vals, dim)


def test_postings_by_range_equal_one_whole_sort(monkeypatch):
    """Forced into many coordinate ranges (and position chunks), the
    postings phase keeps each coordinate's top lam in the order one
    stable sort of every posting gives, ties by position, bitwise, on
    passages of an odd width with ties and padding; and the index built
    from it equals, plane by plane, the index built in one range."""
    from repro_torch.core import build
    docs = tied_collection(1000, 45, 500, seed=45)
    cfg = SeismicConfig(**BASE, blocking="fixed")
    whole = build_index(docs, cfg, list_chunk=100)
    want_v, want_d, want_counts = whole_sort_postings(docs, cfg.lam)
    monkeypatch.setattr(build, "POSTINGS_BUDGET", 997)
    monkeypatch.setattr(build, "_POSITION_CHUNK", 4099)
    got_v, got_d, starts, counts = build._sorted_postings(docs, cfg.lam)
    assert torch.equal(counts, want_counts)
    assert int(counts.max()) > cfg.lam           # lists that are cut
    assert torch.equal(starts, torch.cumsum(counts.clamp(max=cfg.lam), 0)
                       - counts.clamp(max=cfg.lam))
    assert torch.equal(got_v, want_v) and torch.equal(got_d, want_d)
    ranged = build_index(docs, cfg, list_chunk=100)
    for name in INT_PLANES + ULP_PLANES + ("list_vals", "sum_zero"):
        a, b = getattr(whole, name), getattr(ranged, name)
        assert (a is None and b is None) or torch.equal(a, b), name
    assert torch.equal(whole.fwd.vals, ranged.fwd.vals)


def test_odd_passage_width_build_matches_reference():
    """Passages 45 wide (not a multiple of any vector width), as the
    E-SPLADE deployment's 181: the build equals the JAX builder's plane
    by plane under fixed blocking, in many coordinate ranges."""
    from repro.data import SyntheticSparseConfig, make_collection
    from repro.sparse.ops import PaddedSparse as JPadded
    from repro_torch.core import build
    docs_np, _, _ = make_collection(SyntheticSparseConfig(
        dim=1024, n_docs=1024, n_queries=4, doc_nnz=45, query_nnz=6,
        n_topics=32, topic_coords=128, seed=11))
    jcfg = JConfig(**BASE, blocking="fixed", fwd_dtype="bfloat16")
    jindex = jax_build(JPadded(jnp.asarray(docs_np.coords),
                               jnp.asarray(docs_np.vals), docs_np.dim),
                       jcfg, list_chunk=16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(build, "POSTINGS_BUDGET", 3000)
        index = build_index(port_docs(docs_np),
                            SeismicConfig(**dataclasses.asdict(jcfg)),
                            list_chunk=50)
    assert index.fwd.coords.shape[1] == 45
    assert_planes(jindex, index)
