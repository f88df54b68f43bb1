"""Port parity: kNN-graph refinement (``repro_torch.graph``: the graph
build, ``refine_batch`` and its rounds, the fused ``refine_round``
round) against the JAX package, on ``small_index`` with a JAX-built
graph carried across by ``index_from_arrays``.

Tolerances are those of ``tests/test_torch_pipeline.py``: integer outputs
(frontier ids, ``docs_evaluated``) are equal, scores
``allclose(rtol=1e-5, atol=1e-6)``, top-k ids may differ only at
non-isolated scores.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.graph import build_doc_graph as jax_build_graph
from repro.graph import compact_forward_index as jax_compact
from repro.graph import doc_queries as jax_doc_queries
from repro.graph.build import _drop_self as jax_drop_self
from repro.retrieval import SearchParams as JParams
from repro.retrieval import search_pipeline as jax_search
from repro.retrieval.pipeline import stage_fns as jax_stage_fns
from repro_torch.core.oracle import exact_topk, mean_recall_at_k
from repro_torch.graph import (build_doc_graph, compact_forward_index,
                               doc_queries, expand_neighbors)
from repro_torch.graph.build import _drop_self
from repro_torch.graph.refine import scored_init
from repro_torch.retrieval import (SearchParams, run_pipeline_staged,
                                   search_pipeline, stage_fns)
from repro_torch.serve import SeismicServer
from repro_torch.sparse.ops import PaddedSparse
from test_torch_pipeline import assert_topk, carry, port_queries

DEGREE = 4
QUERY = dict(k=10, cut=8, block_budget=4, policy="budget")
GRAPH_PARAMS = dict(k=DEGREE + 1, cut=8, block_budget=16, policy="budget")


@pytest.fixture(scope="module")
def graphs(small_index):
    """plane -> (JAX index with a JAX-built graph, the same carried to the
    port), for the f32 forward plane and its compact (u8 + u16) form."""
    jindex = jax_build_graph(small_index[0], degree=DEGREE, batch=512,
                             build_params=JParams(**GRAPH_PARAMS))
    out = {}
    for plane, j in (("f32", jindex), ("compact", jax_compact(jindex))):
        out[plane] = (j, carry(j))
    return out


def _refined(**kw):
    return dict(QUERY, graph_degree=DEGREE, **kw)


@pytest.mark.parametrize("fuse_level", [0, 1, 2])
@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("plane", ["f32", "compact"])
def test_refined_search_matches_reference(small_collection, graphs, plane,
                                          rounds, fuse_level):
    _, queries, *_ = small_collection
    jindex, index = graphs[plane]
    assert index.knn_ids.dtype == torch.int32
    assert index.knn_ids.shape == (index.n_docs, DEGREE)
    want = [np.asarray(x) for x in jax_search(
        jindex, queries, JParams(**_refined(refine_rounds=rounds)))]
    p = SearchParams(use_kernel=True, fuse_level=fuse_level,
                     **_refined(refine_rounds=rounds))
    s, i, e = search_pipeline(index, port_queries(queries), p)
    assert_topk(i.numpy(), s.numpy(), want[1], want[0])
    np.testing.assert_array_equal(e.numpy(), want[2])


@pytest.mark.parametrize("fuse_level", [0, 1, 2])
@pytest.mark.parametrize("plane", ["f32", "compact"])
def test_refine_round_frontier_matches_reference(small_collection, graphs,
                                                 plane, fuse_level):
    """Two rounds stage by stage from the JAX merge: each round's
    frontier (what it appends to the seen set) is equal, its re-merged
    top-k matches."""
    _, queries, *_ = small_collection
    jindex, index = graphs[plane]
    jp = JParams(**_refined(refine_rounds=2))
    jf = jax_stage_fns(jindex, jp)
    qd, lists, _ = jf["prep"](queries.coords, queries.vals)
    b = jf["router"](qd, lists)
    js, ji, je = jf["merge"](*jf["scorer"](b, jf["selector"](b)))
    jscored = jnp.where(ji >= 0, ji, jindex.n_docs)
    fns = stage_fns(index, SearchParams(fuse_level=fuse_level,
                                        **_refined(refine_rounds=2)))
    pq = port_queries(queries)
    pqd = fns["prep"](pq.coords, pq.vals)[0]
    t = torch.from_numpy
    s, i, e = t(np.array(js)), t(np.array(ji)), t(np.array(je))
    scored = scored_init(i, index.n_docs)
    for _ in range(2):
        js, ji, je, jscored = jf["refine_round"](qd, js, ji, je, jscored)
        s, i, e, scored = fns["refine_round"](pqd, s, i, e, scored)
        frontier = np.asarray(jscored)
        if fuse_level >= 1:     # compacted: each round's ids sorted
            rounds = frontier[:, 10:].reshape(frontier.shape[0], -1,
                                              10 * DEGREE)
            frontier = np.concatenate(
                [frontier[:, :10], np.sort(rounds, axis=2).reshape(
                    frontier.shape[0], -1)], axis=1)
        np.testing.assert_array_equal(scored.numpy(), frontier)
        assert_topk(i.numpy(), s.numpy(), np.asarray(ji), np.asarray(js))
        np.testing.assert_array_equal(e.numpy(), np.asarray(je))


def test_expand_neighbors_matches_reference(graphs):
    from repro.graph import expand_neighbors as jax_expand
    jindex, index = graphs["f32"]
    ids = np.array([[0, 5, -1, 2047], [-1, -1, -1, -1], [7, 7, 3, 1]],
                   np.int32)
    for degree in (1, DEGREE):
        got = expand_neighbors(index, torch.from_numpy(ids), degree)
        want = np.asarray(jax_expand(jindex, jnp.asarray(ids), degree))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("compact", [False, True])
def test_port_graph_build_matches_reference(small_collection, small_index,
                                            graphs, compact):
    """The port's own ``build_doc_graph`` over the carried index: the
    corpus search agrees with JAX's under the tie rule, and the graph is
    equal on every row whose search ids are equal."""
    jindex = small_index[0]
    index = carry(jindex)
    jp, p = JParams(**GRAPH_PARAMS), SearchParams(**GRAPH_PARAMS)
    want_graph = (jax_build_graph(jindex, degree=DEGREE, batch=512,
                                  build_params=jp, compact_forward=True)
                  if compact else graphs["f32"][0])
    got_graph = build_doc_graph(index, degree=DEGREE, batch=700,
                                build_params=p, compact_forward=compact)
    assert got_graph.knn_ids.dtype == torch.int32
    src_j = jax_compact(jindex) if compact else jindex
    src_p = compact_forward_index(index) if compact else index
    js, ji, _ = jax_search(src_j, jax_doc_queries(src_j), jp)
    ps, pi, _ = search_pipeline(src_p, doc_queries(src_p), p)
    assert_topk(pi.numpy(), ps.numpy(), np.asarray(ji), np.asarray(js))
    same = (pi.numpy() == np.asarray(ji)).all(axis=1)
    assert same.mean() > 0.9
    np.testing.assert_array_equal(got_graph.knn_ids.numpy()[same],
                                  np.asarray(want_graph.knn_ids)[same])
    assert (got_graph.knn_ids.numpy()
            != np.arange(index.n_docs)[:, None]).all()


def test_compact_forward_index_matches_reference(graphs):
    jindex, index = graphs["f32"]
    got, want = compact_forward_index(index), jax_compact(jindex)
    assert got.fwd.coords.dtype == torch.uint16 and got.config.fwd_quant
    np.testing.assert_array_equal(got.fwd.coords.to(torch.int64).numpy(),
                                  np.asarray(want.fwd.coords).astype(np.int64))
    np.testing.assert_array_equal(got.fwd.vals.numpy(),
                                  np.asarray(want.fwd.vals))
    for name in ("fwd_scale", "fwd_zero"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert compact_forward_index(got) is got
    q, jq = doc_queries(got), jax_doc_queries(want)
    assert q.coords.dtype == torch.int32
    np.testing.assert_array_equal(q.coords.numpy(), np.asarray(jq.coords))
    np.testing.assert_array_equal(q.vals.numpy(), np.asarray(jq.vals))


@pytest.mark.parametrize("start,degree", [(0, 3), (17, 4), (5, 1)])
def test_drop_self_matches_reference(start, degree):
    rng = np.random.default_rng(start)
    ids = rng.integers(-1, 40, (12, 5)).astype(np.int32)
    ids[3, :] = start + 3                    # only self matches
    ids[4, 0] = start + 4
    got = _drop_self(torch.from_numpy(ids), start, degree, 40)
    np.testing.assert_array_equal(got.numpy(),
                                  jax_drop_self(ids, start, degree, 40))


@pytest.mark.parametrize("kw", [dict(graph_degree=0, refine_rounds=2),
                                dict(graph_degree=DEGREE, refine_rounds=0)])
def test_refine_off_is_the_identity(small_collection, graphs, kw):
    _, queries, *_ = small_collection
    index = graphs["f32"][1]
    plain = search_pipeline(index, port_queries(queries),
                            SearchParams(**QUERY))
    off = search_pipeline(index, port_queries(queries),
                          SearchParams(**{**QUERY, **kw}))
    for x, y in zip(plain, off):
        assert torch.equal(x, y)


@pytest.mark.parametrize("fuse_level", [0, 1, 2])
def test_recall_does_not_fall_with_rounds(small_collection, graphs,
                                          fuse_level):
    _, queries, docs_np, queries_np, _ = small_collection
    index = graphs["f32"][1]
    _, exact = exact_topk(torch.from_numpy(docs_np.coords),
                          torch.from_numpy(docs_np.vals), docs_np.dim,
                          torch.from_numpy(queries_np.coords),
                          torch.from_numpy(queries_np.vals), 10)
    recalls, evs = [], []
    for rounds in (0, 1, 2, 3):
        p = SearchParams(fuse_level=fuse_level,
                         **_refined(refine_rounds=rounds, block_budget=2))
        _, i, e = search_pipeline(index, port_queries(queries), p)
        recalls.append(mean_recall_at_k(i, exact))
        evs.append(e)
    assert recalls == sorted(recalls) and recalls[-1] > recalls[0]
    for a, b in zip(evs, evs[1:]):
        assert bool((b >= a).all())


def test_refine_fuse_levels_equal(small_collection, graphs):
    _, queries, *_ = small_collection
    for plane in ("f32", "compact"):
        index = graphs[plane][1]
        outs = [search_pipeline(index, port_queries(queries),
                                SearchParams(fuse_level=lvl,
                                             **_refined(refine_rounds=2)))
                for lvl in (0, 1, 2)]
        for other in outs[1:]:
            for x, y in zip(outs[0], other):
                assert torch.equal(x, y)


def test_refined_top_k_has_no_duplicates(small_collection, graphs):
    _, queries, *_ = small_collection
    _, i, _ = search_pipeline(graphs["f32"][1], port_queries(queries),
                              SearchParams(fuse_level=2,
                                           **_refined(refine_rounds=3)))
    for row in i.numpy():
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)


def test_validation_errors(small_collection, small_index, graphs):
    _, queries, *_ = small_collection
    pq = port_queries(queries)
    bare = carry(small_index[0])
    p = SearchParams(**_refined(refine_rounds=1))
    with pytest.raises(ValueError, match="no kNN graph"):
        search_pipeline(bare, pq, p)
    with pytest.raises(ValueError, match="no kNN graph"):
        SeismicServer(bare, p)
    with pytest.raises(ValueError, match="exceeds the built graph"):
        search_pipeline(graphs["f32"][1], pq,
                        dataclasses.replace(p, graph_degree=DEGREE + 1))
    with pytest.raises(ValueError, match="degree must be positive"):
        build_doc_graph(bare, degree=0)
    with pytest.raises(ValueError, match="cannot yield"):
        build_doc_graph(bare, degree=DEGREE,
                        build_params=SearchParams(k=DEGREE))


@pytest.mark.parametrize("bad", [dict(graph_degree=DEGREE + 1),
                                 dict(superblock_fanout=2)])
def test_params_that_do_not_fit_raise_before_routing(
        small_collection, graphs, monkeypatch, bad):
    """``search_pipeline`` validates before the first stage: the router
    (the first kernel launch) never runs."""
    import repro_torch.retrieval.pipeline as pipeline
    _, queries, *_ = small_collection

    def no_route(*args, **kwargs):
        raise AssertionError("the router ran before validation")

    monkeypatch.setattr(pipeline, "route_batch", no_route)
    p = SearchParams(**{**_refined(refine_rounds=1), **bad})
    with pytest.raises(ValueError):
        search_pipeline(graphs["f32"][1], port_queries(queries), p)


def test_split_refine_reports_round_spans(small_collection, graphs):
    _, queries, *_ = small_collection
    index = graphs["compact"][1]
    p = SearchParams(fuse_level=2, **_refined(refine_rounds=2))
    pq = port_queries(queries)
    spans, times = [], {}
    got = run_pipeline_staged(index, pq.coords, pq.vals, p,
                              record=times.__setitem__,
                              span_cb=lambda n, t0, t1: spans.append(
                                  (n, t0, t1)),
                              split_refine=True)
    names = [n for n, _, _ in spans]
    assert names == ["prep", "router", "selector", "scorer", "merge",
                     "refine_round_0", "refine_round_1", "refine"]
    refine = spans[-1]
    for _, t0, t1 in spans[5:7]:
        assert refine[1] <= t0 <= t1 <= refine[2]
    assert set(times) == set(names)
    whole = run_pipeline_staged(index, pq.coords, pq.vals, p,
                                span_cb=lambda n, t0, t1: spans.append(n))
    want = search_pipeline(index, pq, p)
    for x, y, z in zip(got, whole, want):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert "refine_round_0" not in spans[8:]


def test_server_matches_refined_pipeline(small_collection, graphs):
    _, queries, *_ = small_collection
    index = graphs["compact"][1]
    p = SearchParams(fuse_level=2, **_refined(refine_rounds=2))
    pq = port_queries(queries)
    got = SeismicServer(index, p, max_batch=6).search(pq)
    s, i, e = search_pipeline(index, pq, p)
    assert torch.equal(got.ids, i) and torch.equal(got.scores, s)
    assert torch.equal(got.docs_evaluated, e)
    assert isinstance(pq, PaddedSparse)


def test_refined_search_past_the_warp_route_matches_reference(
        small_collection, small_index):
    """k 100 x graph_degree 8 (800 candidates a query: on the card the
    block route of ``refine_round``) at fuse level 2, two rounds, on a
    degree-8 graph the JAX package builds: the module's parity rule
    against the JAX pipeline (``docs_evaluated`` equal)."""
    _, queries, *_ = small_collection
    params = dict(k=100, cut=8, block_budget=8, policy="budget",
                  graph_degree=8, refine_rounds=2)
    jindex = jax_build_graph(small_index[0], degree=8, batch=512,
                             build_params=JParams(**dict(GRAPH_PARAMS, k=9)))
    want = [np.asarray(x) for x in jax_search(jindex, queries,
                                              JParams(**params))]
    s, i, e = search_pipeline(carry(jindex), port_queries(queries),
                              SearchParams(use_kernel=True, fuse_level=2,
                                           **params))
    assert i.shape == (queries.coords.shape[0], 100)
    assert (want[1] >= 0).sum() > 10 * queries.coords.shape[0]
    assert_topk(i.numpy(), s.numpy(), want[1], want[0])
    np.testing.assert_array_equal(e.numpy(), want[2])
