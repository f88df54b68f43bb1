"""Port parity: the superblock tier and the hierarchical route
(``repro_torch.core.build._superblock_summaries``, ``suggest_fanout``,
``retrieval.router._route_hierarchical``, the fused ``router_hier``
route) against the JAX package, on ``small_collection`` built with
``superblock_fanout`` 2 and 4.

Tolerances are those of ``tests/test_torch_pipeline.py``: integer
planes and outputs are equal, scores ``allclose(rtol=1e-5, atol=1e-6)``,
top-k ids may differ only at non-isolated scores. The superblock planes'
floats are compared within 1 ulp (rtol 2e-7).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import SeismicConfig as JConfig
from repro.core import build_index as jax_build
from repro.core.build import suggest_fanout as jax_suggest_fanout
from repro.retrieval import SearchParams as JParams
from repro.retrieval import search_pipeline as jax_search
from repro.retrieval.prep import prep_queries as jax_prep
from repro.retrieval.router import route_batch as jax_route
from repro.retrieval.router import router_work as jax_router_work
from repro_torch.core import build_index, live_blocks, suggest_fanout
from repro_torch.core.types import SeismicConfig
from repro_torch.kernels import runtime
from repro_torch.retrieval import SearchParams, search_pipeline, stage_fns
from repro_torch.retrieval.router import route_batch, router_work
from repro_torch.serve import SeismicServer
from repro_torch.sparse.quant import dequantize_u8
from test_torch_build import (BASE, assert_planes, jax_rep_pos,
                              near_tie_lists, port_docs)
from test_torch_pipeline import (assert_scores, assert_topk, carry,
                                 port_queries)

FANOUTS = (2, 4)
POLICIES = ("budget", "adaptive", "global_threshold")
SUP_PLANES = ("sup_coords", "sup_q", "sup_scale", "sup_zero")
QUERY = dict(k=10, cut=8, block_budget=8, probe_budget=3,
             superblock_budget=6)


@pytest.fixture(scope="module")
def hier(small_collection):
    """fanout -> (JAX-built index, the same carried to the port)."""
    docs, *_ = small_collection
    out = {}
    for f in FANOUTS:
        jindex = jax_build(docs, JConfig(**BASE, superblock_fanout=f),
                           list_chunk=16)
        out[f] = (jindex, carry(jindex))
    return out


def _params(f, **kw):
    return dict(QUERY, superblock_fanout=f, **kw)


@pytest.mark.parametrize("f", FANOUTS)
def test_superblock_planes_match_reference(small_collection, hier, f):
    _, _, docs_np, _, _ = small_collection
    jindex = hier[f][0]
    jcfg = jindex.config
    rep_pos = jax_rep_pos(jindex, jcfg)
    timings = {}
    index = build_index(port_docs(docs_np),
                        SeismicConfig(**dataclasses.asdict(jcfg)),
                        list_chunk=37, rep_pos=rep_pos, timings=timings)
    assert "superblocks" in timings
    ties = near_tie_lists(jindex, index, rep_pos, docs_np)
    assert_planes(jindex, index, skip_lists=ties)
    keep = np.ones(jindex.n_lists, bool)
    keep[list(ties)] = False
    for name in SUP_PLANES:
        a, b = np.asarray(getattr(jindex, name)), getattr(index, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b[keep], a[keep], rtol=2e-7, atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(b[keep], a[keep], err_msg=name)
    assert index.sup_coords.shape[1:] == (jcfg.n_superblocks,
                                          min(jcfg.superblock_nnz, 1024))
    assert index.nbytes()["superblocks"] == sum(
        getattr(index, n).nbytes for n in SUP_PLANES)


@pytest.mark.parametrize("f", FANOUTS)
def test_superblocks_upper_bound_their_children(hier, f):
    """Every child's dequantized summary value lies at or below its
    superblock's at the same coordinate."""
    index = hier[f][1]
    cfg = index.config
    nb, ns, d = cfg.n_blocks, cfg.n_superblocks, index.dim
    dense = torch.zeros((index.n_lists, ns, d))
    dense.scatter_reduce_(2, index.sup_coords.long(),
                          dequantize_u8(index.sup_q, index.sup_scale,
                                        index.sup_zero), "amax")
    child = dequantize_u8(index.sum_q, index.sum_scale, index.sum_zero)
    group = (torch.arange(nb) // f)[None, :, None].expand_as(child)
    bound = dense[torch.arange(index.n_lists)[:, None, None], group,
                  index.sum_coords.long()]
    assert bool((child <= bound * (1 + 1e-6)).all())


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("fuse_level", [0, 2])
@pytest.mark.parametrize("f", FANOUTS)
def test_hier_router_matches_reference(small_collection, hier, f,
                                       fuse_level, use_kernel):
    _, queries, *_ = small_collection
    jindex, index = hier[f]
    jp = JParams(**_params(f))
    q_dense, lists, _ = jax_prep(queries.coords, queries.vals, jindex.dim,
                                 jp.cut)
    want = np.asarray(jax_route(jindex, q_dense, lists, jp).r)
    p = SearchParams(use_kernel=use_kernel, fuse_level=fuse_level,
                     **_params(f))
    fns = stage_fns(index, p)
    pq = port_queries(queries)
    qd, ls, _ = fns["prep"](pq.coords, pq.vals)
    got = fns["router"](qd, ls).r.numpy()
    assert got.shape == want.shape == (queries.n, 8 * jindex.config.n_blocks)
    assert_scores(got, want)
    routed = np.isfinite(want).sum(axis=1)
    assert (routed <= QUERY["superblock_budget"] * f).all()
    assert routed.max() > 0


@pytest.mark.parametrize("fuse_level", [0, 1, 2])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("f", FANOUTS)
def test_hier_search_matches_reference(small_collection, hier, f, policy,
                                       fuse_level):
    _, queries, *_ = small_collection
    jindex, index = hier[f]
    want = [np.asarray(x) for x in jax_search(
        jindex, queries, JParams(policy=policy, **_params(f)))]
    p = SearchParams(policy=policy, use_kernel=True, fuse_level=fuse_level,
                     **_params(f))
    s, i, e = search_pipeline(index, port_queries(queries), p)
    assert_topk(i.numpy(), s.numpy(), want[1], want[0])
    np.testing.assert_array_equal(e.numpy(), want[2])


@pytest.mark.parametrize("policy", POLICIES)
def test_hier_fuse_levels_equal(small_collection, hier, policy):
    """On the CPU every level runs the plain versions, which share their
    arithmetic: results are bitwise equal across levels 0, 1 and 2."""
    _, queries, *_ = small_collection
    index = hier[4][1]
    outs = [search_pipeline(index, port_queries(queries),
                            SearchParams(policy=policy, fuse_level=lvl,
                                         **_params(4)))
            for lvl in (0, 1, 2)]
    for other in outs[1:]:
        for x, y in zip(outs[0], other):
            assert torch.equal(x, y)


def test_hier_server_matches_pipeline_without_launches(small_collection,
                                                       hier):
    _, queries, *_ = small_collection
    index = hier[2][1]
    p = SearchParams(fuse_level=2, **_params(2))
    runtime.reset_launches()
    got = SeismicServer(index, p, max_batch=5).search(port_queries(queries))
    s, i, e = search_pipeline(index, port_queries(queries), p)
    assert torch.equal(got.ids, i) and torch.equal(got.scores, s)
    assert torch.equal(got.docs_evaluated, e)
    assert all(v == 0 for v in runtime.LAUNCHES.values())


def test_route_batch_needs_a_superblock_tier(small_collection,
                                             small_index):
    _, queries, *_ = small_collection
    pq = port_queries(queries)
    flat = carry(small_index[0])
    p = SearchParams(**_params(2))
    with pytest.raises(ValueError, match="no superblock tier"):
        search_pipeline(flat, pq, p)
    with pytest.raises(ValueError, match="no superblock tier"):
        SeismicServer(flat, p)
    qd = torch.zeros((1, flat.dim))
    with pytest.raises(ValueError, match="no superblock tier"):
        route_batch(flat, qd, torch.zeros((1, 8), dtype=torch.int32), p)


def test_route_batch_needs_the_built_fanout(small_collection, hier):
    _, queries, *_ = small_collection
    p = SearchParams(**_params(4))
    with pytest.raises(ValueError, match="mismatch"):
        search_pipeline(hier[2][1], port_queries(queries), p)
    with pytest.raises(ValueError, match="mismatch"):
        SeismicServer(hier[2][1], p)


@pytest.mark.parametrize("stats", [
    [], [0, 0], [1, 1, 2], [2, 2, 2], [3, 0, 3], [9] * 5, [16, 25, 0],
    [100, 100], [4, 16, 49]])
def test_suggest_fanout_matches_reference(stats):
    want = jax_suggest_fanout(np.asarray(stats, np.int32))
    assert suggest_fanout(torch.tensor(stats, dtype=torch.int32)) == want
    assert suggest_fanout(stats) == want
    assert suggest_fanout(stats, max_fanout=3) == jax_suggest_fanout(
        np.asarray(stats, np.int32), max_fanout=3)


def test_suggest_fanout_on_built_index(hier):
    jindex, index = hier[2]
    want = jax_suggest_fanout((np.asarray(jindex.block_len) > 0).sum(-1))
    assert suggest_fanout(live_blocks(index)) == want > 0


@pytest.mark.parametrize("kw", [
    dict(), dict(superblock_fanout=2, superblock_budget=6),
    dict(superblock_fanout=4, superblock_budget=100),
    dict(cut=3, superblock_fanout=4, superblock_budget=1)])
def test_router_work_matches_reference(hier, kw):
    f = kw.get("superblock_fanout", 2)
    jcfg = hier[f][0].config
    base = dict(k=10, cut=8)
    assert router_work(SeismicConfig(**dataclasses.asdict(jcfg)),
                       SearchParams(**{**base, **kw})) == jax_router_work(
        jcfg, JParams(**{**base, **kw}))


def test_hier_prunes_router_work_against_flat(small_collection, hier):
    """With a superblock budget that keeps every superblock the
    hierarchical route scores exactly the flat route's live blocks."""
    _, queries, *_ = small_collection
    index = hier[4][1]
    cfg = index.config
    pq = port_queries(queries)
    flat = stage_fns(index, SearchParams(k=10, cut=8))
    full = stage_fns(index, SearchParams(k=10, cut=8, superblock_fanout=4,
                                         superblock_budget=8 *
                                         cfg.n_superblocks))
    qd, ls, _ = flat["prep"](pq.coords, pq.vals)
    assert_scores(full["router"](qd, ls).r.numpy(),
                  flat["router"](qd, ls).r.numpy())
