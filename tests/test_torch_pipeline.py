"""Port parity: the batched query path (``repro_torch.retrieval``,
``core.query``, ``serve.engine``, ``ckpt.index_io``, ``core.oracle``)
against the JAX package on ``small_index`` carried across by
``index_from_arrays``.

Tolerances:
* integer outputs are equal: probed lists, selected blocks, candidate
  ids, ``docs_evaluated``;
* f32 scores ``allclose(rtol=1e-5, atol=1e-6)``: summation order
  differs between XLA and torch;
* top-k ids may differ only where the score at that position is not
  isolated (a neighbor lies within the score tolerance).

The JAX package pins its ``use_kernel`` / ``fuse_level`` ladder bit-exact
(tests/test_fusion.py), so one JAX run per policy (unfused, no kernel)
is the reference for every port level; at ``fuse_level=1`` the port's
candidates are the compacted (sorted) JAX candidates.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.ckpt.checkpoint import save_index
from repro.core.oracle import exact_topk as jax_exact_topk
from repro.retrieval import SearchParams as JParams
from repro.retrieval import search_pipeline as jax_search
from repro.retrieval.pipeline import stage_fns as jax_stage_fns
from repro.sparse.ops import PaddedSparse as JPadded
from repro.sparse.quant import quantize_u8 as jax_quantize_u8
from repro_torch.ckpt import load_index
from repro_torch.core import index_from_arrays, search_batch
from repro_torch.core.oracle import exact_topk, mean_recall_at_k, recall_at_k
from repro_torch.data import SyntheticSparseConfig, make_collection
from repro_torch.device import resolve_device
from repro_torch.kernels import runtime
from repro_torch.retrieval import (SearchParams, run_pipeline_staged,
                                   search_pipeline)
from repro_torch.serve import SeismicServer
from repro_torch.sparse.ops import PaddedSparse
from repro_torch.tune.policy import TunedPolicy

RTOL, ATOL = 1e-5, 1e-6
POLICIES = ("budget", "adaptive", "global_threshold")
BASE = dict(k=10, cut=8, block_budget=8, probe_budget=3)


def jax_index_arrays(index) -> dict:
    """A JAX index as the numpy arrays its ``save_index`` writes."""
    arrays = dict(fwd_coords=np.asarray(index.fwd.coords),
                  fwd_vals=np.asarray(index.fwd.vals))
    for f in dataclasses.fields(type(index)):
        v = getattr(index, f.name)
        if f.name not in ("fwd", "config", "tuned") and v is not None:
            arrays[f.name] = np.asarray(v)
    return arrays


def carry(index):
    """A JAX index on the port, its tuned operating points included."""
    tuned = tuple(TunedPolicy(**dataclasses.asdict(t)) for t in index.tuned)
    return index_from_arrays(jax_index_arrays(index), index.dim,
                             dataclasses.asdict(index.config), device="cpu",
                             tuned=tuned)


def port_queries(queries) -> PaddedSparse:
    return PaddedSparse(torch.from_numpy(np.array(queries.coords)),
                        torch.from_numpy(np.array(queries.vals)),
                        queries.dim)


def assert_scores(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


def assert_topk(ids, scores, want_ids, want_scores):
    """Scores allclose; ids equal except at non-isolated scores."""
    assert_scores(scores, want_scores)
    ids, want_ids = np.asarray(ids), np.asarray(want_ids)
    ws = np.asarray(want_scores, np.float64)
    for q, i in zip(*np.nonzero(ids != want_ids)):
        near = np.abs(ws[q] - ws[q, i]) <= ATOL + RTOL * abs(ws[q, i])
        near[i] = False
        assert near.any() or i == ids.shape[1] - 1, (
            f"query {q} position {i}: id {ids[q, i]} vs {want_ids[q, i]} "
            f"at an isolated score {ws[q, i]}")


@pytest.fixture(scope="module")
def carried(small_index):
    index, _ = small_index
    return index, carry(index)


@pytest.fixture(scope="module")
def jax_reference(small_collection, carried):
    """Per-policy JAX stage intermediates and end-to-end outputs."""
    _, queries, *_ = small_collection
    jindex, _ = carried
    out = {}
    for policy in POLICIES:
        p = JParams(policy=policy, **BASE)
        fns = jax_stage_fns(jindex, p)
        q_dense, lists, _ = fns["prep"](queries.coords, queries.vals)
        batch = fns["router"](q_dense, lists)
        sel = fns["selector"](batch)
        cand, scores = fns["scorer"](batch, sel)
        top = fns["merge"](cand, scores)
        out[policy] = dict(q_dense=q_dense, lists=lists, r=batch.r,
                           blocks=sel.blocks, block_scores=sel.block_scores,
                           cand=cand, scores=scores, top=top)
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("fuse_level", [0, 1])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_stages_match_reference(small_collection, carried, jax_reference,
                                policy, use_kernel, fuse_level):
    _, queries, *_ = small_collection
    _, index = carried
    want = jax_reference[policy]
    p = SearchParams(policy=policy, use_kernel=use_kernel,
                     fuse_level=fuse_level, **BASE)
    pq = port_queries(queries)
    seen = {}
    scores, ids, ev = run_pipeline_staged(
        index, pq.coords, pq.vals, p, probe=seen.__setitem__,
        audit=True)
    assert torch.equal(seen["merge_ids"], ids)    # refine is the identity
    np.testing.assert_array_equal(seen["lists"].numpy(), want["lists"])
    assert_scores(seen["router_r"].numpy(), want["r"])
    cand_want = want["cand"]
    if fuse_level >= 1:
        cand_want = np.sort(cand_want, axis=-1)   # compacted candidates
    np.testing.assert_array_equal(seen["cand"].numpy(), cand_want)
    ws, wi, wev = want["top"]
    assert_topk(ids.numpy(), scores.numpy(), wi, ws)
    np.testing.assert_array_equal(ev.numpy(), wev)
    assert ev.dtype == torch.int32 and ids.dtype == torch.int32


@pytest.mark.parametrize("policy", POLICIES)
def test_selection_and_scores_match_reference(small_collection, carried,
                                              jax_reference, policy):
    """The selector's blocks are equal and the scorer's per-candidate
    scores allclose, stage by stage on the port's own stage functions."""
    from repro_torch.retrieval.pipeline import stage_fns
    _, queries, *_ = small_collection
    _, index = carried
    want = jax_reference[policy]
    p = SearchParams(policy=policy, use_kernel=False, fuse_level=0, **BASE)
    fns = stage_fns(index, p)
    pq = port_queries(queries)
    q_dense, lists, _ = fns["prep"](pq.coords, pq.vals)
    np.testing.assert_array_equal(q_dense.numpy(), want["q_dense"])
    batch = fns["router"](q_dense, lists)
    sel = fns["selector"](batch)
    np.testing.assert_array_equal(sel.blocks.numpy(), want["blocks"])
    assert_scores(sel.block_scores.numpy(), want["block_scores"])
    cand, scores = fns["scorer"](batch, sel)
    np.testing.assert_array_equal(cand.numpy(), want["cand"])
    assert_scores(scores.numpy(), want["scores"])


def _edge_case(small_collection, jindex, p_kwargs):
    _, queries, *_ = small_collection
    index = carry(jindex)
    want = [np.asarray(x) for x in
            jax_search(jindex, queries, JParams(**p_kwargs))]
    for use_kernel, fuse_level in ((False, 0), (True, 0), (True, 1)):
        p = SearchParams(use_kernel=use_kernel, fuse_level=fuse_level,
                         **p_kwargs)
        s, i, e = search_pipeline(index, port_queries(queries), p)
        assert_topk(i.numpy(), s.numpy(), want[1], want[0])
        np.testing.assert_array_equal(e.numpy(), want[2])


@pytest.mark.parametrize("p_kwargs", [
    dict(k=50, cut=4, block_budget=1, policy="budget"),          # k > C
    dict(k=10, cut=8, block_budget=3, probe_budget=8),           # B < probe
])
def test_edge_params_match_reference(small_collection, carried, p_kwargs):
    _edge_case(small_collection, carried[0], p_kwargs)


def _bf16_index(jindex):
    return dataclasses.replace(jindex, fwd=jindex.fwd.astype(jnp.bfloat16))


def _compact_index(jindex):
    """The JAX builder's fwd_quant plane: u8 values with per-doc affine
    constants and uint16 coords."""
    fwd = jindex.fwd
    q, scale, zero = jax_quantize_u8(fwd.vals.astype(jnp.float32))
    return dataclasses.replace(
        jindex, fwd=JPadded(fwd.coords.astype(jnp.uint16), q, fwd.dim),
        fwd_scale=scale, fwd_zero=zero)


@pytest.mark.parametrize("plane", ["bf16", "compact"])
@pytest.mark.parametrize("policy", ["adaptive", "budget"])
def test_forward_planes_match_reference(small_collection, carried, plane,
                                        policy):
    make = _bf16_index if plane == "bf16" else _compact_index
    jindex = make(carried[0])
    index = carry(jindex)
    assert index.fwd.vals.dtype == (torch.bfloat16 if plane == "bf16"
                                    else torch.uint8)
    if plane == "compact":
        assert index.fwd.coords.dtype == torch.uint16
    _edge_case(small_collection, jindex, dict(policy=policy, **BASE))


@pytest.mark.parametrize("policy", ["adaptive", "budget"])
def test_mutable_index_tail_and_tombstones_match_reference(
        small_collection, carried, policy):
    """An index carrying a tail segment (inserted docs, scored exactly)
    and tombstones (deleted docs, masked before dedupe)."""
    from repro.core.mutate import make_mutable
    _, _, docs_np, _, _ = small_collection
    jindex = carried[0]
    n = jindex.n_docs
    mut = make_mutable(jindex, capacity=n + 40, tail_cap=40, tail_max=40)
    rng = np.random.default_rng(11)
    pick = rng.choice(n, 24, replace=False)
    new = mut.insert_docs(docs_np.coords[pick], docs_np.vals[pick])
    mut.delete_docs(np.concatenate([pick[:6], new[:5]]))
    index = mut.index
    assert index.tail_ids is not None and index.tombstone is not None
    _edge_case(small_collection, index, dict(policy=policy, **BASE))


@pytest.mark.parametrize("plane", ["f32", "bf16", "compact"])
def test_save_index_then_port_load_index(tmp_path, small_collection, carried,
                                         plane):
    jindex = {"f32": lambda x: x, "bf16": _bf16_index,
              "compact": _compact_index}[plane](carried[0])
    save_index(str(tmp_path), jindex, step=3)
    index = load_index(str(tmp_path), device="cpu")
    want = carry(jindex)
    assert index.config == want.config and index.dim == want.dim
    for name, t in want._tensor_fields().items():
        got = getattr(index, name)
        if t is None:
            assert got is None, name
        else:
            assert got.dtype == t.dtype and torch.equal(got, t), name
    assert index.fwd.vals.dtype == want.fwd.vals.dtype
    assert torch.equal(index.fwd.vals.float(), want.fwd.vals.float())
    assert torch.equal(index.fwd.coords.to(torch.int64),
                       want.fwd.coords.to(torch.int64))
    moved = index.to("cpu")
    assert torch.equal(moved.sum_coords, index.sum_coords)
    p = SearchParams(**BASE)
    _, queries, *_ = small_collection
    a = search_pipeline(moved, port_queries(queries), p)
    b = search_pipeline(want, port_queries(queries), p)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("max_batch", [5, 16, 64])
def test_server_matches_search_pipeline(small_collection, carried,
                                        max_batch):
    _, queries, *_ = small_collection
    index = carried[1]
    p = SearchParams(**BASE)
    pq = port_queries(queries)
    server = SeismicServer(index, p, max_batch=max_batch)
    got = server.search(pq)
    s, i, e = search_batch(index, pq, p)
    assert torch.equal(got.ids, i) and torch.equal(got.scores, s)
    assert torch.equal(got.docs_evaluated, e)
    empty = server.search(pq[0:0])
    assert empty.ids.shape == (0, p.k) and empty.docs_evaluated.shape == (0,)


def test_kernel_wrappers_take_plain_path_on_cpu(small_collection, carried):
    """CPU tensors take the plain versions: no launch is counted."""
    _, queries, *_ = small_collection
    runtime.reset_launches()
    search_pipeline(carried[1], port_queries(queries), SearchParams(**BASE))
    assert all(v == 0 for v in runtime.LAUNCHES.values())


def test_default_params_use_the_kernels():
    p = SearchParams()
    assert p.use_kernel and p.fuse_level == 1
    with pytest.raises(ValueError):
        SearchParams(fuse_level=3)


def test_entry_points_need_an_explicit_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is cuda there")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_collection(SyntheticSparseConfig(dim=64, n_docs=8))


def test_make_collection_on_cpu_shapes_and_ranges():
    cfg = SyntheticSparseConfig(dim=512, n_docs=300, n_queries=20,
                                doc_nnz=24, query_nnz=8, n_topics=8,
                                topic_coords=64, seed=3)
    docs, queries, meta = make_collection(cfg, device="cpu", chunk_rows=128)
    assert docs.coords.shape == (300, 24) and queries.vals.shape == (20, 8)
    assert docs.coords.dtype == torch.int32
    for ps in (docs, queries):
        srt = torch.sort(ps.coords, dim=1).values
        assert bool((srt[:, 1:] != srt[:, :-1]).all())    # distinct coords
        assert bool((ps.vals > 0).all())
        torch.testing.assert_close(ps.vals.amax(dim=1),
                                   torch.full((ps.n,), 3.0))
    again, _, _ = make_collection(cfg, device="cpu", chunk_rows=128)
    assert torch.equal(again.coords, docs.coords)          # seeded


def test_exact_topk_and_recall_match_reference(small_collection):
    docs, queries, docs_np, queries_np, _ = small_collection
    s, i = exact_topk(torch.from_numpy(docs_np.coords),
                      torch.from_numpy(docs_np.vals), docs_np.dim,
                      torch.from_numpy(queries_np.coords),
                      torch.from_numpy(queries_np.vals), 10, doc_chunk=300)
    for q in range(queries_np.coords.shape[0]):
        ws, wi = jax_exact_topk(docs_np.coords, docs_np.vals, docs_np.dim,
                                queries_np.coords[q], queries_np.vals[q], 10)
        np.testing.assert_allclose(s[q].numpy(), ws, rtol=1e-12)
        np.testing.assert_array_equal(i[q].numpy(), wi)
    approx = i.clone()
    approx[:, 5:] = -1
    assert recall_at_k(approx[0], i[0]) == 0.5
    assert mean_recall_at_k(approx, i) == 0.5
    assert mean_recall_at_k(i, i) == 1.0


def narrowed(queries, width: int):
    """The batch's first ``width`` entries of each query: (JAX batch,
    port batch)."""
    c = np.array(queries.coords)[:, :width]
    v = np.array(queries.vals)[:, :width]
    return (JPadded(jnp.asarray(c), jnp.asarray(v), queries.dim),
            PaddedSparse(torch.from_numpy(c), torch.from_numpy(v),
                         queries.dim))


def jax_staged(jindex, jq, p: JParams) -> dict:
    """JAX's probed lists, router scores, selected blocks and answers."""
    fns = jax_stage_fns(jindex, p)
    q_dense, lists, _ = fns["prep"](jq.coords, jq.vals)
    batch = fns["router"](q_dense, lists)
    sel = fns["selector"](batch)
    top = fns["merge"](*fns["scorer"](batch, sel))
    return jax.tree.map(np.asarray, dict(lists=lists, r=batch.r,
                                         blocks=sel.blocks, top=top))


@pytest.mark.parametrize("width,cut,policy", [
    (6, 10, "budget"), (6, 10, "adaptive"), (6, 10, "global_threshold"),
    (8, 8, "adaptive")])
def test_batch_narrower_than_the_cut(small_collection, carried, policy,
                                     width, cut):
    """A batch 6 wide at cut 10 probes its own 6 coordinates: at fuse
    levels 0, 1 and 2, ids, scores and docs_evaluated bitwise those of
    the same batch at cut 6, which match the JAX package at cut 6
    (``lax.top_k`` refuses a cut past the row). A batch as wide as the
    cut is held to JAX at that cut.

    Against JAX: the probed lists are equal and the router scores
    allclose. A query whose selected blocks differ may differ only
    between blocks whose router scores tie within the score tolerance
    (the two sum a summary row in another order; narrow queries of a
    few heavy values tie often); every other query's ``docs_evaluated``
    is equal and its top-k held as elsewhere here."""
    _, queries, *_ = small_collection
    jindex, index = carried
    jq, pq = narrowed(queries, width)
    base = dict(BASE, cut=cut, policy=policy)
    outs = []
    for fuse_level in (0, 1, 2):
        got = search_pipeline(index, pq, SearchParams(
            use_kernel=True, fuse_level=fuse_level, **base))
        at_width = search_pipeline(index, pq, SearchParams(
            use_kernel=True, fuse_level=fuse_level, **dict(base, cut=width)))
        for a, b in zip(got, at_width):
            assert torch.equal(a, b), fuse_level
        outs.append(got)
    for got in outs[1:]:
        assert torch.equal(got[1], outs[0][1])
        assert torch.equal(got[2], outs[0][2])
    want = jax_staged(jindex, jq, JParams(**dict(base, cut=width)))
    seen = {}
    run_pipeline_staged(index, pq.coords, pq.vals, SearchParams(**base),
                        probe=seen.__setitem__, audit=True)
    np.testing.assert_array_equal(seen["lists"].numpy(), want["lists"])
    assert_scores(seen["router_r"].numpy(), want["r"])
    sel = stage_fns_blocks(index, pq, SearchParams(**base))
    same = []
    for q in range(pq.coords.shape[0]):
        differ = np.setxor1d(sel[q], want["blocks"][q])
        differ = differ[differ < want["r"].shape[1]]
        rr = want["r"][q, differ]
        assert differ.size == 0 or (
            rr.max() - rr.min() <= ATOL + RTOL * abs(rr.max())), (
            f"query {q}: blocks {differ.tolist()} differ at router scores "
            f"{rr.tolist()}")
        same.append(differ.size == 0)
    same = np.array(same)
    print(f"{int(same.sum())} of {same.size} queries select JAX's blocks")
    assert same.sum() >= same.size // 2
    ws, wi, wev = want["top"]
    for got in outs:
        assert_topk(got[1].numpy()[same], got[0].numpy()[same], wi[same],
                    ws[same])
        np.testing.assert_array_equal(got[2].numpy()[same], wev[same])


def stage_fns_blocks(index, pq, p: SearchParams) -> np.ndarray:
    """The port's selected blocks for batch ``pq`` (unfused stages)."""
    from repro_torch.retrieval.pipeline import stage_fns
    fns = stage_fns(index, p)
    q_dense, lists, _ = fns["prep"](pq.coords, pq.vals)
    return fns["selector"](fns["router"](q_dense, lists)).blocks.numpy()


def test_router_work_counts_the_lists_a_narrow_batch_probes(carried):
    """``router_work`` and the device accounting's router bytes count the
    lists a query probes: at cut 10 a 6-wide batch counts as cut 6, a
    batch at least as wide as the cut as the cut."""
    from repro_torch.obs.device import DeviceAccounting
    from repro_torch.obs.registry import MetricsRegistry
    from repro_torch.retrieval.router import router_work
    _, index = carried
    p10, p6 = SearchParams(cut=10), SearchParams(cut=6)
    cfg = index.config
    assert router_work(cfg, p10, query_nnz=6) == router_work(cfg, p6)
    assert router_work(cfg, p10, query_nnz=16) == router_work(cfg, p10) \
        == 10 * cfg.n_blocks
    a10 = DeviceAccounting(index, p10, MetricsRegistry())
    a6 = DeviceAccounting(index, p6, MetricsRegistry())
    assert a10.router_bytes_per_query(6) == a6.router_bytes_per_query() \
        < a10.router_bytes_per_query() == a10.router_bytes_per_query(48)
