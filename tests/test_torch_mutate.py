"""Port parity: streaming mutation (``repro_torch.core.mutate``), index
persistence (``repro_torch.ckpt``), the builder's mutation seams, the
MS MARCO config and the server's swap, telemetry and metrics registry
(``repro_torch.serve``, ``repro_torch.obs``) against the JAX package, at
the sizes of ``tests/test_mutation.py`` (DIM 64, NNZ 8, lam 16, beta 2,
block_cap 4, superblock fanout 2), plus a built index with ``fwd_quant``
and a kNN graph.

Tolerances:
* Every plane is equal after every step, integer and float alike
  (``list_vals``, the summary scales and zeros, the forward values and
  the compact plane's scale and zero included). The JAX ``compact``
  calls the builder's seams eagerly, so its quantizer divides by 254 and
  its superblock dequant rounds after the product and after the sum; the
  port's seams round the same way (``fused=False``). With the compiled
  build's rounding instead (a multiply by the reciprocal, one rounding),
  the summary scales and superblock levels differ in the last bit.
* Search at fuse 0 with the plain versions: ``docs_evaluated`` equal,
  scores ``allclose(rtol=1e-5, atol=1e-6)`` (summation order differs),
  ids equal except at non-isolated scores, as in
  ``tests/test_torch_pipeline.py``.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from helpers import given, needs_hypothesis, settings, st
from repro.ckpt.checkpoint import load_index as jax_load_index
from repro.ckpt.checkpoint import save_index as jax_save_index
from repro.configs import seismic_msmarco as jax_msmarco
from repro.core import MutableSeismicIndex as JMutable
from repro.core import SeismicConfig as JConfig
from repro.core import build_index as jax_build
from repro.core import make_mutable as jax_make_mutable
from repro.core.build import block_summaries as jax_block_summaries
from repro.core.build import merge_superblock_summary as jax_merge
from repro.graph import build_doc_graph as jax_graph
from repro.obs.registry import MetricsRegistry as JRegistry
from repro.retrieval import SearchParams as JParams
from repro.retrieval import search_pipeline as jax_search
from repro.serve.engine import SeismicServer as JServer
from repro.serve.telemetry import ServerTelemetry as JTelemetry
from repro.sparse.ops import PaddedSparse as JPadded
from repro_torch.ckpt import load_index, save_index
from repro_torch.configs import seismic_msmarco
from repro_torch.core import (MutableSeismicIndex, SeismicConfig,
                              build_index, make_mutable)
from repro_torch.core.build import block_summaries, merge_superblock_summary
from repro_torch.obs import MetricsRegistry
from repro_torch.retrieval import SearchParams, search_pipeline
from repro_torch.serve import SeismicServer
from repro_torch.serve.telemetry import ServerTelemetry
from repro_torch.sparse.ops import PaddedSparse
from repro_torch.sparse.quant import dequantize_u8
from repro_torch.tune.policy import TunedPolicy
from test_torch_pipeline import assert_topk, carry

DIM, NNZ, CAP = 64, 8, 40
CFG = dict(lam=16, beta=2, alpha=1.0, block_cap=4, summary_nnz=64,
           superblock_fanout=2)
PLANES = ("list_docs", "list_vals", "list_len", "block_off", "block_len",
          "sum_coords", "sum_q", "sum_scale", "sum_zero", "sup_coords",
          "sup_q", "sup_scale", "sup_zero", "fwd_scale", "fwd_zero",
          "knn_ids", "tail_ids", "tombstone")


def rand_docs(rng, n, vocab=DIM, levels=0):
    """``n`` docs of NNZ distinct coordinates in [1, vocab): a small
    vocabulary fills lists past lam, so compaction rebuilds them. With
    ``levels`` the values are multiples of 1 / levels, so postings tie and
    their order falls to the doc ids; a power of two keeps every product
    and sum of them exact, so the builder's assignment ties exactly in
    both packages (another summation order would break a tie another
    way, as ``tests/test_torch_build.py`` allows)."""
    coords = np.stack([rng.choice(np.arange(1, vocab), NNZ, replace=False)
                       for _ in range(n)]).astype(np.int64)
    vals = rng.uniform(0.1, 1.0, (n, NNZ)).astype(np.float32)
    if levels:
        vals = (rng.integers(1, levels + 1, (n, NNZ)) / levels).astype(
            np.float32)
    return coords, vals


def queries(rng, n=8):
    c, v = rand_docs(rng, n)
    return (JPadded(jnp.asarray(c.astype(np.int32)), jnp.asarray(v), DIM),
            PaddedSparse(torch.from_numpy(c.astype(np.int32)),
                         torch.from_numpy(v), DIM))


def full_budget(**kw):
    return dict(k=10, cut=NNZ, block_budget=NNZ * JConfig(**CFG).n_blocks,
                policy="budget", **kw)


def assert_same_index(jindex, index):
    """Every plane equal, bit for bit."""
    for name in PLANES:
        a, b = getattr(jindex, name), getattr(index, name)
        if a is None:
            assert b is None, name
            continue
        a = np.asarray(a)
        assert b.dtype == torch.from_numpy(np.empty(0, a.dtype)).dtype, \
            name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    np.testing.assert_array_equal(
        index.fwd.coords.view(torch.int16).numpy().view(np.uint16)
        if index.fwd.coords.dtype == torch.uint16
        else index.fwd.coords.numpy(), np.asarray(jindex.fwd.coords))
    np.testing.assert_array_equal(index.fwd.vals.float().numpy(),
                                  np.asarray(jindex.fwd.vals, np.float32))


def assert_same_search(jindex, index, rng, **kw):
    jq, pq = queries(rng)
    for p in (full_budget(**kw), dict(k=5, cut=4, block_budget=3,
                                      policy="budget", **kw)):
        want = [np.asarray(x) for x in jax_search(jindex, jq, JParams(**p))]
        got = search_pipeline(index, pq, SearchParams(
            use_kernel=False, fuse_level=0, **p))
        assert_topk(got[1].numpy(), got[0].numpy(), want[1], want[0])
        np.testing.assert_array_equal(got[2].numpy(), want[2])


class Twin:
    """One JAX and one port ``MutableSeismicIndex`` driven by the same
    calls; every call is followed by a plane-by-plane comparison."""

    def __init__(self, jmut, pmut):
        self.j, self.p = jmut, pmut
        self.check()

    def check(self):
        assert_same_index(self.j.index, self.p.index)
        for attr in ("n_docs", "n_live", "epoch", "tail_occupancy"):
            assert getattr(self.p, attr) == getattr(self.j, attr), attr

    def insert(self, c, v):
        want = self.j.insert_docs(c, v)
        np.testing.assert_array_equal(self.p.insert_docs(c, v).numpy(), want)
        self.check()

    def delete(self, ids):
        self.j.delete_docs(ids)
        self.p.delete_docs(ids)
        self.check()

    def compact(self):
        self.j.compact()
        self.p.compact()
        self.check()


def empty_twin(registry=None, tail_max=8, cfg=CFG):
    return Twin(JMutable.empty(DIM, NNZ, JConfig(**cfg), capacity=CAP,
                               tail_cap=16, tail_max=tail_max),
                MutableSeismicIndex.empty(DIM, NNZ, SeismicConfig(**cfg),
                                          capacity=CAP, tail_cap=16,
                                          tail_max=tail_max,
                                          registry=registry, device="cpu"))


# ------------------------------------------------------ arrays and search

@pytest.mark.parametrize("vocab,tail_max,levels", [(DIM, 8, 0), (20, 4, 0),
                                                   (20, 4, 4)])
def test_mutation_sequence_matches_reference(vocab, tail_max, levels):
    """Grow from empty with auto-compaction, delete blocked and tail docs,
    compact, grow again: equal planes after every call, equal search. The
    small vocabulary makes compaction rebuild lists (major) as well as
    append to them (minor); four value levels make postings tie."""
    rng = np.random.default_rng(vocab + levels)
    reg = MetricsRegistry()
    t = empty_twin(reg, tail_max)
    while t.j.n_docs < CAP - 10:
        t.insert(*rand_docs(rng, int(rng.integers(1, 6)), vocab, levels))
    assert_same_search(t.j.index, t.p.index, rng)      # a live tail
    t.delete(rng.choice(t.j.n_docs, 5, replace=False))
    assert_same_search(t.j.index, t.p.index, rng)      # mask only
    t.compact()
    assert_same_search(t.j.index, t.p.index, rng)      # purged
    t.insert(*rand_docs(rng, 6, vocab, levels))
    t.delete([t.j.n_docs - 1])
    t.compact()
    t.compact()                                        # a no-op
    assert_same_search(t.j.index, t.p.index, rng)
    minor = reg.get("seismic_compaction_lists_minor_total").labels().value
    major = reg.get("seismic_compaction_lists_major_total").labels().value
    assert minor > 0 and (major > 0 or vocab == DIM)


def test_lifted_quantized_graph_index_matches_reference():
    """A built index with the compact forward plane and a kNN graph, lifted
    to capacity: the u8 rows of inserted docs, the purge of the compact
    plane, the sentinel remap and the graph patch (fresh out-edges of
    compacted-in docs, dead edges dropped)."""
    rng = np.random.default_rng(5)
    c, v = rand_docs(rng, 24, 24)
    cfg = JConfig(**CFG, fwd_quant=True)
    jindex = jax_build(JPadded(jnp.asarray(c.astype(np.int32)),
                               jnp.asarray(v), DIM), cfg)
    jindex = jax_graph(jindex, degree=3, batch=8, build_params=JParams(
        k=4, cut=8, block_budget=8 * cfg.n_blocks, policy="budget"))
    kw = dict(capacity=CAP, tail_cap=16, tail_max=6)
    t = Twin(jax_make_mutable(jindex, **kw), make_mutable(carry(jindex), **kw))
    assert t.p.index.fwd.coords.dtype == torch.uint16
    refine = dict(graph_degree=3, refine_rounds=2)
    t.insert(*rand_docs(rng, 5, 24))
    t.delete([2, 7, 25])
    assert_same_search(t.j.index, t.p.index, rng, **refine)
    t.insert(*rand_docs(rng, 11, 24))                 # auto-compacts
    t.compact()
    assert int((t.p.index.knn_ids[24:40] < CAP).sum()) > 0
    assert_same_search(t.j.index, t.p.index, rng, **refine)


OPS = st.lists(
    st.one_of(
        st.tuples(st.just("insert"), st.integers(1, 6)),
        st.tuples(st.just("delete"), st.integers(0, 1_000_000)),
        st.tuples(st.just("compact"), st.just(0)),
    ),
    min_size=1, max_size=10)


@needs_hypothesis
@settings(max_examples=6, deadline=None)
@given(ops=OPS, seed=st.integers(0, 2**16), dense=st.booleans())
def test_property_random_sequences_match_reference(ops, seed, dense):
    rng = np.random.default_rng(seed)
    vocab = 20 if dense else DIM
    t = empty_twin(tail_max=6)
    for op, arg in ops:
        if op == "insert":
            b = min(arg, CAP - t.j.n_docs)
            if b > 0:
                t.insert(*rand_docs(rng, b, vocab))
        elif op == "delete" and t.j.n_docs > 0:
            t.delete([arg % t.j.n_docs])
        elif op == "compact":
            t.compact()
    assert_same_search(t.j.index, t.p.index, rng)


def test_builder_seams_match_reference():
    """``block_summaries`` and ``merge_superblock_summary`` over a chunk
    of lists equal the JAX seams called list by list."""
    rng = np.random.default_rng(9)
    cfg = dict(CFG, alpha=0.6, summary_nnz=6, superblock_fanout=3)
    jcfg, pcfg = JConfig(**cfg), SeismicConfig(**cfg)
    c, v = rand_docs(rng, 30)
    jfwd = JPadded(jnp.asarray(c.astype(np.int32)), jnp.asarray(v), DIM)
    pfwd = PaddedSparse(torch.from_numpy(c.astype(np.int32)),
                        torch.from_numpy(v), DIM)
    lam, nb = jcfg.lam, jcfg.n_blocks
    docs = np.full((3, lam), 30, np.int32)
    bid = np.full((3, lam), nb, np.int32)
    for i, d in enumerate((5, 16, 1)):
        docs[i, :d] = rng.choice(30, d, replace=False)
        bid[i, :d] = np.arange(d) // jcfg.block_cap
    got = block_summaries(torch.from_numpy(docs), torch.from_numpy(bid),
                          pfwd, pcfg)
    for i in range(3):
        want = jax_block_summaries(jnp.asarray(docs[i]), jnp.asarray(bid[i]),
                                   jfwd, jcfg)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
    # merge: two groups, the second with one new child (the other level 0)
    s2 = jcfg.superblock_nnz
    sup_c = np.zeros((2, s2), np.int32)
    sup_c[:, :5] = rng.choice(np.arange(1, DIM), (2, 5))
    sup_q = np.zeros((2, s2), np.uint8)
    sup_q[:, :5] = rng.integers(1, 256, (2, 5))
    sup_scale = rng.uniform(0.001, 0.01, 2).astype(np.float32)
    sup_zero = rng.uniform(0.1, 0.5, 2).astype(np.float32)
    sc, q, scale, zero = (x.numpy()[[0, 1]] for x in got)
    kids = np.array([[0, 1], [0, 0]])
    q = q.copy()
    q[1, 1] = 0
    got_m = merge_superblock_summary(
        *map(torch.from_numpy, (sup_c, sup_q, sup_scale, sup_zero)),
        torch.from_numpy(sc[np.arange(2)[:, None], kids]),
        torch.from_numpy(q[np.arange(2)[:, None], kids]),
        torch.from_numpy(scale[np.arange(2)[:, None], kids]),
        torch.from_numpy(zero[np.arange(2)[:, None], kids]), DIM, pcfg)
    for g, m in enumerate((2, 1)):
        k = kids[g, :m]
        want = jax_merge(*(jnp.asarray(x[g]) for x in (sup_c, sup_q,
                                                       sup_scale, sup_zero)),
                         jnp.asarray(sc[g][k]), jnp.asarray(q[g][k]),
                         jnp.asarray(scale[g][k]), jnp.asarray(zero[g][k]),
                         DIM, jcfg)
        for a, w in zip(got_m, want):
            np.testing.assert_array_equal(a[g].numpy(), np.asarray(w))


# -------------------------------------------------- port-side contracts

def _equivalence_corpus(mut) -> PaddedSparse:
    """Capacity-sized collection equal to the mutable's logical corpus:
    deleted and unassigned rows all zero."""
    idx = mut.index
    coords = idx.fwd.coords.clone()
    vals = idx.fwd.vals.float()
    if idx.fwd_scale is not None:
        vals = dequantize_u8(idx.fwd.vals, idx.fwd_scale, idx.fwd_zero)
    dead = idx.tombstone.clone()
    dead[mut.n_docs:] = True
    coords[dead] = 0
    vals = torch.where(dead[:, None], 0.0, vals)
    return PaddedSparse(coords, vals, DIM)


def _assert_bitmatch(mut, q, p):
    fresh = build_index(_equivalence_corpus(mut), SeismicConfig(**CFG))
    for a, b in zip(search_pipeline(mut.index, q, p),
                    search_pipeline(fresh, q, p)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fuse_level", [0, 1, 2])
def test_grow_from_empty_bitmatches_fresh_build(fuse_level):
    """At full budget a grown, mutated and compacted index answers as a
    fresh port build of the equivalent corpus, at every fuse level."""
    rng = np.random.default_rng(11)
    mut = MutableSeismicIndex.empty(DIM, NNZ, SeismicConfig(**CFG),
                                    capacity=CAP, tail_cap=16, tail_max=8,
                                    device="cpu")
    q = queries(rng)[1]
    p = SearchParams(fuse_level=fuse_level, **full_budget())
    while mut.n_docs < CAP - 4:
        mut.insert_docs(*rand_docs(rng, int(rng.integers(1, 6))))
        _assert_bitmatch(mut, q, p)
    mut.delete_docs([0, 9, mut.n_docs - 1])
    _assert_bitmatch(mut, q, p)
    mut.compact()
    _assert_bitmatch(mut, q, p)


def test_deleted_docs_never_returned():
    rng = np.random.default_rng(3)
    mut = MutableSeismicIndex.empty(DIM, NNZ, SeismicConfig(**CFG),
                                    capacity=CAP, tail_cap=16, tail_max=8,
                                    device="cpu")
    mut.insert_docs(*rand_docs(rng, 30))
    mut.compact()
    mut.insert_docs(*rand_docs(rng, 6))
    doomed = torch.tensor([1, 7, 19, 31, 33])
    mut.delete_docs(doomed)
    assert mut.n_live == 31
    q = queries(rng)[1]
    for policy in ("budget", "adaptive"):
        p = SearchParams(k=10, cut=NNZ, block_budget=NNZ * 6, policy=policy,
                         probe_budget=4)
        for step in ("masked", "purged"):
            ids = search_pipeline(mut.index, q, p)[1]
            assert not torch.isin(ids, doomed).any(), (policy, step)
            mut.compact()
    assert torch.equal(mut.insert_docs(*rand_docs(rng, 2)),
                       torch.tensor([36, 37]))     # ids are never reused


def test_summaries_upper_bound_members_after_mutation():
    """Block summaries bound their live members' scores (up to the
    round-to-nearest slack); superblock summaries bound their children
    exactly (round-up quantization)."""
    rng = np.random.default_rng(6)
    mut = MutableSeismicIndex.empty(DIM, NNZ, SeismicConfig(**CFG),
                                    capacity=CAP, tail_cap=16, tail_max=6,
                                    device="cpu")
    mut.insert_docs(*rand_docs(rng, 25, 24))
    mut.delete_docs([2, 9, 14])
    mut.insert_docs(*rand_docs(rng, 10, 24))
    mut.compact()
    idx = mut.index
    q = torch.zeros(4, DIM, dtype=torch.float64)
    qc, qv = rand_docs(rng, 4)
    q[torch.arange(4)[:, None], torch.from_numpy(qc)] = torch.from_numpy(
        qv).double()
    doc = torch.zeros(CAP, DIM, dtype=torch.float64)
    doc[torch.arange(CAP)[:, None], idx.fwd.coords.long()] = \
        idx.fwd.vals.double()
    sv = dequantize_u8(idx.sum_q, idx.sum_scale, idx.sum_zero).double()
    blk = (q[:, idx.sum_coords.long()] * sv).sum(-1)      # [4, L, nb]
    pv = dequantize_u8(idx.sup_q, idx.sup_scale, idx.sup_zero).double()
    sup = (q[:, idx.sup_coords.long()] * pv).sum(-1)      # [4, L, ns]
    slack = 0.5 * idx.sum_scale.double() * q.sum(1)[:, None, None]
    checked = 0
    for ell in range(idx.n_lists):
        for b in range(SeismicConfig(**CFG).n_blocks):
            ln = int(idx.block_len[ell, b])
            if ln == 0:
                continue
            off = int(idx.block_off[ell, b])
            m = idx.list_docs[ell, off:off + ln].long()
            m = m[m < CAP]
            exact = q @ doc[m].T                             # [4, members]
            assert bool((blk[:, ell, b, None] + slack[:, ell, b, None]
                         + 1e-6 >= exact).all()), (ell, b)
            assert bool((sup[:, ell, b // CFG["superblock_fanout"]]
                         + 1e-6 >= blk[:, ell, b]).all()), (ell, b)
            checked += m.numel()
    assert checked > 0


def _snapshot(index):
    return {n: t.clone() for n, t in index._tensor_fields().items()
            if t is not None} | {"fwd.coords": index.fwd.coords.clone(),
                                 "fwd.vals": index.fwd.vals.clone()}


def _tensors(index):
    return {n: t for n, t in index._tensor_fields().items()
            if t is not None} | {"fwd.coords": index.fwd.coords,
                                 "fwd.vals": index.fwd.vals}


def test_published_snapshot_is_immutable():
    """A snapshot taken before an insert, a delete and a compaction is
    bitwise unchanged after them (every changed plane is copied)."""
    rng = np.random.default_rng(12)
    c, v = rand_docs(rng, 20, 24)
    built = build_index(PaddedSparse(torch.from_numpy(c.astype(np.int32)),
                                     torch.from_numpy(v), DIM),
                        SeismicConfig(**CFG))
    mut = make_mutable(built, capacity=CAP, tail_cap=16, tail_max=8)
    for op in (lambda: mut.insert_docs(*rand_docs(rng, 6, 24)),
               lambda: mut.delete_docs([3, 21]),
               mut.compact):
        before = mut.index
        copy = _snapshot(before)
        op()
        assert mut.index is not before
        for name, t in _tensors(before).items():
            assert torch.equal(t, copy[name]), name


def _errors(make):
    """The ValueError message of ``make(package)`` for both packages."""
    out = []
    for pkg in ("jax", "port"):
        with pytest.raises(ValueError) as e:
            make(pkg)
        out.append(str(e.value))
    return out


def _mut(pkg, **kw):
    if pkg == "jax":
        return JMutable.empty(DIM, NNZ, JConfig(**CFG), **kw)
    return MutableSeismicIndex.empty(DIM, NNZ, SeismicConfig(**CFG),
                                     device="cpu", **kw)


ERRORS = {
    "capacity exhausted": lambda pkg: _mut(pkg, capacity=4, tail_cap=8)
    .insert_docs(*rand_docs(np.random.default_rng(0), 5)),
    "tail_cap": lambda pkg: _mut(pkg, capacity=4, tail_cap=0),
    "tail_max": lambda pkg: _mut(pkg, capacity=4, tail_cap=4, tail_max=5),
    "nnz": lambda pkg: _mut(pkg, capacity=4).insert_docs(
        np.ones((1, NNZ + 1), np.int64), np.ones((1, NNZ + 1), np.float32)),
    "coords range": lambda pkg: _mut(pkg, capacity=4).insert_docs(
        np.full((1, NNZ), DIM), np.ones((1, NNZ), np.float32)),
    "shapes": lambda pkg: _mut(pkg, capacity=4).insert_docs(
        np.ones((2, 3), np.int64), np.ones((2, 4), np.float32)),
    "delete range": lambda pkg: _mut(pkg, capacity=4).delete_docs([0]),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_match_reference(case):
    jax_msg, port_msg = _errors(ERRORS[case])
    assert port_msg == jax_msg


def test_lift_errors_match_reference():
    rng = np.random.default_rng(1)
    c, v = rand_docs(rng, 8)
    jindex = jax_build(JPadded(jnp.asarray(c.astype(np.int32)),
                               jnp.asarray(v), DIM), JConfig(**CFG))
    index = carry(jindex)
    for kw in (dict(capacity=4), dict(n_docs=9), dict(capacity=12,
                                                       n_docs=-1)):
        msgs = _errors(lambda pkg: (jax_make_mutable(jindex, **kw)
                                    if pkg == "jax"
                                    else make_mutable(index, **kw)))
        assert msgs[0] == msgs[1]
    jmut = jax_make_mutable(jindex, capacity=20, tail_cap=8)
    jmut.insert_docs(*rand_docs(rng, 5))
    persisted = carry(jmut.index)
    assert _errors(lambda pkg: (
        jax_make_mutable(jmut.index, tail_cap=4) if pkg == "jax"
        else make_mutable(persisted, tail_cap=4)))[1] == \
        "persisted tail (5) exceeds tail_cap 4"


# ------------------------------------------------------------ persistence

def _mutated_pair(quant: bool):
    """A JAX-mutated index (live tail, tombstones) and its port copy."""
    rng = np.random.default_rng(21)
    cfg = JConfig(**CFG, fwd_quant=quant)
    jmut = JMutable.empty(DIM, NNZ, cfg, capacity=CAP, tail_cap=16,
                          tail_max=8)
    jmut.insert_docs(*rand_docs(rng, 20))
    jmut.compact()
    jmut.insert_docs(*rand_docs(rng, 5))
    jmut.delete_docs([3, 11, 22])
    return jmut, carry(jmut.index)


@pytest.mark.parametrize("quant", [False, True])
def test_port_save_index_loads_in_jax(tmp_path, quant):
    jmut, index = _mutated_pair(quant)
    save_index(str(tmp_path), index, step=4)
    restored = jax_load_index(str(tmp_path), step=4)
    assert restored.config == jmut.index.config
    assert_same_index(restored, index)
    jq, pq = queries(np.random.default_rng(1))
    p = full_budget()
    for a, b in zip(jax_search(restored, jq, JParams(**p)),
                    jax_search(jmut.index, jq, JParams(**p))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("plane", ["float32", "bfloat16", "u8"])
def test_port_save_load_roundtrip_is_bitwise(tmp_path, plane):
    _, index = _mutated_pair(plane == "u8")
    if plane == "bfloat16":
        index = dataclasses.replace(index, fwd=index.fwd.astype(
            torch.bfloat16), config=dataclasses.replace(
            index.config, fwd_dtype="bfloat16"))
    index = dataclasses.replace(index, tuned=(TunedPolicy(target=0.9, k=10),))
    save_index(str(tmp_path), index, step=1)
    save_index(str(tmp_path), index, step=1)            # overwrite commits
    assert sorted(p.name for p in tmp_path.iterdir()) == ["index_00000001"]
    restored = load_index(str(tmp_path), device="cpu")
    assert restored.config == index.config and restored.tuned == index.tuned
    for name, t in _tensors(index).items():
        got = _tensors(restored)[name]
        assert got.dtype == t.dtype and torch.equal(
            got.view(torch.int16) if t.dtype == torch.uint16 else got,
            t.view(torch.int16) if t.dtype == torch.uint16 else t), name
    q = queries(np.random.default_rng(2))[1]
    p = SearchParams(**full_budget())
    for a, b in zip(search_pipeline(restored, q, p),
                    search_pipeline(index, q, p)):
        assert torch.equal(a, b)


def test_bf16_plane_is_stored_as_the_jax_package_stores_it(tmp_path):
    """``np.savez`` writes an ml_dtypes bfloat16 array as ``|V2`` items;
    the port writes the same bytes, and reads the JAX file back
    bitwise."""
    rng = np.random.default_rng(4)
    c, v = rand_docs(rng, 12)
    jindex = jax_build(JPadded(jnp.asarray(c.astype(np.int32)),
                               jnp.asarray(v), DIM),
                       JConfig(**CFG, fwd_dtype="bfloat16"))
    jax_save_index(str(tmp_path / "jax"), jindex)
    save_index(str(tmp_path / "port"), carry(jindex))
    npz = {}
    for who in ("jax", "port"):
        with np.load(tmp_path / who / "index_00000000" / "index.npz") as z:
            npz[who] = {k: z[k] for k in z.files}
    assert npz["port"].keys() == npz["jax"].keys()
    assert npz["jax"]["fwd_vals"].dtype.str == "|V2"
    for k, a in npz["jax"].items():
        assert npz["port"][k].dtype == a.dtype, k
        assert npz["port"][k].tobytes() == a.tobytes(), k
    restored = load_index(str(tmp_path / "jax"), device="cpu")
    assert restored.fwd.vals.dtype == torch.bfloat16
    assert_same_index(jindex, restored)
    manifests = [json.loads((tmp_path / w / "index_00000000"
                             / "seismic_index.json").read_text())
                 for w in ("jax", "port")]
    assert manifests[0] == manifests[1]


def test_jax_saved_mutated_index_resumes_in_port(tmp_path):
    """A mutated index the JAX package saved loads in the port, and
    ``make_mutable`` resumes its tail and tombstones: both packages then
    compact it to equal planes."""
    jmut, _ = _mutated_pair(False)
    jax_save_index(str(tmp_path), jmut.index, step=2)
    kw = dict(capacity=CAP, tail_cap=16, tail_max=8, n_docs=jmut.n_docs)
    t = Twin(jax_make_mutable(jax_load_index(str(tmp_path)), **kw),
             make_mutable(load_index(str(tmp_path), device="cpu"), **kw))
    assert t.p.tail_occupancy == jmut.tail_occupancy == 5
    assert t.p.n_live == jmut.n_live
    t.compact()
    ids = search_pipeline(t.p.index, queries(np.random.default_rng(3))[1],
                          SearchParams(**full_budget()))[1]
    assert not torch.isin(ids, torch.tensor([3, 11, 22])).any()


# ------------------------------------------------- server and telemetry

def test_swap_index_and_apply_mutation_bump_epoch():
    rng = np.random.default_rng(13)
    tel = ServerTelemetry()
    mut = MutableSeismicIndex.empty(DIM, NNZ, SeismicConfig(**CFG),
                                    capacity=CAP, tail_cap=16, tail_max=8,
                                    device="cpu")
    q = queries(rng)[1]
    server = SeismicServer(mut.index, SearchParams(**full_budget()),
                           max_batch=4, telemetry=tel)
    gauge = tel.registry.get("seismic_index_epoch").labels()
    assert server.epoch == 0 and gauge.value == 0
    empty = server.search(q)
    assert bool((empty.ids == -1).all())
    assert server.apply_mutation(
        mut, lambda m: m.insert_docs(*rand_docs(rng, 12))) == 1
    grown = server.search(q)
    assert bool((grown.ids >= 0).any()) and gauge.value == 1
    victim = grown.ids[grown.ids >= 0][:1]
    mut.delete_docs(victim)
    assert server.epoch == 1          # nothing is published until a swap
    assert torch.equal(server.search(q).ids, grown.ids)
    assert server.swap_index(mut.index) == 2
    assert not torch.isin(server.search(q).ids, victim).any()
    with pytest.raises(ValueError, match="kNN graph"):
        server.swap_index(mut.index, SearchParams(graph_degree=2,
                                                  refine_rounds=1))
    assert server.epoch == 2


def _export_without_times(export):
    out = json.loads(json.dumps(export))
    for summary in out["latency_s"].values():
        for k in ("mean", "p50", "p95", "p99", "min", "max"):
            summary.pop(k)
    return out


def test_server_telemetry_matches_reference():
    """The same requests through both packages' servers: equal counters,
    batch occupancy and launch counts (the latencies themselves differ)."""
    rng = np.random.default_rng(14)
    c, v = rand_docs(rng, 24)
    jindex = jax_build(JPadded(jnp.asarray(c.astype(np.int32)),
                               jnp.asarray(v), DIM), JConfig(**CFG))
    exports = []
    for server in (JServer(jindex, JParams(**full_budget()), max_batch=5,
                           telemetry=JTelemetry()),
                   SeismicServer(carry(jindex), SearchParams(**full_budget()),
                                 max_batch=5, telemetry=ServerTelemetry())):
        jq, pq = queries(np.random.default_rng(15), 12)
        server.search(jq if isinstance(server, JServer) else pq)
        server.swap_index(server.index)
        exports.append(server.telemetry)
    assert (_export_without_times(exports[1].export())
            == _export_without_times(exports[0].export()))
    assert exports[1].export()["latency_s"]["launch"]["count"] == 3
    snaps = [{k: (v["type"], v["help"], [s["labels"] for s in v["samples"]])
              for k, v in t.registry.snapshot().items()} for t in exports]
    assert snaps[1] == snaps[0]
    epochs = [t.registry.snapshot()["seismic_index_epoch"]["samples"]
              for t in exports]
    assert epochs[1] == epochs[0] == [{"labels": {}, "value": 1.0}]


def test_metrics_registry_matches_reference():
    """The same records into both registries export the same snapshot,
    histograms' quantiles included, and raise the same errors."""
    rng = np.random.default_rng(16)
    values = rng.lognormal(-6, 2, 200).tolist()
    snaps = []
    for reg in (JRegistry(), MetricsRegistry()):
        h = reg.histogram("lat_seconds", "latency", ("span",), lo=1e-5,
                          hi=10.0, n_buckets=40)
        for i, x in enumerate(values):
            h.labels("a" if i % 3 else "b").record(x)
        reg.counter("events_total", "events", ("event",)).labels(
            "x").inc(3)
        g = reg.gauge("depth", "depth").labels()
        g.set(4)
        reg.gauge("ratio").labels().set_fn(lambda: 0.25)
        reg.gauge("broken").labels().set_fn(lambda: 1 / 0)
        assert reg.counter("events_total", "events", ("event",)) is \
            reg.get("events_total")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("events_total")
        with pytest.raises(ValueError, match="invalid metric name"):
            reg.counter("bad name")
        with pytest.raises(ValueError, match="only go up"):
            reg.get("events_total").labels("x").inc(-1)
        snaps.append(reg.snapshot())
    assert snaps[1] == snaps[0]


# --------------------------------------------------------------- configs

def _arch_fields(arch):
    return dict(name=arch.name, index=dataclasses.asdict(arch.index),
                n_docs=arch.n_docs, dim=arch.dim, doc_nnz=arch.doc_nnz,
                query_nnz=arch.query_nnz, tuned=arch.tuned,
                family=arch.family)


def test_msmarco_config_matches_reference():
    for name in ("CONFIG", "REDUCED", "CONFIG_HIER", "REDUCED_HIER"):
        port = getattr(seismic_msmarco, name)
        want = getattr(jax_msmarco, name)
        got = _arch_fields(port)
        assert got == {**_arch_fields(want), "tuned": ()}, name
        np.testing.assert_array_equal(
            seismic_msmarco.estimated_live_blocks(port).numpy(),
            jax_msmarco.estimated_live_blocks(want))
    assert (seismic_msmarco.CONFIG_HIER.index.superblock_fanout
            == jax_msmarco.CONFIG_HIER.index.superblock_fanout == 8)
    assert [dataclasses.asdict(c) for c in seismic_msmarco.SHAPES] == \
        [dataclasses.asdict(c) for c in jax_msmarco.SHAPES]
    stats = np.array([0, 1, 2, 3, 30, 60])
    for arch in ("CONFIG", "REDUCED"):
        got = seismic_msmarco.with_suggested_fanout(
            getattr(seismic_msmarco, arch), torch.from_numpy(stats))
        want = jax_msmarco.with_suggested_fanout(getattr(jax_msmarco, arch),
                                                 stats)
        assert _arch_fields(got) == {**_arch_fields(want), "tuned": ()}
