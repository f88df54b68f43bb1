"""Port parity: the kernel wrappers of ``repro_torch.kernels``.

On the CPU a wrapper takes its kernel's plain version; those are held
against the JAX package's Pallas kernels in interpret mode
(``summary_dot_batch``, ``gather_dot_batch``, ``gather_dot_cand_batch``,
``router_flat_batch``, ``router_hier_batch``, ``refine_round_batch``)
at odd shapes, with all-padding rows, dead blocks and lists, sentinels
and all-sentinel tiles. Scores are ``allclose(rtol=1e-5, atol=1e-6)``
(summation order differs); -inf positions and integer outputs (flat
positions, frontier ids) are equal. ``flash_attention``'s plain version
is held against the JAX kernel over the JAX package's own sweep
(tests/test_kernels.py) at ``rtol=atol=2e-5`` in float32, the JAX
test's tolerance; in bf16 both compute in float32 and round the output
once, so they differ by at most one bf16 ulp (``rtol=2**-7``).

Tests marked ``gpu`` hold each CUDA kernel against its plain version on
the card and skip here (``python -m pytest -q -m gpu
--noconftest tests/test_torch_kernels.py`` on a CUDA host: the suite's
conftest and the JAX reference are not needed there, and JAX may be
absent, in which case only the ``gpu`` tests can run).
"""
import ctypes

import numpy as np
import pytest
import torch

try:    # the JAX reference (absent on a GPU host that runs only -m gpu)
    import jax.numpy as jnp

    from repro.kernels.flash_attention import flash_attention as jax_flash
    from repro.kernels.gather_dot.ops import \
        cand_tiles_processed as jax_tiles
    from repro.kernels.gather_dot.ops import gather_dot as jax_gather_dot_one
    from repro.kernels.gather_dot.ops import gather_dot_batch as jax_gather_dot
    from repro.kernels.gather_dot.ref import gather_dot_ref as jax_gather_ref
    from repro.kernels.gather_dot.ops import gather_dot_cand_batch as jax_cand
    from repro.kernels.refine_fused import refine_round_batch as jax_refine
    from repro.kernels.router_fused import router_flat_batch as jax_flat
    from repro.kernels.router_fused import router_hier_batch as jax_hier
    from repro.kernels.summary_dot.ops import summary_dot as jax_summary_one
    from repro.kernels.summary_dot.ops import summary_dot_batch as jax_summary
    from repro.kernels.summary_dot.ref import summary_dot_ref as jax_summary_ref
except ModuleNotFoundError:
    jnp = None
from repro_torch.kernels import row_tiles, runtime
from repro_torch.kernels.flash_attention.ops import (TMA_BOX_COLS, TMA_ROWS,
                                                     flash_attention,
                                                     flash_attention_ref,
                                                     route, tma_geometry,
                                                     wgmma_config)
from repro_torch.kernels.gather_dot.ops import (CAND_TILE_N, CAND_TILE_Q,
                                                cand_tiles_processed,
                                                gather_dot, gather_dot_batch,
                                                gather_dot_cand_batch)
from repro_torch.kernels.gather_dot.ref import (gather_dot_batch_ref,
                                                gather_dot_cand_ref,
                                                gather_dot_ref)
from repro_torch.kernels.refine_fused.ops import refine_round_batch
from repro_torch.kernels.refine_fused.ref import refine_round_ref
from repro_torch.core.build import sample_rep_pos
from repro_torch.core.types import SeismicConfig
from repro_torch.kernels.router_fused.ops import (flat_geometry,
                                                  hier_geometry,
                                                  router_flat_batch,
                                                  router_hier_batch)
from repro_torch.kernels.router_fused.ref import (router_flat_ref,
                                                  router_hier_ref)
from repro_torch.kernels.summary_dot.ops import geometry as summary_geometry
from repro_torch.kernels.summary_dot.ops import summary_dot, summary_dot_batch
from repro_torch.kernels.summary_dot.ref import (summary_dot_batch_ref,
                                                 summary_dot_ref)
from repro_torch.sparse.ops import take_rows
from repro_torch.sparse.quant import quantize_u8

RTOL, ATOL = 1e-5, 1e-6
VAL_KINDS = ("f32", "bf16", "u8")


def _t(a):
    return torch.from_numpy(np.array(a))


def _quantize(vals):
    """u8 levels, scale, zero as numpy (the port's quantize_u8, equal to
    the JAX one: tests/test_torch_sparse.py)."""
    return tuple(x.numpy() for x in quantize_u8(torch.from_numpy(vals)))


def assert_scores(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


def summary_inputs(qn, l, s, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.lognormal(0, 1, (qn, d)).astype(np.float32)
    q[rng.random((qn, d)) < 0.5] = 0.0
    coords = rng.integers(0, d, (qn, l, s)).astype(np.int32)
    vals = rng.lognormal(0, 1, (qn, l, s)).astype(np.float32)
    vals[rng.random((qn, l, s)) < 0.3] = 0.0
    vals[0, : max(l // 3, 1)] = 0.0                # all-padding summaries
    return (q, coords) + _quantize(vals)


def row_inputs(shape, d, kind, seed=0):
    """(coords, vals, scale, zero) numpy rows of one value kind; u8 rows
    come with uint16 coords, as a compact forward index stores them."""
    rng = np.random.default_rng(seed)
    coords = rng.integers(0, d, shape).astype(np.int32)
    vals = rng.lognormal(0, 1, shape).astype(np.float32)
    vals[rng.random(shape) < 0.25] = 0.0
    vals[(0,) * (len(shape) - 1)] = 0.0            # an all-padding row
    if kind == "u8":
        return (coords.astype(np.uint16),) + _quantize(vals)
    if kind == "bf16":    # bf16 values, rounded, kept as float32 here
        return coords, torch.from_numpy(vals).bfloat16().float().numpy(), \
            "bf16", None
    return coords, vals, None, None


def as_jax(coords, vals, scale, zero):
    if isinstance(scale, str):      # the "bf16" marker
        return (jnp.asarray(coords), jnp.asarray(vals, jnp.bfloat16), None,
                None)
    return (jnp.asarray(coords.astype(np.int32)), jnp.asarray(vals),
            None if scale is None else jnp.asarray(scale),
            None if zero is None else jnp.asarray(zero))


def as_torch(coords, vals, scale, zero):
    if isinstance(scale, str):      # the "bf16" marker
        return _t(coords), _t(vals).bfloat16(), None, None
    return (_t(coords), _t(vals), None if scale is None else _t(scale),
            None if zero is None else _t(zero))


def cand_inputs(qn, c, n_docs, seed=0):
    """Compacted candidate ids: a live sorted prefix per query, then
    sentinels; some queries have none (all-sentinel rows and tiles)."""
    rng = np.random.default_rng(seed)
    cand = np.full((qn, c), n_docs, np.int32)
    for q in range(qn):
        live = 0 if q % 3 == 0 else int(rng.integers(1, min(c, n_docs) + 1))
        cand[q, :live] = np.sort(rng.choice(n_docs, live, replace=False))
    return cand


def sparse_queries(qn, d, seed=0):
    """(q_dense [qn, d], pool): queries of 48 non-zeros each, as
    prep_queries makes them, drawn from a pool of 512 coordinates that
    holds the whole last partial 32-coordinate word of d; one non-zero of
    each query is -0.0. Rows over the pool hit about one lookup in ten."""
    rng = np.random.default_rng(seed)
    tail = np.arange(d - d % 32, d)
    pool = np.concatenate([np.sort(rng.choice(d - d % 32, 512 - tail.size,
                                              replace=False)), tail])
    q = np.zeros((qn, d), np.float32)
    for i in range(qn):
        cols = rng.choice(pool, 48, replace=False)
        q[i, cols] = rng.lognormal(0, 1, cols.size)
        q[i, cols[0]] = -0.0
    return q, pool.astype(np.int32)


@pytest.mark.parametrize("qn,l,s,d", [
    (8, 128, 32, 512), (3, 37, 17, 300), (1, 5, 96, 64), (13, 260, 33, 1000)])
def test_summary_dot_plain_matches_pallas(qn, l, s, d):
    q, coords, u8, scale, zero = summary_inputs(qn, l, s, d, seed=qn + l)
    want = jax_summary(jnp.asarray(q), jnp.asarray(coords), jnp.asarray(u8),
                       jnp.asarray(scale), jnp.asarray(zero))
    got = summary_dot_batch(_t(q), _t(coords), _t(u8), _t(scale), _t(zero))
    assert_scores(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cut,nb,s,d", [(8, 12, 32, 1024), (1, 4, 8, 128),
                                        (16, 20, 64, 4096)])
def test_summary_dot_single_query_shim_matches_jax(cut, nb, s, d):
    """``summary_dot`` (Q = 1 through the batched wrapper) and
    ``summary_dot_ref`` against the JAX package's shim and oracle, on the
    JAX sweep's shapes (tests/test_kernels.py)."""
    q, coords, u8, scale, zero = summary_inputs(1, cut * nb, s, d,
                                                seed=cut * nb)
    args = (q[0], coords.reshape(cut, nb, s), u8.reshape(cut, nb, s),
            scale.reshape(cut, nb), zero.reshape(cut, nb))
    want = jax_summary_one(*map(jnp.asarray, args))
    assert_scores(summary_dot(*map(_t, args)).numpy(), np.asarray(want))
    assert_scores(summary_dot_ref(*map(_t, args)).numpy(),
                  np.asarray(jax_summary_ref(*map(jnp.asarray, args))))


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("n,nnz,d", [(128, 16, 512), (256, 96, 4096),
                                     (384, 33, 1000), (5, 8, 64)])
def test_gather_dot_single_query_shim_matches_jax(n, nnz, d, kind):
    """``gather_dot`` (Q = 1 through the batched wrapper) and
    ``gather_dot_ref`` against the JAX package's shim and oracle, on the
    JAX sweep's shapes, float32 queries."""
    q = np.random.default_rng(n + nnz).lognormal(0, 1, d).astype(np.float32)
    coords, vals, _, _ = row_inputs((n, nnz), d, kind, seed=n)
    jc, jv, _, _ = as_jax(coords, vals, "bf16" if kind == "bf16" else None,
                          None)
    tc, tv, _, _ = as_torch(coords, vals, "bf16" if kind == "bf16" else None,
                            None)
    want = jax_gather_dot_one(jnp.asarray(q), jc, jv)
    assert_scores(gather_dot(_t(q), tc, tv).numpy(), np.asarray(want))
    assert_scores(gather_dot_ref(_t(q), tc, tv).numpy(),
                  np.asarray(jax_gather_ref(jnp.asarray(q), jc, jv)))


@pytest.mark.parametrize("kind", VAL_KINDS)
@pytest.mark.parametrize("qn,n,nnz,d", [
    (8, 128, 16, 512), (3, 37, 17, 300), (1, 5, 8, 64), (5, 70, 24, 777)])
def test_gather_dot_plain_matches_pallas(qn, n, nnz, d, kind):
    q = np.random.default_rng(n).lognormal(0, 1, (qn, d)).astype(np.float32)
    rows = row_inputs((qn, n, nnz), d, kind, seed=qn * n)
    want = jax_gather_dot(jnp.asarray(q), *as_jax(*rows))
    got = gather_dot_batch(_t(q), *as_torch(*rows))
    assert_scores(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", VAL_KINDS)
@pytest.mark.parametrize("qn,c,n_docs,nnz,d", [
    (6, 70, 300, 24, 500), (3, 256, 1000, 16, 700), (1, 33, 40, 48, 128)])
def test_gather_dot_cand_plain_matches_pallas(qn, c, n_docs, nnz, d, kind):
    q = np.random.default_rng(c).lognormal(0, 1, (qn, d)).astype(np.float32)
    fc, fv, fs, fz = row_inputs((n_docs, nnz), d, kind, seed=n_docs)
    cand = cand_inputs(qn, c, n_docs, seed=qn)
    jfc, jfv, jfs, jfz = as_jax(fc, fv, fs, fz)
    want = jax_cand(jnp.asarray(q), jnp.asarray(cand), jfc, jfv, jfs, jfz,
                    n_docs=n_docs)
    tfc, tfv, tfs, tfz = as_torch(fc, fv, fs, fz)
    got = gather_dot_cand_batch(_t(q), _t(cand), tfc, tfv, tfs, tfz,
                                n_docs=n_docs)
    assert_scores(got.numpy(), np.asarray(want))
    assert np.isneginf(got.numpy()[cand >= n_docs]).all()


@pytest.mark.parametrize("qn,c", [(5, 70), (4, 64), (1, 1), (7, 129)])
def test_cand_tiles_processed_mirrors_the_skip_predicate(qn, c):
    """The mirror marks a tile live iff one of its ids is live — the
    kernel's __syncthreads_or over its CAND_TILE_N ids — and agrees with
    the JAX mirror evaluated at the port's tile."""
    n_docs = 50
    cand = cand_inputs(qn, c, n_docs, seed=c)
    got = cand_tiles_processed(_t(cand), n_docs).numpy()
    gq, gn = -(-qn // CAND_TILE_Q), -(-c // CAND_TILE_N)
    want = np.zeros((gq, gn), bool)
    for q in range(qn):
        for n in range(c):
            if cand[q, n] < n_docs:
                want[q // CAND_TILE_Q, n // CAND_TILE_N] = True
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jax_tiles(cand, n_docs, CAND_TILE_Q, CAND_TILE_N))


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(2, 10)
    c = torch.zeros(2, 3, 4, dtype=torch.int32)
    v = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="int32 or uint16"):
        gather_dot_batch(q, c.long(), v)
    with pytest.raises(ValueError, match="uint8"):
        gather_dot_batch(q, c, v.to(torch.uint8))       # u8 without scale
    with pytest.raises(ValueError, match="f32"):
        gather_dot_batch(q.double(), c, v)
    with pytest.raises(ValueError, match="batch"):
        summary_dot_batch(q[:1], c, v.to(torch.uint8), torch.zeros(2, 3),
                          torch.zeros(2, 3))
    with pytest.raises(ValueError, match="n_docs"):
        gather_dot_cand_batch(q, torch.zeros(2, 5, dtype=torch.int32),
                              c[0], v[0], n_docs=7)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        runtime.use_plain(q, q.to("meta"))


def test_plain_path_counts_no_launch():
    runtime.reset_launches()
    q, coords, u8, scale, zero = summary_inputs(2, 9, 8, 50)
    summary_dot_batch(_t(q), _t(coords), _t(u8), _t(scale), _t(zero))
    q, k, v = attention_inputs(1, 2, 1, 9, 16)
    flash_attention(_t(q), _t(k), _t(v))
    assert runtime.LAUNCHES == {"summary_dot": 0, "gather_dot": 0,
                                "gather_dot_cand": 0, "router_flat": 0,
                                "router_hier": 0, "refine_round": 0,
                                "flash_attention": 0,
                                "router_flat_groups": 0,
                                "router_flat_records": 0}


def test_kernel_sources_are_registered_and_hashed():
    for name, src in runtime.SOURCES.items():
        assert src.exists(), src
        assert runtime.library_path(name).parent == runtime.BUILD_DIR
        assert src.read_text().count("Replaces") == 1


def tier_planes(l, n, s, d, seed):
    """Random quantized summary planes [L, n, S] (coords, u8, scale,
    zero) as numpy; about a third of the entries are padding."""
    rng = np.random.default_rng(seed)
    vals = rng.lognormal(0, 1, (l, n, s)).astype(np.float32)
    vals[rng.random((l, n, s)) < 0.3] = 0.0
    return (rng.integers(0, d, (l, n, s)).astype(np.int32),) \
        + _quantize(vals)


def router_inputs(qn, cut, l, nb, s, d, seed, ns=None, s2=None):
    """(lists, q, block planes..., block_len[, superblock planes]) with
    dead blocks, a dead list (0) and repeated probes."""
    rng = np.random.default_rng(seed)
    q = rng.lognormal(0, 1, (qn, d)).astype(np.float32)
    q[rng.random((qn, d)) < 0.5] = 0.0
    lists = rng.integers(0, l, (qn, cut)).astype(np.int32)
    lists[0, :] = 0                                  # every probe dead
    lists[-1, 1] = lists[-1, 0]                      # a repeated probe
    block_len = rng.integers(0, 3, (l, nb)).astype(np.int32)
    block_len[0] = 0
    out = (lists, q) + tier_planes(l, nb, s, d, seed + 1) + (block_len,)
    if ns is not None:
        out += tier_planes(l, ns, s2, d, seed + 2)
    return out


FLAT_SHAPES = [(4, 3, 9, 7, 16, 300), (1, 8, 20, 33, 5, 64),
               (6, 2, 5, 12, 40, 1000)]


@pytest.mark.parametrize("qn,cut,l,nb,s,d", FLAT_SHAPES)
def test_router_flat_plain_matches_pallas(qn, cut, l, nb, s, d):
    lists, q, sc, sq, ss, sz, bl = router_inputs(qn, cut, l, nb, s, d, nb)
    want = jax_flat(*map(jnp.asarray, (lists, q, sc, sq, ss, sz, bl)))
    got = router_flat_batch(*map(_t, (lists, q, sc, sq, ss, sz, bl)))
    assert got.shape == (qn, cut * nb)
    assert_scores(got.numpy(), np.asarray(want))
    assert np.isneginf(got.numpy()[0]).all()


HIER_SHAPES = [(4, 3, 9, 7, 16, 300, 3, 2), (2, 5, 20, 33, 5, 64, 17, 4),
               (5, 2, 6, 16, 24, 500, 8, 1), (3, 4, 11, 9, 8, 200, 1, 9)]


@pytest.mark.parametrize("qn,cut,l,nb,s,d,m,f", HIER_SHAPES)
def test_router_hier_plain_matches_pallas(qn, cut, l, nb, s, d, m, f):
    ns = -(-nb // f)
    args = router_inputs(qn, cut, l, nb, s, d, nb + f, ns=ns, s2=2 * s)
    lists, q, sc, sq, ss, sz, bl, pc, pq, ps, pz = args
    order = (lists, q, pc, pq, ps, pz, sc, sq, ss, sz, bl)
    want_rb, want_flat = jax_hier(*map(jnp.asarray, order), m=m, fanout=f)
    rb, flat = router_hier_batch(*map(_t, order), m=m, fanout=f)
    assert rb.shape == flat.shape == (qn, m * f)
    assert flat.dtype == torch.int32
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want_flat))
    assert_scores(rb.numpy(), np.asarray(want_rb))
    assert np.isneginf(rb.numpy()[0]).all()


def refine_inputs(qn, k, w, n_docs, deg, nnz, d, kind, seed):
    """(ids, scored, q, knn, fwd_coords, fwd_vals, fwd_scale, fwd_zero):
    -1 padded ids, repeated ids, sentinel edges, and a seen set that
    holds some of the neighbours."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_docs, (qn, k)).astype(np.int32)
    ids[0, k // 2:] = -1
    if qn > 1:
        ids[-1, :] = -1
        ids[1 % (qn - 1), 1] = ids[1 % (qn - 1), 0]
    knn = rng.integers(0, n_docs, (n_docs, deg)).astype(np.int32)
    knn[rng.random((n_docs, deg)) < 0.1] = n_docs     # missing edges
    scored = np.full((qn, w), n_docs, np.int32)
    scored[:, :k] = np.where(ids >= 0, ids, n_docs)[:, :w]
    scored[:, k:] = rng.integers(0, n_docs, (qn, max(w - k, 0)))
    if w - k >= deg:
        scored[0, k:k + deg] = knn[max(ids[0, 0], 0), :deg]
    q = rng.lognormal(0, 1, (qn, d)).astype(np.float32)
    return (ids, scored, q, knn) + row_inputs((n_docs, nnz), d, kind,
                                              seed=seed + 1)


REFINE_SHAPES = [(5, 4, 20, 60, 3, 2, 16, 300), (3, 10, 10, 200, 8, 8, 24,
                                                 500),
                 (1, 3, 7, 9, 5, 5, 8, 64)]


@pytest.mark.parametrize("kind", VAL_KINDS)
@pytest.mark.parametrize("qn,k,w,n_docs,deg,degree,nnz,d", REFINE_SHAPES)
def test_refine_round_plain_matches_pallas(qn, k, w, n_docs, deg, degree,
                                           nnz, d, kind):
    ids, scored, q, knn, *plane = refine_inputs(qn, k, w, n_docs, deg, nnz,
                                                d, kind, seed=n_docs + k)
    jplane = as_jax(*plane)
    want_c, want_s = jax_refine(*map(jnp.asarray, (ids, scored, q, knn)),
                                *jplane, n_docs=n_docs, degree=degree)
    tplane = as_torch(*plane)
    cand, scores = refine_round_batch(*map(_t, (ids, scored, q, knn)),
                                      *tplane, n_docs=n_docs, degree=degree)
    assert cand.dtype == torch.int32 and cand.shape == (qn, k * degree)
    np.testing.assert_array_equal(cand.numpy(), np.asarray(want_c))
    assert_scores(scores.numpy(), np.asarray(want_s))
    c = cand.numpy()
    assert (np.diff(c, axis=1) >= 0).all()            # sorted prefix
    assert np.isneginf(scores.numpy()[c >= n_docs]).all()


def test_fused_wrappers_reject_what_the_kernels_do_not_take():
    lists, q, sc, sq, ss, sz, bl = map(_t, router_inputs(2, 3, 5, 4, 8, 50,
                                                         1))
    with pytest.raises(ValueError, match="lists must be int32"):
        router_flat_batch(lists.long(), q, sc, sq, ss, sz, bl)
    with pytest.raises(ValueError, match="block_len"):
        router_flat_batch(lists, q, sc, sq, ss, sz, bl[:, :2])
    with pytest.raises(ValueError, match=r"m=7 must lie"):
        router_hier_batch(lists, q, sc[:, :2], sq[:, :2], ss[:, :2],
                          sz[:, :2], sc, sq, ss, sz, bl, m=7, fanout=2)
    with pytest.raises(ValueError, match="do not group"):
        router_hier_batch(lists, q, sc[:, :3], sq[:, :3], ss[:, :3],
                          sz[:, :3], sc, sq, ss, sz, bl, m=2, fanout=2)
    ids, scored, qq, knn, *plane = map(
        lambda x: x if x is None or isinstance(x, str) else _t(x),
        refine_inputs(2, 3, 5, 20, 4, 8, 50, "f32", 0))
    fc, fv = plane[0], plane[1]
    with pytest.raises(ValueError, match="degree 5"):
        refine_round_batch(ids, scored, qq, knn, fc, fv, n_docs=20,
                           degree=5)
    with pytest.raises(ValueError, match="int32"):
        refine_round_batch(ids.long(), scored, qq, knn, fc, fv, n_docs=20,
                           degree=2)
    with pytest.raises(ValueError, match="knn_ids"):
        refine_round_batch(ids, scored, qq, knn[:5], fc, fv, n_docs=20,
                           degree=2)


def test_library_path_hashes_the_shared_headers(tmp_path, monkeypatch):
    """Every retrieval source includes the shared row dot; editing a
    shared header changes every library's file name, so each source
    rebuilds."""
    assert "-I" in runtime.NVCC_FLAGS
    assert str(runtime.INCLUDE_DIR) in runtime.NVCC_FLAGS
    for name, src in runtime.SOURCES.items():
        if name != "flash_attention":       # no row dot in attention
            assert '#include "row_dot.cuh"' in src.read_text(), src
    for h in runtime.INCLUDE_DIR.glob("*.cuh"):
        (tmp_path / h.name).write_bytes(h.read_bytes())
    monkeypatch.setattr(runtime, "INCLUDE_DIR", tmp_path)
    before = {n: runtime.library_path(n) for n in runtime.SOURCES}
    header = tmp_path / "row_dot.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: runtime.library_path(n) for n in runtime.SOURCES}
    assert all(before[n] != after[n] for n in runtime.SOURCES)
    assert len(set(after.values())) == len(runtime.SOURCES)


@pytest.mark.parametrize("qn,sms,c", [(256, 132, 1), (4096, 132, 1),
                                      (128, 132, 1), (66, 132, 2),
                                      (64, 132, 2), (67, 132, 1),
                                      (33, 132, 4), (32, 132, 4),
                                      (17, 132, 4), (16, 132, 8),
                                      (8, 132, 8), (1, 132, 8), (8, 16, 2),
                                      (2, 16, 8), (17, 16, 1)])
def test_cluster_size_fills_one_wave(qn, sms, c):
    """router_hier's blocks per query: a power of two up to 8, the most
    whose qn * C blocks have an SM each (8 for an online batch of 8, 1
    for a server's 256 on 132 SMs)."""
    assert row_tiles.cluster_size(qn, sms) == c
    assert c == 1 or qn * c <= sms
    assert c == row_tiles.MAX_CLUSTER or qn * 2 * c > sms


def test_row_tiles_caps_raise():
    """d beyond the bitmap's cap, or shapes whose ring and sort overflow a
    block's shared memory, raise (the wrappers call these before a
    launch); nothing falls back."""
    row_tiles.check_dim("k", row_tiles.MAX_DIM)
    with pytest.raises(ValueError, match="dimension"):
        row_tiles.check_dim("k", row_tiles.MAX_DIM + 1)
    row_tiles.check_smem("k", row_tiles.SMEM_MAX)
    with pytest.raises(ValueError, match="shared memory"):
        row_tiles.check_smem("k", row_tiles.SMEM_MAX + 1)


def test_read_geometry_names_the_exported_values_and_raises_on_error():
    """A library's geometry export fills an int array in the order of the
    keys; a non-zero return (shapes it refuses) raises."""
    def export(l, s, out):
        if s < 1:
            return 1
        out[0], out[1] = l * 2, s + 1
        return 0

    assert row_tiles.read_geometry("k", export, ("a", "b"), 5, 3) == \
        {"a": 10, "b": 4}
    with pytest.raises(ValueError, match="k: the kernel's geometry refuses"):
        row_tiles.read_geometry("k", export, ("a", "b"), 5, 0)


# ------------------------------------------------------ flash_attention

def attention_inputs(b, h, hkv, s, dh, seed=0, sk=None):
    """q [b, h, s, dh], k/v [b, hkv, sk, dh], float32 standard normal."""
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    return (rng.standard_normal((b, h, s, dh)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, dh)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, dh)).astype(np.float32))


@pytest.mark.parametrize("b,h,hkv,s,dh", [(1, 4, 4, 128, 64),
                                          (2, 8, 2, 256, 64),
                                          (1, 2, 1, 200, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_pallas(b, h, hkv, s, dh, causal):
    q, k, v = attention_inputs(b, h, hkv, s, dh, seed=s + h)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_flash_attention_plain_matches_pallas_window():
    q, k, v = attention_inputs(1, 2, 2, 256, 64, seed=5)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, window=64)
    got = flash_attention(_t(q), _t(k), _t(v), causal=True, window=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_flash_attention_plain_matches_pallas_bf16():
    q, k, v = (jnp.asarray(x, jnp.bfloat16)
               for x in attention_inputs(1, 4, 2, 128, 64, seed=9))
    want = np.asarray(jax_flash(q, k, v, causal=True), np.float32)
    tq, tk, tv = (_t(np.asarray(x, np.float32)).bfloat16()
                  for x in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)


def test_flash_attention_plain_zeroes_rows_without_a_live_key():
    """Without causality, a window leaves rows q >= Sk + window - 1 with no
    live key: they are 0 (the kernel's l == 0 guard), the rest is the
    softmax over the live keys."""
    q, k, v = (_t(x) for x in attention_inputs(1, 2, 1, 20, 16, sk=8))
    out = flash_attention(q, k, v, causal=False, window=4)
    assert torch.count_nonzero(out[:, :, 11:]) == 0
    s = (q[0, 0, 5] @ k[0, 0].T) * 16 ** -0.5
    live = torch.arange(8) > 5 - 4
    p = torch.softmax(s.masked_fill(~live, float("-inf")), -1)
    torch.testing.assert_close(out[0, 0, 5], p @ v[0, 0], rtol=1e-5,
                               atol=1e-6)


def test_flash_attention_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (_t(x) for x in attention_inputs(1, 4, 2, 8, 16))
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="shapes differ"):
        flash_attention(q, k, v[:, :, :5])
    with pytest.raises(ValueError, match="one dtype"):
        flash_attention(q, k.double(), v.double())
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        flash_attention(q, k.to("meta"), v)
    # D outside the kernel's set is refused only on CUDA tensors
    q5, k5, v5 = (_t(x) for x in attention_inputs(1, 2, 2, 8, 24))
    assert flash_attention(q5, k5, v5).shape == (1, 2, 8, 24)


def test_flash_attention_route_and_tiles():
    """bf16 heads of 64 and 128 take the TMA + wgmma kernel in 128-row q
    tiles; bf16 16/32/112 the mma.sync kernel and float32 the FMA kernel,
    in 64-row tiles."""
    assert route(torch.bfloat16, 128) == ("wgmma", 128)
    assert route(torch.bfloat16, 64) == ("wgmma", 128)
    assert route(torch.bfloat16, 112) == ("mma_sync", 64)
    assert route(torch.float32, 112) == ("fma", 64)
    assert route(torch.bfloat16, 32) == ("mma_sync", 64)
    assert route(torch.bfloat16, 16) == ("mma_sync", 64)
    assert route(torch.float32, 128) == ("fma", 64)


@pytest.mark.parametrize("b,s,h,d", [(2, 100, 8, 128), (1, 8192, 32, 128),
                                     (3, 77, 2, 64)])
def test_tma_geometry_reads_projection_views_in_place(b, s, h, d):
    """A [B, S, H, D] projection viewed as [B, H, S, D]: dims (D, S, H, B),
    byte strides of S (H D 2), H (D 2) and B (S H D 2), boxes of 64
    columns x 128 rows; a contiguous copy has the dense strides."""
    x = torch.zeros(b, s, h, d, dtype=torch.bfloat16).transpose(1, 2)
    geo = tma_geometry(x)
    assert geo == (d, s, h, b, h * d * 2, d * 2, s * h * d * 2, 64, 128, 1, 1)
    assert tma_geometry(x.contiguous()) == (
        d, s, h, b, d * 2, s * d * 2, h * s * d * 2, 64, 128, 1, 1)


def test_tma_geometry_replaces_a_size_one_dims_stride():
    """A size-1 dim addresses nothing: its stride (here 1 element, not a
    multiple of 16 bytes) is replaced by the dense one, here and in the
    wrapper's in-place check."""
    x = torch.zeros(1, 4, 1, 64, dtype=torch.bfloat16).transpose(0, 2)
    assert x.shape == (1, 4, 1, 64) and x.stride(0) == 64
    weird = torch.zeros(4, 1, 64, dtype=torch.bfloat16).as_strided(
        (1, 4, 1, 64), (1, 64, 1, 1))
    assert tma_geometry(weird)[4:7] == (128, 128, 512)


def test_tma_geometry_raises_on_strides_tma_cannot_take():
    base = torch.zeros(2, 4, 100, 136, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 64"):
        tma_geometry(base[..., :72])                 # D 72
    assert tma_geometry(base[..., 8:72])[4] == 272   # 272-byte rows: ok
    rows = torch.zeros(2, 4, 100, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="byte strides"):
        tma_geometry(rows)                           # 136-byte rows
    with pytest.raises(ValueError, match="contiguous"):
        tma_geometry(torch.zeros(2, 4, 64, 100,
                                 dtype=torch.bfloat16).transpose(2, 3))
    flat = torch.zeros(2 * 4 * 100 * 64 + 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tma_geometry(flat[1:1 + 2 * 4 * 100 * 64].view(2, 4, 100, 64))
    with pytest.raises(ValueError, match="bf16"):
        tma_geometry(torch.zeros(2, 4, 100, 64))


# ----------------------------------------------------------- on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on an H100 host)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_summary_dot_kernel_matches_plain_on_card():
    dev = _cuda()
    args = [_t(x).to(dev) for x in summary_inputs(16, 600, 96, 30522)]
    before = runtime.LAUNCHES["summary_dot"]
    got = summary_dot_batch(*args)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["summary_dot"] == before + 1
    assert_scores(got.cpu().numpy(), summary_dot_batch_ref(*args).cpu())


@pytest.mark.gpu
def test_single_query_shims_launch_the_batched_kernels_on_card():
    """``summary_dot`` and ``gather_dot`` with Q = 1 launch kernels a and
    b once each and agree with their single-query plain versions."""
    dev = _cuda()
    q, coords, u8, scale, zero = summary_inputs(1, 12 * 40, 96, 30522)
    args = [_t(q[0]).to(dev)] + [_t(x.reshape(12, 40, *x.shape[2:])).to(dev)
                                 for x in (coords, u8, scale, zero)]
    before = dict(runtime.LAUNCHES)
    got = summary_dot(*args)
    q32 = _t(np.random.default_rng(4).lognormal(0, 1, 30522)
             .astype(np.float32)).to(dev)
    rc, rv, _, _ = as_torch(*row_inputs((700, 128), 30522, "f32"))
    scores = gather_dot(q32, rc.to(dev), rv.to(dev))
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["summary_dot"] == before["summary_dot"] + 1
    assert runtime.LAUNCHES["gather_dot"] == before["gather_dot"] + 1
    assert_scores(got.cpu().numpy(), summary_dot_ref(*args).cpu())
    assert_scores(scores.cpu().numpy(),
                  gather_dot_ref(q32, rc.to(dev), rv.to(dev)).cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", VAL_KINDS)
def test_gather_dot_kernel_matches_plain_on_card(kind):
    dev = _cuda()
    q = _t(np.random.default_rng(1).lognormal(0, 1, (16, 30522))
           .astype(np.float32)).to(dev)
    rows = [None if x is None else x.to(dev)
            for x in as_torch(*row_inputs((16, 513, 128), 30522, kind))]
    got = gather_dot_batch(q, *rows)
    torch.cuda.synchronize()
    assert_scores(got.cpu().numpy(), gather_dot_batch_ref(q, *rows).cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", VAL_KINDS)
def test_gather_dot_cand_kernel_matches_plain_on_card(kind):
    dev = _cuda()
    n_docs = 5000
    q = _t(np.random.default_rng(2).lognormal(0, 1, (9, 30522))
           .astype(np.float32)).to(dev)
    plane = [None if x is None else x.to(dev)
             for x in as_torch(*row_inputs((n_docs, 128), 30522, kind))]
    cand = _t(cand_inputs(9, 1000, n_docs)).to(dev)
    got = gather_dot_cand_batch(q, cand, *plane, n_docs=n_docs)
    torch.cuda.synchronize()
    assert_scores(got.cpu().numpy(),
                  gather_dot_cand_ref(q, cand, *plane, n_docs).cpu())
    # same row dot as the batch kernel: bitwise equal scores
    idx = cand.long().clamp(max=n_docs - 1)
    fs, fz = plane[2:]
    batch = gather_dot_batch(q, take_rows(plane[0], idx), plane[1][idx],
                             None if fs is None else fs[idx],
                             None if fz is None else fz[idx])
    live = cand < n_docs
    assert torch.equal(got[live], batch[live])


@pytest.mark.gpu
def test_router_flat_kernel_matches_plain_and_summary_dot_on_card():
    dev = _cuda()
    args = [_t(x).to(dev) for x in router_inputs(16, 8, 300, 494, 96,
                                                  30522, 5)]
    before = runtime.LAUNCHES["router_flat"]
    got = router_flat_batch(*args)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["router_flat"] == before + 1
    assert_scores(got.cpu().numpy(), router_flat_ref(*args).cpu())
    # the same row dot as summary_dot: bitwise equal live scores
    lists, q, sc, sq, ss, sz, bl = args
    li = lists.long()
    qn = lists.shape[0]
    unfused = summary_dot_batch(q, sc[li].reshape(qn, -1, 96),
                                sq[li].reshape(qn, -1, 96),
                                ss[li].reshape(qn, -1), sz[li].reshape(qn, -1))
    live = torch.isfinite(got)
    assert torch.equal(got[live], unfused[live])


@pytest.mark.gpu
@pytest.mark.parametrize("m,f", [(32, 8), (5, 3)])
def test_router_hier_kernel_matches_plain_on_card(m, f):
    dev = _cuda()
    nb = 494
    ns = -(-nb // f)
    args = [_t(x).to(dev) for x in router_inputs(
        16, 8, 300, nb, 96, 30522, 6, ns=ns, s2=96 * f)]
    lists, q, sc, sq, ss, sz, bl, pc, pq, ps, pz = args
    order = (lists, q, pc, pq, ps, pz, sc, sq, ss, sz, bl)
    before = runtime.LAUNCHES["router_hier"]
    rb, flat = router_hier_batch(*order, m=m, fanout=f)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["router_hier"] == before + 1
    want_rb, want_flat = router_hier_ref(*order, m=m, fanout=f)
    assert torch.equal(flat, want_flat)
    assert_scores(rb.cpu().numpy(), want_rb.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", VAL_KINDS)
def test_refine_round_kernel_matches_plain_on_card(kind):
    dev = _cuda()
    ids, scored, q, knn, *plane = refine_inputs(64, 10, 90, 5000, 12,
                                                128, 30522, kind, 3)
    args = [_t(x).to(dev) for x in (ids, scored, q, knn)]
    tplane = [None if x is None else x.to(dev) for x in as_torch(*plane)]
    before = runtime.LAUNCHES["refine_round"]
    cand, scores = refine_round_batch(*args, *tplane, n_docs=5000, degree=8)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["refine_round"] == before + 1
    want_c, want_s = refine_round_ref(*args, *tplane, 5000, 8)
    assert torch.equal(cand, want_c)
    assert_scores(scores.cpu().numpy(), want_s.cpu())
    # the same row dot as gather_dot_cand: bitwise equal scores
    assert torch.equal(scores, gather_dot_cand_batch(
        args[2], cand, *tplane, n_docs=5000))


def assert_attention_close(got, want, q, k, v, *, causal, window=None):
    """bf16 kernel against plain, element by element: P enters P V in
    bf16, which moves each term p_j v_j by at most 2^-9 of itself, so an
    output by at most r = 2^-9 sum_j p_j |v_j| / sum_j p_j (the plain
    version on |v| in float32; twice r leaves room for the float32
    sums), and both outputs round to bf16, one ulp (2^-7 relative)
    apart: |k - p| <= 2^-7 |p| + 2 r."""
    r = 2 ** -9 * flash_attention_ref(q.float(), k.float(), v.float().abs(),
                                      causal=causal, window=window)
    err = (got.float() - want.float()).abs()
    tol = 2 ** -7 * want.float().abs() + 2 * r
    assert bool(torch.isfinite(got).all())
    assert bool((err <= tol).all()), (
        f"{int((err > tol).sum())} elements beyond tolerance, worst at "
        f"{float((err / tol.clamp_min(1e-30)).max()):.2f}x it")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("dh", [16, 32, 64, 112, 128])
@pytest.mark.parametrize("case", ["causal-gqa", "window", "noncausal",
                                  "ragged-sk"])
def test_flash_attention_kernel_matches_plain_on_card(dtype, dh, case):
    """Kernel against plain on the card. float32: rtol=atol=2e-5 (FMA in
    another order). bf16: ``assert_attention_close``."""
    dev = _cuda()
    b, h, hkv, s, sk, causal, window = {
        "causal-gqa": (2, 8, 2, 200, None, True, None),
        "window": (1, 4, 4, 300, None, True, 64),
        "noncausal": (1, 4, 1, 130, None, False, None),
        "ragged-sk": (1, 2, 2, 77, 45, False, 16)}[case]
    tdt = getattr(torch, dtype)
    q, k, v = (_t(x).to(dev, tdt) for x in attention_inputs(
        b, h, hkv, s, dh, seed=dh, sk=sk))
    before = runtime.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["flash_attention"] == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        assert_attention_close(got, want, q, k, v, causal=causal,
                               window=window)


@pytest.mark.gpu
def test_flash_attention_kernel_reads_strided_projections_on_card():
    """[B, S, H, D] projections passed as [B, H, S, D] views are read in
    place; a 24-wide head is refused."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(2, 100, 8, 64, generator=g, device=dev).bfloat16()
    kv = torch.randn(2, 100, 2, 64, generator=g, device=dev).bfloat16()
    q, k = x.transpose(1, 2), kv.transpose(1, 2)
    got = flash_attention(q, k, k, causal=True)
    want = flash_attention_ref(q.contiguous(), k.contiguous(),
                               k.contiguous(), causal=True)
    assert_attention_close(got, want, q, k, k, causal=True)
    bad = torch.zeros(1, 2, 8, 24, device=dev)
    with pytest.raises(ValueError, match="head dim 24"):
        flash_attention(bad, bad, bad)


@pytest.mark.gpu
def test_flash_attention_d112_reads_kimi_projections_on_card():
    """kimi-k2's heads (D 112, 64 q heads over 8 kv heads) as [B, S, H, D]
    projections viewed [B, H, S, D]: 224-byte rows read in place by the
    mma.sync kernel, one launch, against the plain version."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(1, 300, 64, 112, generator=g, device=dev).bfloat16()
    kv = torch.randn(1, 300, 8, 112, generator=g, device=dev).bfloat16()
    q, k = x.transpose(1, 2), kv.transpose(1, 2)
    before = runtime.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, k, causal=True)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["flash_attention"] == before + 1
    want = flash_attention_ref(q.contiguous(), k.contiguous(),
                               k.contiguous(), causal=True)
    assert_attention_close(got, want, q, k, k, causal=True)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [64, 128])
def test_flash_attention_wgmma_build_and_box_on_card(dh):
    """The kernel as built: its tiles and box are the wrapper's, its
    dynamic shared memory fits a block of this card; a launch with any
    other box is refused (it would never complete its barriers) and
    counts nothing."""
    from repro_torch.kernels.flash_attention import ops
    dev = _cuda()
    cfg = wgmma_config(dh)
    assert (cfg["block_q"], cfg["block_k"], cfg["box_cols"]) == (
        TMA_ROWS, TMA_ROWS, TMA_BOX_COLS)
    assert cfg["threads"] == 3 * 128
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    assert 0 < cfg["smem_bytes"] <= optin
    q = torch.zeros(1, 2, 200, dh, device=dev, dtype=torch.bfloat16)
    o = torch.empty_like(q)
    for rows in (64, 256):
        geo = [x for _ in range(3) for x in tma_geometry(q)]
        for t in range(3):
            geo[11 * t + 8] = rows
        geometry = (ctypes.c_longlong * 33)(*geo)
        o_strides = (ctypes.c_longlong * 3)(*q.stride()[:3])
        err = ops._lib().flash_attention_wgmma_launch(
            *(runtime.ptr(t) for t in (q, q, q, o)), 1, 2, 2, 200, 200, dh,
            ctypes.cast(geometry, ctypes.c_void_p),
            ctypes.cast(o_strides, ctypes.c_void_p), dh ** -0.5, 1, 0,
            runtime.stream_of(q))
        assert err == 1                     # cudaErrorInvalidValue
    torch.cuda.synchronize()


WGMMA_CASES = {  # B, Hq, Hkv, Sq, Sk, causal, window
    # full, diagonal and (for the second warpgroup of a block) empty key
    # tiles in one launch; Sq not a multiple of the 128-row tiles
    "causal-long": (1, 8, 2, 1000, 1000, True, None),
    # a window that starts and ends inside a key tile, narrower than a
    # consumer warpgroup's 64 rows (its first tile is empty for one of them)
    "window-40": (2, 4, 4, 700, 700, True, 40),
    "window-200": (1, 4, 1, 517, 517, True, 200),
    # Sq != Sk, both ragged
    "sq-lt-sk": (1, 4, 1, 300, 520, False, None),
    "sq-gt-sk-causal": (2, 4, 4, 333, 150, True, None),
    # rows q >= Sk + window - 1 have no live key: they are 0
    "no-live-key": (1, 4, 4, 300, 100, False, 60),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("case", sorted(WGMMA_CASES))
def test_flash_attention_wgmma_kernel_edges_on_card(dh, case):
    """The TMA + wgmma kernel (bf16, D 64 and 128) against plain at the
    edges of its 128-row q tiles and 128-key tiles, group sizes 1 and 4,
    on [B, S, H, D] projections read in place as [B, H, S, D] views
    (``assert_attention_close``)."""
    dev = _cuda()
    b, hq, hkv, sq, sk, causal, window = WGMMA_CASES[case]
    assert route(torch.bfloat16, dh)[0] == "wgmma"
    g = torch.Generator(device=dev).manual_seed(dh + sq)
    q = torch.randn(b, sq, hq, dh, generator=g, device=dev).bfloat16()
    k = torch.randn(b, sk, hkv, dh, generator=g, device=dev).bfloat16()
    v = torch.randn(b, sk, hkv, dh, generator=g, device=dev).bfloat16()
    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    before = runtime.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["flash_attention"] == before + 1
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    want = flash_attention_ref(qc, kc, vc, causal=causal, window=window)
    assert_attention_close(got, want, qc, kc, vc, causal=causal,
                           window=window)
    if case == "no-live-key":
        assert torch.count_nonzero(got[:, :, sk + window - 1:]) == 0
        assert bool((got[:, :, :sk + window - 1].abs().sum(-1) > 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("coord", ["int32", "uint16"])
@pytest.mark.parametrize("kind", VAL_KINDS)
def test_gather_dot_cand_bitwise_equals_gather_dot_on_card(kind, coord):
    """gather_dot_cand scores a candidate's row bitwise as gather_dot scores
    the same row gathered: C = 1000 is not a multiple of the tile, every
    third query is all sentinels (whole tiles skipped), and the live
    prefixes end inside tiles. The queries are sparse (``sparse_queries``),
    so most lookups miss the kernel's bitmap, some hit it in the last
    partial word of d = 30522, and a -0.0 is read as the non-zero bit
    pattern it is."""
    dev = _cuda()
    n_docs, d = 5000, 30522
    q, pool = sparse_queries(12, d, seed=4)
    q = _t(q).to(dev)
    plane = [None if x is None else x.to(dev)
             for x in as_torch(*row_inputs((n_docs, 128), pool.size, kind,
                                           5))]
    plane[0] = _t(pool).to(dev)[plane[0].long()]    # rows over the pool
    c16 = plane[0].to(torch.int32).to(torch.int16).view(torch.uint16)
    plane[0] = c16 if coord == "uint16" else c16.to(torch.int32)
    cand = _t(cand_inputs(12, 1000, n_docs, seed=6)).to(dev)
    before = runtime.LAUNCHES["gather_dot_cand"]
    got = gather_dot_cand_batch(q, cand, *plane, n_docs=n_docs)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["gather_dot_cand"] == before + 1
    live = cand < n_docs
    assert bool(torch.isneginf(got[~live]).all())
    idx = cand.long().clamp(max=n_docs - 1)
    fs, fz = plane[2:]
    batch = gather_dot_batch(q, take_rows(plane[0], idx), plane[1][idx],
                             None if fs is None else fs[idx],
                             None if fz is None else fz[idx])
    assert torch.equal(got[live], batch[live])
    assert_scores(got.cpu().numpy(),
                  gather_dot_cand_ref(q, cand, *plane, n_docs).cpu())
    # the bitmap's hits, its misses and its last word all occur
    c = plane[0].long()[cand.long().clamp(max=n_docs - 1)][live]
    qi = live.nonzero()[:, 0]
    hit = q[qi[:, None], c] != 0
    assert 0.02 < float(hit.float().mean()) < 0.5
    assert bool(hit[c >= d - d % 32].any())
    assert bool((torch.signbit(q) & (q == 0))[qi[:, None], c].any())


def flat_route_of(q, coords, u8, scale, zero):
    """router_flat (whose kernel is unchanged) over [Q, L, S] summaries
    laid out as Q lists of L live blocks, query i probing list i: its
    scores are the summary dots of the same rows in the same order."""
    qn, l, _ = coords.shape
    lists = torch.arange(qn, dtype=torch.int32, device=q.device)[:, None]
    alive = torch.ones(qn, l, dtype=torch.int32, device=q.device)
    return router_flat_batch(lists.contiguous(), q, coords, u8, scale, zero,
                             alive)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [96, 768, 17])
def test_summary_dot_kernel_on_sparse_queries_on_card(s):
    """The redesigned summary_dot on sparse queries (``sparse_queries``):
    L = 3 x 37 rows is not a multiple of the tile (64, 8 or 320 rows),
    a probed list of all-padding rows scores 0, and the lookups hit and
    miss the bitmap, hit its last partial word and read a -0.0. Scores
    are within tolerance of the plain version and bitwise equal to
    router_flat's, the row dot the fuse levels share."""
    dev = _cuda()
    d, qn, nl, nb, cut = 30522, 12, 40, 37, 3
    q, pool = sparse_queries(qn, d, seed=s)
    c, u8, sc, z = tier_planes(nl, nb, s, pool.size, seed=s + 1)
    c = pool[c]
    u8[0] = 0                                  # list 0: all padding
    rng = np.random.default_rng(s + 2)
    lists = rng.integers(0, nl, (qn, cut)).astype(np.int64)
    lists[0, 1] = 0
    q = _t(q).to(dev)
    args = [q] + [_t(x[lists]).reshape((qn, cut * nb) + x.shape[2:])
                  .contiguous().to(dev) for x in (c, u8, sc, z)]
    before = runtime.LAUNCHES["summary_dot"]
    got = summary_dot_batch(*args)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["summary_dot"] == before + 1
    assert_scores(got.cpu().numpy(), summary_dot_batch_ref(*args).cpu())
    assert torch.equal(got, flat_route_of(*args))
    assert bool((got[0, nb:2 * nb] == 0).all())
    # hits, misses, last-word hits and -0.0 lookups all occur
    cc = args[1].long()
    live = args[2] > 0
    hit = torch.gather(q, 1, cc.reshape(qn, -1)).reshape(cc.shape) != 0
    assert 0.01 < float(hit[live].float().mean()) < 0.5
    assert bool((hit & live & (cc >= d - d % 32)).any())
    negz = torch.signbit(q) & (q == 0)
    assert bool((torch.gather(negz, 1, cc.reshape(qn, -1))
                 .reshape(cc.shape) & live).any())


@pytest.mark.gpu
@pytest.mark.parametrize("l,s,d", [(2001, 17, 30522), (1000, 96, 300),
                                   (333, 768, 1000)])
def test_summary_dot_kernel_tiles_and_chunks_on_card(l, s, d):
    """Ragged tiles whose byte ranges start off 16-byte boundaries (S = 17,
    L = 2001: every query's coords, levels, scales and zeros start at
    another phase), and many blocks per query with a ragged last one (a
    small d makes short chunks); all-padding rows score 0."""
    dev = _cuda()
    args = [_t(x).to(dev) for x in summary_inputs(7, l, s, d, seed=l)]
    assert l % summary_geometry(l, s, d)["tile_rows"] != 0
    got = summary_dot_batch(*args)
    torch.cuda.synchronize()
    assert_scores(got.cpu().numpy(), summary_dot_batch_ref(*args).cpu())
    assert torch.equal(got, flat_route_of(*args))
    assert bool((got[0, :max(l // 3, 1)] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("l,s,d", [(4940, 96, 30522), (496, 768, 30522),
                                   (256, 96, 30522), (1000, 96, 300),
                                   (2001, 17, 30522), (333, 768, 1000),
                                   (1, 1, 1)])
def test_summary_dot_geometry_chunks_whole_tiles_on_card(l, s, d):
    """The geometry summary_dot's library launches with: 4 short rows or 1
    long row per warp, tiles of whole groups of 8 warps' rows (64 rows of
    96 entries, 8 of 768), a stage that holds a tile's 5 bytes an entry
    and 8 a row, rows per block in whole tiles covering L (one block a
    query at the router's shapes, many at a small d), and shared memory
    within a block's."""
    _cuda()
    g = summary_geometry(l, s, d)
    t, c = g["tile_rows"], g["chunk_rows"]
    assert g["rows_per_warp"] == (1 if s >= 256 else 4)
    assert t >= 1 and c % t == 0 and c >= min(l, t)
    assert t == 1 or t % (8 * g["rows_per_warp"]) == 0 \
        or t < 8 * g["rows_per_warp"]
    assert g["stage_bytes"] % 16 == 0
    assert g["stage_bytes"] >= t * (5 * s + 8)
    assert g["smem"] >= g["stages"] * g["stage_bytes"] + 4 * -(-d // 32)
    assert g["smem"] <= row_tiles.SMEM_MAX and g["stages"] >= 2
    n_chunks = -(-l // c)
    if (l, s) in ((4940, 96), (496, 768)):
        assert (t, n_chunks) == ((64, 1) if s == 96 else (8, 1))
    if (l, s, d) == (1000, 96, 300):
        assert n_chunks > 4


@pytest.mark.gpu
def test_router_hier_geometry_holds_both_stages_on_card():
    """router_hier's library geometry at the main path's shapes (cut 8, 62
    superblocks of 768 entries, children of 96, fanout 8, m 32): a stage
    holds a stage-A tile of whole superblock rows and segs_b superblocks'
    children with their block_len; shared memory holds the ring, the
    bitmap and the 512-entry sort, and grows with a block's share of the
    top m; a cluster of 1 takes no less than one of 4."""
    _cuda()
    g = hier_geometry(8, 62, 768, 96, 8, 32, 30522, 4)
    assert g["cluster"] == 4
    assert (g["rows_per_warp_a"], g["rows_per_warp_b"]) == (1, 4)
    assert g["tile_a"] == 8 and g["segs_b"] >= 1
    assert g["stage_bytes"] >= 8 * (5 * 768 + 8)
    assert g["stage_bytes"] >= g["segs_b"] * 8 * (5 * 96 + 12)
    assert g["smem"] >= g["stages"] * g["stage_bytes"] + 4 * 954 + 8 * 512
    assert g["smem"] <= row_tiles.SMEM_MAX
    big_m = hier_geometry(8, 62, 768, 96, 8, 496, 30522, 4)
    assert big_m["smem"] > g["smem"]
    assert hier_geometry(8, 62, 768, 96, 8, 32, 30522, 1)["smem"] \
        >= g["smem"]
    with pytest.raises(ValueError, match="geometry refuses"):
        hier_geometry(8, 62, 768, 96, 8, 497, 30522, 4)     # m > cut * ns


@pytest.mark.gpu
def test_summary_and_hier_wrappers_raise_beyond_their_caps_on_card():
    """On the card the wrappers raise, before any launch, on d beyond
    row_tiles.MAX_DIM and on shapes whose shared memory a block cannot
    hold (a 32,768-superblock sort); they never fall back."""
    dev = _cuda()
    big_d = row_tiles.MAX_DIM + 1
    q = torch.zeros(1, big_d, device=dev)
    c = torch.zeros(1, 2, 4, dtype=torch.int32, device=dev)
    u8 = torch.ones(1, 2, 4, dtype=torch.uint8, device=dev)
    sc = torch.ones(1, 2, device=dev)
    before = dict(runtime.LAUNCHES)
    with pytest.raises(ValueError, match="dimension"):
        summary_dot_batch(q, c, u8, sc, sc)
    cut, ns, f = 64, 512, 8
    nb = ns * f
    lists = torch.zeros(1, cut, dtype=torch.int32, device=dev)
    qd = torch.zeros(1, 64, device=dev)
    sup = (torch.zeros(1, ns, 16, dtype=torch.int32, device=dev),
           torch.ones(1, ns, 16, dtype=torch.uint8, device=dev),
           torch.ones(1, ns, device=dev), torch.ones(1, ns, device=dev))
    blk = (torch.zeros(1, nb, 4, dtype=torch.int32, device=dev),
           torch.ones(1, nb, 4, dtype=torch.uint8, device=dev),
           torch.ones(1, nb, device=dev), torch.ones(1, nb, device=dev))
    bl = torch.ones(1, nb, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        router_hier_batch(lists, qd, *sup, *blk, bl, m=32, fanout=f)
    with pytest.raises(ValueError, match="dimension"):
        router_hier_batch(lists[:, :2].contiguous(), q, *sup, *blk, bl, m=2,
                          fanout=f)
    assert dict(runtime.LAUNCHES) == before


@pytest.mark.gpu
@pytest.mark.parametrize("cut,nb,f,m", [(8, 494, 8, 1), (3, 37, 4, 30),
                                        (5, 20, 3, 7), (8, 494, 8, 32)])
def test_router_hier_kernel_on_sparse_queries_on_card(cut, nb, f, m):
    """The cluster router_hier on sparse queries: m = 1, m = cut * ns (3 x
    10), cut * ns never a power of two (496, 30, 35), a dead list among
    the probes (its superblocks -inf inside the top m), dead blocks and a
    repeated probe. Flat positions equal the plain version's and the
    unfused route's (router_hier_ref over summary_dot, fuse level 0), and
    the live child scores are bitwise summary_dot's of the same rows."""
    dev = _cuda()
    d, qn, nl, s = 30522, 12, 60, 96
    ns = -(-nb // f)
    q, pool = sparse_queries(qn, d, seed=nb + m)
    lists, _, *blocks, block_len = router_inputs(qn, cut, nl, nb, s,
                                                 pool.size, nb + f)
    sup = tier_planes(nl, ns, s * f, pool.size, nb + m)
    blocks[0], sup = pool[blocks[0]], (pool[sup[0]],) + sup[1:]
    lists[1, 0] = 0                               # a dead list
    order = [_t(x).to(dev) for x in
             (lists, q, *sup, *blocks, block_len)]
    before = runtime.LAUNCHES["router_hier"]
    rb, flat = router_hier_batch(*order, m=m, fanout=f)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["router_hier"] == before + 1
    want_rb, want_flat = router_hier_ref(*order, m=m, fanout=f)
    assert torch.equal(flat, want_flat)
    assert_scores(rb.cpu().numpy(), want_rb.cpu())
    un_rb, un_flat = router_hier_ref(*order, m=m, fanout=f,
                                     dot=summary_dot_batch)
    assert torch.equal(flat, un_flat) and torch.equal(rb, un_rb)
    # the live children against summary_dot on the same rows
    lists_t, q_t = order[0], order[1]
    sc, sq, ss, sz = order[6:10]
    rows = (lists_t.long().gather(1, (flat // nb).long()) * nb
            + flat % nb).long()
    a = summary_dot_batch(q_t, sc.reshape(-1, s)[rows],
                          sq.reshape(-1, s)[rows], ss.reshape(-1)[rows],
                          sz.reshape(-1)[rows])
    live = torch.isfinite(rb)
    assert bool(live.any()) and bool((~live).any())
    assert torch.equal(rb[live], a[live])


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_router_hier_kernel_is_the_same_at_every_cluster_size_on_card(
        cluster, monkeypatch):
    """The blocks of a cluster share the bitmap and the stage-A scores and
    split stage A's tiles and the top m among them: 1, 2, 4 or 8 blocks
    per query give bitwise the same (rb, flat), equal to the plain
    version's flat positions and the unfused route's scores."""
    dev = _cuda()
    qn, cut, nl, nb, s, f, m = 16, 8, 60, 494, 96, 8, 32
    ns = -(-nb // f)
    q, pool = sparse_queries(qn, 30522, seed=cluster)
    lists, _, *blocks, block_len = router_inputs(qn, cut, nl, nb, s,
                                                 pool.size, 7)
    sup = tier_planes(nl, ns, s * f, pool.size, 8)
    blocks[0], sup = pool[blocks[0]], (pool[sup[0]],) + sup[1:]
    order = [_t(x).to(dev) for x in (lists, q, *sup, *blocks, block_len)]
    monkeypatch.setattr(row_tiles, "cluster_size", lambda *a: cluster)
    rb, flat = router_hier_batch(*order, m=m, fanout=f)
    torch.cuda.synchronize()
    want_rb, want_flat = router_hier_ref(*order, m=m, fanout=f,
                                         dot=summary_dot_batch)
    assert torch.equal(flat, want_flat) and torch.equal(rb, want_rb)



def flat_inputs(qn, cut, nl, nb, s, d, seed):
    """router_flat inputs over a small plane of nl lists: sparse queries
    and one dense one (their summaries' coords drawn from the queries'
    pool, so lookups hit), every query probing list 7, query 0 probing
    it 9 times (more pairs than a group holds even at Q = 1) and the
    dead list 3, the last query out-of-range probes (clipped) and a
    repeated one. Each list's live blocks are a prefix of random length;
    list 5 has a dead block inside its prefix."""
    rng = np.random.default_rng(seed)
    q, pool = sparse_queries(qn, d, seed=seed)
    # one query of 300 non-zeros, too many to stage: the groups it joins
    # look q up in L2 (QMasked), the others in shared memory (QStaged)
    q[min(1, qn - 1), pool[:300]] = 1.5
    lists = rng.integers(0, nl, (qn, cut)).astype(np.int32)
    lists[:, 0] = 7
    lists[0, :9] = 7
    lists[0, 9] = 3
    lists[-1, 10:14] = (-5, nl + 9, 3, 3)
    lists[-1, 14] = lists[-1, 15]
    live = rng.integers(0, nb + 1, nl)
    live[3], live[7] = 0, nb
    block_len = (np.arange(nb)[None] < live[:, None]).astype(np.int32) \
        * rng.integers(1, 64, (nl, nb)).astype(np.int32)
    block_len[5, : nb // 2] = 1
    block_len[5, nb // 4] = 0
    coords, *rest = tier_planes(nl, nb, s, pool.size, seed + 1)
    return (lists, q, pool[coords], *rest, block_len)


@pytest.mark.gpu
@pytest.mark.parametrize("qn", [1, 16, 256, 4096])
def test_router_flat_list_major_on_card(qn):
    """The list-major route at 1 to 4096 queries over a small plane: equal
    to the plain version (-inf exactly at dead blocks, dead lists and
    clipped probes of dead lists), and every live score bitwise
    summary_dot's on the same rows (the unfused route); the groups, the
    bitmaps and the route each count one launch."""
    dev = _cuda()
    cut, nl, nb, s, d = 16, 40, 37, 96, 30522
    args = [_t(x).to(dev) for x in flat_inputs(qn, cut, nl, nb, s, d, qn)]
    names = ("router_flat", "router_flat_groups", "router_flat_records")
    before = {n: runtime.LAUNCHES[n] for n in names}
    got = router_flat_batch(*args)
    torch.cuda.synchronize()
    assert all(runtime.LAUNCHES[n] == before[n] + 1 for n in names)
    assert got.shape == (qn, cut * nb)
    assert_scores(got.cpu().numpy(), router_flat_ref(*args).cpu())
    lists, q, sc, sq, ss, sz, bl = args
    li = lists.long().clamp(0, nl - 1)
    unfused = summary_dot_batch(q, sc[li].reshape(qn, -1, s),
                                sq[li].reshape(qn, -1, s),
                                ss[li].reshape(qn, -1),
                                sz[li].reshape(qn, -1))
    live = torch.isfinite(got)
    assert torch.equal(live, (bl[li] > 0).reshape(qn, -1))
    assert torch.equal(got[live], unfused[live])
    # the same answer again: the groups' order never reaches the output
    assert torch.equal(router_flat_batch(*args), got)


@pytest.mark.gpu
def test_router_flat_geometry_on_card():
    """At the smoke's shapes two blocks fit an SM (the ring of 3 tiles of
    32 rows, two buffers of a group's 8 query records, the group table),
    the grid is two blocks an SM or one per possible group, and the
    scratch holds the query records, the pairs and the group table."""
    _cuda()
    g = flat_geometry(256, 10, 30522, 494, 96, 30522, 132)
    assert (g["group"], g["rows_per_warp"], g["tile_rows"]) == (8, 4, 32)
    assert 2 * (g["smem"] + 1024) <= 228 * 1024
    assert g["grid"] == 264 and g["bitmap_words"] % 4 == 0
    assert g["listed"] >= 48 and g["union"] >= 8 * 48
    assert g["record_bytes"] % 16 == 0
    assert g["record_bytes"] >= 8 * g["listed"] + 4
    assert g["table_bytes"] >= 32 * g["union"] + 4 * g["bitmap_words"]
    assert max(g["groups_smem"], g["records_smem"]) <= row_tiles.SMEM_MAX
    p = 256 * 10
    assert g["scratch_words"] == (256 * g["record_bytes"] // 4 + 4 + 2 * p
                                  + 3 * (p // 8 + 1 + p))
    assert flat_geometry(1, 2, 30522, 494, 96, 30522, 132)["grid"] == 3
    with pytest.raises(ValueError, match="geometry refuses"):
        flat_geometry(0, 10, 30522, 494, 96, 30522, 132)


REFINE_EDGES = {   # qn, k, w, n_docs, deg, degree
    "k*degree 21": (9, 7, 10, 3000, 5, 3),
    "degree 1": (9, 10, 1, 3000, 4, 1),
    "W 90": (64, 10, 90, 5000, 12, 8),
    "512 candidates": (5, 64, 90, 5000, 8, 8),
}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", VAL_KINDS)
@pytest.mark.parametrize("case", list(REFINE_EDGES) + ["all padding"])
def test_refine_round_kernel_edges_on_card(case, kind):
    """The register-sort refine round: k * degree not a power of two, degree
    1 with a seen row of one id, W 90, the 512-candidate sort (16 ids a
    lane) and ids that are all padding, in the three value kinds, all
    with uint16 coords (a compact forward index). Frontier ids equal the
    plain version's; scores are bitwise gather_dot_cand's on the
    frontier."""
    dev = _cuda()
    qn, k, w, n_docs, deg, degree = REFINE_EDGES.get(case,
                                                     (7, 10, 20, 3000, 8, 8))
    ids, scored, q, knn, *plane = refine_inputs(qn, k, w, n_docs, deg, 128,
                                                30522, kind, seed=k + w)
    if case == "all padding":
        ids[:] = -1
        scored[:, :k] = n_docs
    args = [_t(x).to(dev) for x in (ids, scored, q, knn)]
    tplane = [None if x is None else x.to(dev) for x in as_torch(*plane)]
    if tplane[0].dtype == torch.int32:               # d < 32768
        tplane[0] = tplane[0].to(torch.int16).view(torch.uint16)
    cand, scores = refine_round_batch(*args, *tplane, n_docs=n_docs,
                                      degree=degree)
    torch.cuda.synchronize()
    want_c, want_s = refine_round_ref(*args, *tplane, n_docs, degree)
    assert torch.equal(cand, want_c)
    assert_scores(scores.cpu().numpy(), want_s.cpu())
    assert torch.equal(scores, gather_dot_cand_batch(
        args[2], cand, *tplane, n_docs=n_docs))
    if case == "all padding":
        assert bool((cand == n_docs).all())


@pytest.mark.gpu
def test_refine_round_wrapper_raises_beyond_its_sort_on_card():
    dev = _cuda()
    ids, scored, q, knn, *plane = refine_inputs(2, 65, 70, 500, 8, 16, 64,
                                                "f32", seed=1)
    args = [_t(x).to(dev) for x in (ids, scored, q, knn)]
    tplane = [None if x is None else x.to(dev) for x in as_torch(*plane)]
    before = dict(runtime.LAUNCHES)
    with pytest.raises(ValueError, match="512"):
        refine_round_batch(*args, *tplane, n_docs=500, degree=8)
    assert dict(runtime.LAUNCHES) == before


@pytest.mark.gpu
def test_sample_rep_pos_on_card_equals_cpu():
    """The builder's representative draws (repro_torch.prng) are integer
    arithmetic: the card draws the CPU's positions, at the MS MARCO
    shapes (30522 lists, beta 400, lam 6000)."""
    dev = _cuda()
    cfg = SeismicConfig(lam=6000, beta=400)
    counts = torch.from_numpy(np.random.default_rng(3).integers(
        0, 20000, 30522))
    counts[:3] = torch.tensor([0, 1, 6000])
    cpu = sample_rep_pos(counts, cfg)
    assert torch.equal(sample_rep_pos(counts.to(dev), cfg).cpu(), cpu)


@pytest.mark.gpu
def test_mutated_index_on_card_is_bitwise_across_levels_and_fresh():
    """Grow from empty with auto-compaction and deletes on the card, at
    the mutation tests' small config (tests/test_mutation.py): the
    kernels meet a sentinel equal to the capacity (40, not a power of
    two), blocks whose purged members are sentinels, and all-zero rows.
    At full budget ids, scores and docs_evaluated are bitwise equal at
    fuse 0, 1 and 2, and once the tail is compacted bitwise equal to a
    fresh build of the equivalent corpus on the card. With a live tail
    (scored by the plain gather at every level and in no fresh build)
    ids and docs_evaluated equal the fresh build's and scores lie within
    the kernel tolerance."""
    from repro_torch.core import MutableSeismicIndex, build_index
    from repro_torch.retrieval import SearchParams, search_pipeline
    from repro_torch.sparse.ops import PaddedSparse
    dev = _cuda()
    dim, nnz, cap = 64, 8, 40
    cfg = SeismicConfig(lam=16, beta=2, alpha=1.0, block_cap=4,
                        summary_nnz=64, superblock_fanout=2)
    rng = np.random.default_rng(17)

    def docs(n):
        c = np.stack([rng.choice(np.arange(1, 24), nnz, replace=False)
                      for _ in range(n)])
        return (torch.from_numpy(c).to(dev),
                torch.from_numpy(rng.uniform(0.1, 1.0, (n, nnz))).to(dev))

    c, v = docs(8)
    q = PaddedSparse(c.to(torch.int32), v.float(), dim)
    levels = [SearchParams(k=10, cut=nnz, block_budget=nnz * cfg.n_blocks,
                           policy="budget", fuse_level=f) for f in (0, 1, 2)]
    mut = MutableSeismicIndex.empty(dim, nnz, cfg, capacity=cap, tail_cap=16,
                                    tail_max=6, device=dev)

    def check(compacted: bool):
        idx = mut.index
        corpus_v = idx.fwd.vals.clone()
        dead = idx.tombstone.clone()
        dead[mut.n_docs:] = True
        corpus_v[dead] = 0
        fresh = build_index(PaddedSparse(
            torch.where(dead[:, None], 0, idx.fwd.coords), corpus_v, dim),
            cfg)
        runtime.reset_launches()
        outs = [search_pipeline(idx, q, p) for p in levels]
        torch.cuda.synchronize()
        for name in ("summary_dot", "gather_dot", "gather_dot_cand",
                     "router_flat"):
            assert runtime.LAUNCHES[name] > 0, name
        for out in outs[1:]:
            for a, b in zip(out, outs[0]):
                assert torch.equal(a, b)
        got = outs[0]
        live = got[1][got[1] >= 0].long()
        assert not bool(idx.tombstone[live].any())
        for p in levels:
            want = search_pipeline(fresh, q, p)
            assert torch.equal(got[1], want[1])
            assert torch.equal(got[2], want[2])
            if compacted:
                assert torch.equal(got[0], want[0])
            else:
                assert_scores(got[0].cpu().numpy(), want[0].cpu().numpy())

    while mut.n_docs < cap - 11:
        mut.insert_docs(*docs(int(rng.integers(1, 6))))
        check(False)
    mut.delete_docs(torch.tensor([0, 5, mut.n_docs - 1], device=dev))
    check(False)
    mut.compact()
    planes = [t for t in mut.index._tensor_fields().values()
              if t is not None] + [mut.index.fwd.coords, mut.index.fwd.vals]
    assert all(t.device.type == dev.type for t in planes)
    check(True)
    mut.insert_docs(*docs(6))
    mut.delete_docs(torch.tensor([mut.n_docs - 2], device=dev))
    mut.compact()
    check(True)
