"""Port parity: the launchers (``repro_torch.launch.serve``,
``repro_torch.launch.train``) and the LM bundles of ``models.api``
against the JAX package.

The serving CLI answers a numpy collection (the JAX package's
``make_collection``) as the JAX CLI's components answer it on the same
arrays (``build_index(..., list_chunk=32)``, ``SeismicServer`` with the
CLI's ``SearchParams``, ``exact_search``, ``recall_at_k``): ids equal
except at non-isolated scores (``rtol=1e-5, atol=1e-6``),
``docs_evaluated`` and recall equal. With ``--doc-shards 2`` it answers
as ``search_shards`` over the planes of JAX's ``build_sharded_index``.
Both launchers run end to end on the CPU.
"""
import argparse
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import SearchParams as JParams
from repro.core import SeismicConfig as JConfig
from repro.core import build_index as j_build_index
from repro.core import distributed as jdist
from repro.core.baselines import exact_search as j_exact_search
from repro.core.oracle import recall_at_k as j_recall_at_k
from repro.data import SyntheticSparseConfig, make_collection
from repro.models.api import get_bundle as j_get_bundle
from repro.serve.engine import SeismicServer as JServer
from repro.sparse.ops import PaddedSparse as JPadded
from repro_torch.core.distributed import ShardedIndex, search_shards
from repro_torch.core.types import index_from_arrays
from repro_torch.launch import serve, train
from repro_torch.models.api import Spec, get_bundle
from repro_torch.models.transformer import lm
from repro_torch.sparse.ops import PaddedSparse

RTOL, ATOL = 1e-5, 1e-6
LM_IDS = ("phi3-medium-14b", "llama3-8b", "gemma3-27b", "kimi-k2-1t-a32b",
          "deepseek-v2-lite-16b")
OTHER_IDS = ("gin-tu", "sasrec", "bst", "fm", "wide-deep")
ARGV = ["--n-docs", "1024", "--dim", "512", "--queries", "16",
        "--device", "cpu"]


@pytest.fixture(scope="module")
def collection():
    args = serve.parse_args(ARGV)
    cfg = SyntheticSparseConfig(dim=args.dim, n_docs=args.n_docs,
                                n_queries=args.queries, doc_nnz=96,
                                query_nnz=32)
    d, q, _ = make_collection(cfg)
    return args, (d.coords, d.vals, d.dim), (q.coords, q.vals, q.dim)


def _port(c, v, dim):
    return PaddedSparse(torch.from_numpy(np.asarray(c)),
                        torch.from_numpy(np.asarray(v)), dim)


def _jax(c, v, dim):
    return JPadded(jnp.asarray(c), jnp.asarray(v), dim)


def _icfg():
    return JConfig(lam=192, beta=12, alpha=0.4, block_cap=32, summary_nnz=48)


def _jparams(args):
    return JParams(k=args.k, cut=args.cut, block_budget=args.budget,
                   policy="adaptive")


def _assert_ids(ids, want_ids, want_scores):
    """ids equal except where the reference score is not isolated."""
    ids, want_ids = np.asarray(ids), np.asarray(want_ids)
    ws = np.asarray(want_scores, np.float64)
    for q, i in zip(*np.nonzero(ids != want_ids)):
        near = np.abs(ws[q] - ws[q, i]) <= ATOL + RTOL * abs(ws[q, i])
        near[i] = False
        assert near.any() or i == ids.shape[1] - 1, (q, i)


def _recall(ids, exact):
    ids, exact = np.asarray(ids), np.asarray(exact)
    return float(np.mean([j_recall_at_k(ids[q], exact[q])
                          for q in range(ids.shape[0])]))


def test_serve_answers_as_the_jax_cli_components(collection):
    args, d, q = collection
    out = serve.serve(args, _port(*d), _port(*q))
    jdocs, jq = _jax(*d), _jax(*q)
    jindex = j_build_index(jdocs, _icfg(), list_chunk=32)
    res = JServer(jindex, _jparams(args),
                  max_batch=min(args.queries, 256)).search(jq)
    _assert_ids(out["ids"].numpy(), res.ids, res.scores)
    np.testing.assert_array_equal(out["docs_evaluated"].numpy(),
                                  np.asarray(res.docs_evaluated))
    _, exact = j_exact_search(jdocs, jq, args.k)
    assert out["recall"] == pytest.approx(_recall(res.ids, exact), abs=1e-12)
    assert out["recall"] > 0.5


def test_serve_doc_shards_answers_as_search_shards_on_jax_planes(collection):
    args, d, q = collection
    args = argparse.Namespace(**{**vars(args), "doc_shards": 2})
    out = serve.serve(args, _port(*d), _port(*q))
    stacked = jdist.build_sharded_index(_jax(*d), _icfg(), 2)
    shards = []
    for s in range(2):
        arrays = {"fwd_coords": np.asarray(stacked.fwd.coords[s]),
                  "fwd_vals": np.asarray(stacked.fwd.vals[s])}
        for f in dataclasses.fields(stacked):
            v = getattr(stacked, f.name)
            if f.name not in ("fwd", "config", "tuned") and v is not None:
                arrays[f.name] = np.asarray(v[s])
        shards.append(index_from_arrays(
            arrays, stacked.fwd.dim, dataclasses.asdict(stacked.config),
            device="cpu"))
    ref = ShardedIndex(shards=tuple(shards), n_docs=args.n_docs)
    scores, ids, ev = search_shards(ref, _port(*q),
                                    serve.search_params(args))
    _assert_ids(out["ids"].numpy(), ids.numpy(), scores.numpy())
    np.testing.assert_array_equal(out["docs_evaluated"].numpy(), ev.numpy())
    _, exact = j_exact_search(_jax(*d), _jax(*q), args.k)
    assert out["recall"] == pytest.approx(_recall(ids.numpy(), exact),
                                          abs=1e-12)


def test_serve_main_runs_end_to_end(capsys):
    argv = ["--n-docs", "512", "--dim", "512", "--queries", "8", "--device",
            "cpu"]
    out = serve.main(argv)
    text = capsys.readouterr().out
    assert f"recall@10={out['recall']:.3f}" in text
    assert "docs evaluated (mean)" in text
    ids = out["ids"]
    assert ids.shape == (8, 10) and ids.dtype == torch.int32
    assert int(ids.min()) >= 0 and int(ids.max()) < 512
    assert out["recall"] > 0.5
    shards = serve.main(argv + ["--doc-shards", "2"])
    assert "docs evaluated (mean)" not in capsys.readouterr().out
    assert shards["index"].n_shards == 2 and shards["ids"].shape == (8, 10)


def test_launchers_refuse_a_mesh(tmp_path, capsys, monkeypatch):
    """Both launchers take ``--devices`` (ranks of their own on this
    host, over gloo); what they refuse is a mesh they cannot make: model
    parallelism without ranks, and ``torchrun`` with fewer cards than
    ranks (NCCL needs one card a rank: no switch to gloo)."""
    out = serve.main(ARGV + ["--devices", "2", "--doc-shards", "2"])
    assert out["mesh"] == {"data": 1, "model": 2} and out["ids"].shape[0] == 16
    got = train.main(["--reduced", "--device", "cpu", "--devices", "2",
                      "--model-parallel", "2", "--steps", "2", "--batch",
                      "2", "--seq", "8", "--ckpt-dir", str(tmp_path)])
    assert "mesh={'data': 1, 'model': 2}" in capsys.readouterr().out
    assert np.isfinite(got["loss"])
    with pytest.raises(ValueError, match="needs ranks"):
        train.main(["--reduced", "--device", "cpu", "--model-parallel", "2"])
    for k, v in dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0",
                     LOCAL_WORLD_SIZE="2").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for main, argv in ((serve.main, ARGV[:-2]),
                       (train.main, ["--reduced"])):
        with pytest.raises(RuntimeError, match="fewer|one card per rank"):
            main(argv + ["--device", "cuda"])


def test_train_checkpoints_under_the_working_directory():
    """The launcher's default ``--ckpt-dir`` is a path relative to where
    it runs, as the JAX launcher's is a plain path, never one taken from
    where the package lies."""
    ckpt = train.parse_args([]).ckpt_dir
    assert not os.path.isabs(ckpt) and ckpt == os.path.join("build",
                                                            "train_ckpt")


def test_train_main_runs_and_resumes(tmp_path, capsys):
    argv = ["--arch", "llama3-8b", "--reduced", "--steps", "3", "--batch",
            "4", "--seq", "16", "--device", "cpu", "--ckpt-dir",
            str(tmp_path), "--microbatches", "2"]
    first = train.main(argv + ["--resume"])
    text = capsys.readouterr().out
    assert "no checkpoint; fresh start" in text and "done" in text
    assert "step     0  loss=" in text and first["start"] == 0
    assert np.isfinite(first["loss"])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000003"]
    second = train.main(argv + ["--resume"])
    text = capsys.readouterr().out
    assert "resumed from step 3" in text and second["start"] == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000003", "step_00000006"]


# ---------------------------------------------------------------- bundles

@pytest.mark.parametrize("arch", LM_IDS)
def test_bundle_matches_jax(arch):
    mine, theirs = get_bundle(arch), j_get_bundle(arch)
    assert mine.family == theirs.family == "lm"
    assert mine.config.name == theirs.config.name
    assert mine.reduced.name == theirs.reduced.name
    assert [c.name for c in mine.shapes] == [c.name for c in theirs.shapes]
    dims = dict(global_batch=2, seq_len=8)
    for kind in ("train", "prefill", "decode"):
        specs = mine.batch_specs(mine.reduced, dims, kind)
        jspecs = theirs.batch_specs(theirs.reduced, dims, kind)
        assert {k: s.shape for k, s in specs.items()} \
            == {k: s.shape for k, s in jspecs.items()}
        assert all(isinstance(s, Spec) and s.dtype == torch.int32
                   for s in specs.values())
        got = mine.make_batch(np.random.default_rng(4), mine.reduced, dims,
                              kind, device="cpu")
        want = theirs.make_batch(np.random.default_rng(4), theirs.reduced,
                                 dims, kind)
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v))
    # param_specs: the JAX package's tree, the port's leaves restacked
    from repro.distributed.param_sharding import lm_param_specs as j_specs
    from repro_torch.distributed.param_sharding import jax_layout_specs
    shapes = jax.eval_shape(lambda: theirs.init(jax.random.PRNGKey(0),
                                                theirs.reduced, {}))
    got = jax_layout_specs(mine.param_specs(
        mine.init(0, mine.reduced, {}, device="meta")))
    want = jax.tree_util.tree_flatten_with_path(
        j_specs(shapes), is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))[0]
    for path, spec in want:
        node = got
        for p in path:
            node = node[p.key]
        assert tuple(node) == tuple(spec)


def test_bundle_steps_match_jax():
    mine, theirs = get_bundle("llama3-8b"), j_get_bundle("llama3-8b")
    cfg, jcfg = mine.reduced, theirs.reduced
    dims = dict(global_batch=2, seq_len=8, pos=0)
    jparams = theirs.init(jax.random.PRNGKey(0), jcfg, dims)
    params = lm.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                "cpu")
    batch = mine.make_batch(np.random.default_rng(1), cfg, dims, "train",
                            device="cpu")
    jbatch = theirs.make_batch(np.random.default_rng(1), jcfg, dims, "train")
    np.testing.assert_allclose(
        float(mine.step(cfg, dims, "train")(params, batch)),
        float(theirs.step(jcfg, dims, "train")(jparams, jbatch)), rtol=1e-5)
    got = mine.step(cfg, dims, "prefill")(params, batch)
    want = theirs.step(jcfg, dims, "prefill")(jparams, jbatch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    cache = mine.init_cache(cfg, dims, device="cpu")
    jcache = theirs.init_cache(jcfg, dims)
    dec = mine.make_batch(np.random.default_rng(2), cfg, dims, "decode",
                          device="cpu")
    jdec = theirs.make_batch(np.random.default_rng(2), jcfg, dims, "decode")
    logits, _ = mine.step(cfg, dims, "decode")(params, cache, dec)
    jlogits, _ = theirs.step(jcfg, dims, "decode")(jparams, jcache, jdec)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=2e-5, atol=2e-5)
    p = mine.init(3, cfg, dims, device="cpu")
    assert sum(x.numel() for x in p.parameters()) == cfg.param_count()


@pytest.mark.parametrize("arch", OTHER_IDS)
def test_bundle_of_an_unported_family_raises(arch):
    """The GNN and recsys ids (ported since the twelfth slice): the
    bundle has JAX's family, configs and shape cells; an unknown id
    raises ``KeyError``."""
    mine, theirs = get_bundle(arch), j_get_bundle(arch)
    assert mine.family == theirs.family and mine.family in ("gnn", "recsys")
    assert dataclasses.asdict(mine.config) == dataclasses.asdict(
        theirs.config)
    assert dataclasses.asdict(mine.reduced) == dataclasses.asdict(
        theirs.reduced)
    assert [(c.name, c.dims) for c in mine.shapes] \
        == [(c.name, c.dims) for c in theirs.shapes]
    with pytest.raises(KeyError, match="unknown arch"):
        get_bundle(arch + "-x")
