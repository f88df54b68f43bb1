"""Port parity: doc-sharded search (``repro_torch.core.distributed``) and
the replica server's shard mode (``serve.replica``) against the JAX
package's ``repro.core.distributed`` and ``repro.serve.replica``.

Tolerances:
* ``shard_collection``, ``mask_shard_topk`` and every per-shard plane of
  ``build_sharded_index`` are equal (bitwise) to the JAX package's;
* ``make_distributed_search`` on 8 gloo ranks as a ``(2, 4)`` mesh
  against the JAX package's 8-host-device ``shard_map`` run: ids equal,
  scores ``allclose(rtol=1e-5, atol=1e-6)`` (summation order differs
  between XLA and torch), and bitwise the port's in-process
  ``search_shards``;
* inside the port the shard-mode server's answers (ids, scores,
  ``docs_evaluated``) are bitwise ``search_shards``'s.

The ranks are separate processes on a free local port, so parallel test
workers do not collide; every wait has a timeout.
"""
import dataclasses
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from helpers import REPO, run_with_devices
from repro.core import SeismicConfig as JConfig
from repro.core import distributed as jdist
from repro.data import SyntheticSparseConfig, make_collection
from repro.sparse.ops import PaddedSparse as JPadded
from repro_torch.core import distributed as pdist
from repro_torch.core.types import SeismicConfig, index_from_arrays
from repro_torch.retrieval import SearchParams, search_pipeline
from repro_torch.serve import ReplicaSeismicServer
from repro_torch.sparse.ops import PaddedSparse

RTOL, ATOL = 1e-5, 1e-6
TIMEOUT = 60.0
CFG = SyntheticSparseConfig(dim=512, n_docs=1022, n_queries=16, doc_nnz=32,
                            query_nnz=12, n_topics=16, topic_coords=96,
                            seed=3)
ICFG = dict(lam=96, beta=8, alpha=0.4, block_cap=24, summary_nnz=24)
POINTS = {"flat": dict(k=10, cut=8, block_budget=32, policy="adaptive"),
          "budget": dict(k=10, cut=8, block_budget=8, policy="budget")}
N_SHARDS = 4


@pytest.fixture(scope="module")
def collection():
    docs, queries, _ = make_collection(CFG)
    return (np.array(docs.coords), np.array(docs.vals),
            np.array(queries.coords), np.array(queries.vals))


def jax_sparse(c, v):
    return JPadded(jnp.asarray(c), jnp.asarray(v), CFG.dim)


def port_sparse(c, v):
    return PaddedSparse(torch.from_numpy(c), torch.from_numpy(v), CFG.dim)


@pytest.fixture(scope="module")
def sharded(collection):
    dc, dv, _, _ = collection
    return pdist.build_sharded_index(port_sparse(dc, dv),
                                     SeismicConfig(**ICFG), N_SHARDS)


@pytest.mark.parametrize("n_shards", [3, 4, 7])
def test_shard_collection_matches_reference(collection, n_shards):
    dc, dv, _, _ = collection
    j = jdist.shard_collection(jax_sparse(dc, dv), n_shards)
    p = pdist.shard_collection(port_sparse(dc, dv), n_shards)
    assert p.coords.shape == j.coords.shape      # 1022 docs: a padded tail
    np.testing.assert_array_equal(p.coords.numpy(), np.asarray(j.coords))
    np.testing.assert_array_equal(p.vals.numpy(), np.asarray(j.vals))


@pytest.mark.parametrize("n_docs", [None, 1022, 1000])
def test_mask_shard_topk_matches_reference(collection, n_docs):
    """Pad hits (the all-zero tail rows of the last shard), -1 slots and
    ids past ``n_docs`` all come out as (-inf, -1), as in JAX."""
    dc, dv, _, _ = collection
    j = jdist.shard_collection(jax_sparse(dc, dv), N_SHARDS)
    fwd_c, fwd_v = np.asarray(j.coords[-1]), np.asarray(j.vals[-1])
    per = fwd_c.shape[0]                       # 256 rows, the last 2 pads
    rng = np.random.default_rng(0)
    ids = rng.integers(per - 12, per, (6, 10)).astype(np.int32)
    ids[:, -2] = -1
    ids[0, :3] = [per - 1, per - 2, 0]          # two pad rows and a live one
    scores = rng.uniform(0, 5, (6, 10)).astype(np.float32)
    scores[ids < 0] = -np.inf
    off = (N_SHARDS - 1) * per
    js, jg = jdist.mask_shard_topk(jnp.asarray(scores), jnp.asarray(ids),
                                   jax_sparse(fwd_c, fwd_v), off,
                                   n_docs=n_docs)
    ps, pg = pdist.mask_shard_topk(torch.from_numpy(scores),
                                   torch.from_numpy(ids),
                                   port_sparse(fwd_c, fwd_v), off,
                                   n_docs=n_docs)
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    assert (pg[0, :2] == -1).all() and pg[0, 2] == off


def test_build_sharded_index_planes_match_reference(collection, sharded):
    dc, dv, _, _ = collection
    j = jdist.build_sharded_index(jax_sparse(dc, dv), JConfig(**ICFG),
                                  N_SHARDS)
    assert sharded.n_shards == N_SHARDS and sharded.n_docs == CFG.n_docs
    for s in range(N_SHARDS):
        shard = sharded.shard(s)
        np.testing.assert_array_equal(shard.fwd.coords.numpy(),
                                      np.asarray(j.fwd.coords[s]))
        np.testing.assert_array_equal(shard.fwd.vals.numpy(),
                                      np.asarray(j.fwd.vals[s]))
        for f in dataclasses.fields(j):
            v = getattr(j, f.name)
            if f.name in ("fwd", "config", "tuned") or v is None:
                continue
            np.testing.assert_array_equal(getattr(shard, f.name).numpy(),
                                          np.asarray(v[s]), err_msg=f.name)


# ------------------------------------------------ make_distributed_search

JAX_CODE = r"""
import sys, dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.core import SeismicConfig, SearchParams
from repro.core.distributed import build_sharded_index, make_distributed_search
from repro.sparse.ops import PaddedSparse
a = np.load(sys.argv[1])
docs = PaddedSparse(jnp.asarray(a["dc"]), jnp.asarray(a["dv"]), {dim})
stacked = build_sharded_index(docs, SeismicConfig(**{icfg}), n_shards=4)
out = {{"fwd_coords": np.asarray(stacked.fwd.coords),
       "fwd_vals": np.asarray(stacked.fwd.vals)}}
for f in dataclasses.fields(stacked):
    v = getattr(stacked, f.name)
    if f.name not in ("fwd", "config", "tuned") and v is not None:
        out[f.name] = np.asarray(v)
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
for name, kw in {points}.items():
    search = make_distributed_search(mesh, SearchParams(**kw),
                                     doc_axes=("model",), data_axis="data",
                                     n_docs={n_docs})
    with jax.set_mesh(mesh):
        s, ids = jax.jit(search)(stacked, jnp.asarray(a["qc"]),
                                 jnp.asarray(a["qv"]))
    out[name + "_scores"] = np.asarray(s)
    out[name + "_ids"] = np.asarray(ids)
np.savez(sys.argv[2], **out)
print("OK jax")
"""

RANK_CODE = r"""
import sys
import numpy as np, torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.core.distributed import make_distributed_search
from repro_torch.core.types import index_from_arrays
from repro_torch.retrieval import SearchParams
rank, world, port, src, dst = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{{port}}",
                        world_size=world, rank=rank)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
a = np.load(src)
s = mesh.get_local_rank("model")
planes = {{k[4:]: a[k][s] for k in a.files if k.startswith("idx_")}}
local = index_from_arrays(planes, {dim}, {icfg}, device="cpu")
qc, qv = torch.from_numpy(a["qc"]), torch.from_numpy(a["qv"])
out = {{}}
for name, kw in {points}.items():
    search = make_distributed_search(
        mesh, SearchParams(use_kernel=False, fuse_level=0, **kw),
        doc_axes=("model",), data_axis="data", n_docs={n_docs})
    scores, ids = search(local, qc, qv)
    out[name + "_scores"], out[name + "_ids"] = scores.numpy(), ids.numpy()
if rank == 0:
    np.savez(dst, **out)
dist.destroy_process_group()
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(code: str, world: int, *args, timeout: float = 240.0):
    """``world`` processes of ``code`` (rank, world, port, *args) that meet
    on a free local port; raises with their output if any fails."""
    port = str(free_port())
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r),
                               str(world), port, *args], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError("a rank failed:\n" + "\n".join(
            f"--- rank {r} (rc {p.returncode})\n{o}"
            for r, (p, o) in enumerate(zip(procs, outs))))


def test_distributed_search_8_ranks_matches_jax_8_devices(collection,
                                                          tmp_path):
    """8 gloo ranks as a (2, 4) mesh of ("data", "model") against JAX's
    shard_map on 8 host devices: the same stacked index (JAX's, carried
    shard by shard), the same 16 queries."""
    dc, dv, qc, qv = collection
    src, jout, pout = (str(tmp_path / n) for n in
                       ("in.npz", "jax.npz", "port.npz"))
    np.savez(src, dc=dc, dv=dv, qc=qc, qv=qv)
    fmt = dict(dim=CFG.dim, icfg=ICFG, points=POINTS, n_docs=CFG.n_docs)
    code = JAX_CODE.format(**fmt).replace("sys.argv[1]", repr(src)) \
        .replace("sys.argv[2]", repr(jout))
    assert "OK jax" in run_with_devices(code, n_devices=8, timeout=600)
    j = np.load(jout)
    planes = {f"idx_{k}": j[k] for k in j.files
              if not k.endswith(("_scores", "_ids"))}
    np.savez(src, qc=qc, qv=qv, **planes)
    run_ranks(RANK_CODE.format(**fmt), 8, src, pout)
    p = np.load(pout)
    shards = tuple(index_from_arrays(
        {k[4:]: v[s] for k, v in planes.items()}, CFG.dim, ICFG,
        device="cpu") for s in range(N_SHARDS))
    stacked = pdist.ShardedIndex(shards=shards, n_docs=CFG.n_docs)
    for name, kw in POINTS.items():
        np.testing.assert_array_equal(p[name + "_ids"], j[name + "_ids"])
        np.testing.assert_allclose(p[name + "_scores"], j[name + "_scores"],
                                   rtol=RTOL, atol=ATOL)
        ref = pdist.search_shards(
            stacked, port_sparse(qc, qv),
            SearchParams(use_kernel=False, fuse_level=0, **kw))
        np.testing.assert_array_equal(p[name + "_ids"], ref[1].numpy())
        np.testing.assert_array_equal(p[name + "_scores"], ref[0].numpy())


# ---------------------------------------------------------- shard mode

def serve(server, c, v, order):
    with server:
        futs = [server.submit(c[i], v[i]) for i in order]
        return [f.result(TIMEOUT) for f in futs]


def assert_answers(got, ref, order):
    s, i, e = (t.numpy() for t in ref)
    for r, q in zip(got, order):
        np.testing.assert_array_equal(r.ids, i[q])
        np.testing.assert_array_equal(r.scores.view(np.int32),
                                      s[q].view(np.int32))
        assert r.docs_evaluated == e[q]


@pytest.mark.parametrize("point", sorted(POINTS))
def test_shard_mode_matches_in_process_reference(collection, sharded, point):
    """Every answer bitwise ``search_shards``'s; ``docs_evaluated`` the
    sum of the shards' own counts."""
    _, _, qc, qv = collection
    p = SearchParams(**POINTS[point])
    ref = pdist.search_shards(sharded, port_sparse(qc, qv), p)
    per_shard = sum(search_pipeline(sharded.shard(s), port_sparse(qc, qv),
                                    p)[2] for s in range(N_SHARDS))
    np.testing.assert_array_equal(ref[2].numpy(), per_shard.numpy())
    srv = ReplicaSeismicServer(sharded, p, mode="shard", max_batch=4,
                               query_nnz=CFG.query_nnz, deadline_s=0.005,
                               cache_size=0, coalesce=False)
    assert srv.n_replicas == N_SHARDS
    order = list(range(16)) + [3, 0, 7]
    assert_answers(serve(srv, qc, qv, order), ref, order)
    snap = srv.telemetry.registry.snapshot()
    sent = [x["value"] for x in
            snap["seismic_replica_dispatches_total"]["samples"]]
    assert len(sent) == N_SHARDS and len(set(sent)) == 1
    assert sent[0] == srv.telemetry_export()["counters"]["batches"]


def test_shard_mode_swap_in_flight_is_never_torn(collection, sharded):
    """A swap to another point while requests are in flight: every answer
    is wholly one point's (never a merge of two generations), and every
    request submitted after the swap returns is the new point's."""
    _, _, qc, qv = collection
    pa, pb = (SearchParams(**POINTS[n]) for n in ("flat", "budget"))
    refs = [pdist.search_shards(sharded, port_sparse(qc, qv), p)
            for p in (pa, pb)]
    srv = ReplicaSeismicServer(sharded, pa, mode="shard", max_batch=4,
                               query_nnz=CFG.query_nnz, deadline_s=0.002,
                               cache_size=0, coalesce=False,
                               replica_delay_s=[0.0, 0.004, 0.0, 0.002])
    got: list = []

    def client():
        for rep in range(6):
            for q in range(16):
                got.append((q, srv.submit(qc[q], qv[q])))
                threading.Event().wait(0.002)

    with srv:
        t = threading.Thread(target=client)
        t.start()
        while len(got) < 24:
            threading.Event().wait(0.001)
        assert srv.swap_index(sharded, pb) == 1
        t.join(TIMEOUT)
        after = [srv.submit(qc[q], qv[q]) for q in range(16)]
        results = [(q, f.result(TIMEOUT)) for q, f in got]
        late = [f.result(TIMEOUT) for f in after]
    seen = set()
    for q, r in results:
        which = [k for k, ref in enumerate(refs)
                 if np.array_equal(r.ids, ref[1][q].numpy())
                 and np.array_equal(r.scores.view(np.int32),
                                    ref[0][q].numpy().view(np.int32))
                 and r.docs_evaluated == int(ref[2][q])]
        assert which, f"query {q}: a torn or foreign answer"
        seen.update(which)
    assert seen == {0, 1}
    assert_answers(late, refs[1], list(range(16)))


def test_shard_mode_rejects_stage_timing_and_a_mismatched_count(sharded):
    p = SearchParams(**POINTS["flat"])
    with pytest.raises(ValueError, match="stage_timing"):
        ReplicaSeismicServer(sharded, p, mode="shard", stage_timing=True)
    with pytest.raises(ValueError, match="n_replicas"):
        ReplicaSeismicServer(sharded, p, mode="shard", n_replicas=3)
    srv = ReplicaSeismicServer(sharded, p, mode="shard")
    small = pdist.ShardedIndex(shards=sharded.shards[:2],
                               n_docs=sharded.n_docs)
    with pytest.raises(ValueError, match="cannot resize"):
        srv.swap_index(small)
