"""Port parity: async micro-batching, mirror replicas and their parts
(``repro_torch.serve``: queue, cache, balancer, batcher, replica)
against the JAX package's ``repro.serve``, on ``small_index``; and the
launch counters under threads (``kernels.runtime``).

Tolerances, as ``tests/test_torch_pipeline.py``: against the JAX
package integer outputs are equal (``docs_evaluated``; ids except at
non-isolated scores) and scores ``allclose(rtol=1e-5, atol=1e-6)``.
Inside the port every served answer (cached and coalesced ones, every
width of the ladder, every replica count) is bitwise the port's
``search_pipeline``'s. Admission sequences, fingerprints, cache hits and
the balancer's picks equal the JAX package's exactly.

Every server runs in ``with`` (or ``try/finally: stop()``), every
``result()`` has a timeout, and nothing asserts on wall-clock time.
"""
import struct
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.retrieval import SearchParams as JParams
from repro.serve import AsyncSeismicServer as JAsync
from repro.serve import StageTimingBalancer as JBalancer
from repro.serve import cache as jcache
from repro.serve import queue as jqueue
from repro.tune.policy import TunedPolicy as JTuned
from repro_torch.core import make_mutable
from repro_torch.kernels import runtime
from repro_torch.obs import (MetricsRegistry, Observability, ShadowAuditor,
                             parse_prometheus_text, prometheus_text,
                             validate_trace)
from repro_torch.retrieval import SearchParams, search_pipeline
from repro_torch.serve import (AsyncSeismicServer, ReplicaSeismicServer,
                               ServeFuture, ServeResult, StageTimingBalancer,
                               batcher)
from repro_torch.serve import cache as pcache
from repro_torch.serve import queue as pqueue
from repro_torch.sparse.ops import PaddedSparse
from repro_torch.tune.policy import TunedPolicy, attach_tuned
from test_torch_pipeline import assert_topk, carry

KW = dict(k=5, cut=8, block_budget=8)
TIMEOUT = 60.0
# request i asks query ORDER[i]: repeats (cache hits, coalescing) and
# every query of the collection
ORDER = [0, 1, 2, 3, 0, 4, 5, 5, 5, 6, 7, 8, 1, 9, 10, 11, 12, 12, 13, 14,
         15, 0, 3, 7]


def host_queries(small_collection):
    _, queries, *_ = small_collection
    return np.array(queries.coords), np.array(queries.vals)


def serve_all(server, c, v, order=ORDER):
    with server:
        futs = [server.submit(c[i], v[i]) for i in order]
        return [f.result(TIMEOUT) for f in futs]


@pytest.fixture(scope="module")
def index(small_index):
    return carry(small_index[0])


@pytest.fixture(scope="module")
def reference(small_collection, index):
    """The port's search_pipeline on every query of the collection."""
    c, v = host_queries(small_collection)
    return search_pipeline(index, PaddedSparse(torch.from_numpy(c),
                                               torch.from_numpy(v), 1024),
                           SearchParams(**KW))


@pytest.fixture(scope="module")
def jax_answers(small_collection, small_index):
    """The JAX package's AsyncSeismicServer on ORDER."""
    c, v = host_queries(small_collection)
    srv = JAsync(small_index[0], JParams(**KW), max_batch=8,
                 launch_widths=(4,), query_nnz=16, deadline_s=0.01)
    return serve_all(srv, c, v)


def assert_bitwise(results, reference, order=ORDER):
    scores, ids, ev = (t.numpy() for t in reference)
    for r, q in zip(results, order):
        assert isinstance(r, ServeResult)
        np.testing.assert_array_equal(r.ids, ids[q])
        np.testing.assert_array_equal(r.scores, scores[q])
        assert r.docs_evaluated == ev[q]


# --------------------------------------------------- queue and cache

def _admission_log(mod, policy, bound=3):
    """A scripted admission sequence on one package's queue: puts past
    the bound, deadline-driven and full batches, then close."""
    q = mod.RequestQueue(bound=bound, policy=policy)
    log = []
    for i, deadline in enumerate([5.0, 3.0, 9.0, 4.0, 8.0, 1.0]):
        req = mod.Request(coords=np.zeros(2, np.int32),
                          vals=np.zeros(2, np.float32), submit_t=float(i),
                          deadline=deadline, future=mod.ServeFuture())
        status, shed = q.put(req)
        log.append((status, None if shed is None else shed.submit_t,
                    q.depth))
    log.append([r.submit_t for r in q.next_batch(2, now_fn=lambda: 0.0)])
    log.append([r.submit_t for r in q.next_batch(8, now_fn=lambda: 50.0)])
    q.close()
    log.append(q.put(mod.Request(np.zeros(2), np.zeros(2), 9.0, 9.0,
                                 mod.ServeFuture()))[0])
    log.append(q.next_batch(2))
    return log


@pytest.mark.parametrize("policy", ["reject", "shed_oldest"])
def test_admission_sequences_match_reference(policy):
    assert _admission_log(pqueue, policy) == _admission_log(jqueue, policy)
    assert pqueue.ADMISSION_POLICIES == jqueue.ADMISSION_POLICIES
    with pytest.raises(ValueError):
        pqueue.RequestQueue(policy="lifo")


def test_future_completion_is_first_writer_wins():
    f = ServeFuture()
    assert f._set("payload") and not f._fail("error: boom")
    assert f.status == "done" and f.result(1.0) == "payload"
    g = ServeFuture()
    assert g._fail("shed") and not g._set("late")
    with pytest.raises(RuntimeError, match="shed"):
        g.result(1.0)
    with pytest.raises(TimeoutError):
        ServeFuture().result(0.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_fingerprints_are_byte_equal(seed):
    rng = np.random.default_rng(seed)
    c = rng.choice(np.arange(1, 1024), 16, replace=False).astype(np.int32)
    v = rng.uniform(0.2, 1.0, 16).astype(np.float32)
    v[-2:] = 0.0
    for scale in np.geomspace(0.5, 2.0, 33):
        vs = v * np.float32(scale)
        assert pcache.query_fingerprint(c, vs) == \
            jcache.query_fingerprint(c, vs)
        assert pcache.fingerprint_candidates(c, vs) == \
            jcache.fingerprint_candidates(c, vs)
    assert pcache.query_fingerprint(c, np.zeros(16)) == b"empty"


def test_lru_hits_match_reference():
    logs = []
    for mod in (pcache, jcache):
        cache, log = mod.LRUCache(2), []
        for op, key in [("put", b"a"), ("put", b"b"), ("get", b"a"),
                        ("put", b"c"), ("get", b"b"), ("any", (b"x", b"a")),
                        ("get", b"c")]:
            if op == "put":
                cache.put(key, key * 2)
            else:
                log.append(cache.get(key) if op == "get"
                           else cache.get_any(key))
        logs.append((log, cache.stats()))
    assert logs[0] == logs[1]


# ------------------------------------------------------------ balancer

@pytest.mark.parametrize("costs", [(0.009, 0.003, 0.003), (0.001,),
                                   (0.002, 0.010, 0.002, 0.002)])
def test_balancer_picks_match_reference(costs):
    """Scripted costs: equal pick sequences, and the slowest replica gets
    the smallest dispatch share but is never starved."""
    picks = []
    for cls in (StageTimingBalancer, JBalancer):
        bal, seq = cls(len(costs)), []
        for i in range(200):
            rid = bal.pick()
            seq.append(rid)
            if i % 3:                       # some dispatches stay in flight
                bal.record(rid, costs[rid], {"router": costs[rid] / 2})
        picks.append((seq, bal.snapshot()))
    assert picks[0] == picks[1]
    share = picks[0][1]["dispatch_share"]
    slow = int(np.argmax(costs))
    if len(costs) > 1:
        assert share[slow] == min(share) and share[slow] > 0


def test_balancer_validation():
    for bad in (dict(n_replicas=0), dict(n_replicas=2, alpha=0.0),
                dict(n_replicas=2, alpha=1.5)):
        with pytest.raises(ValueError):
            StageTimingBalancer(**bad)


# --------------------------------------------------- counters, threads

class _YieldingCounts(dict):
    """Launch counts whose reads hand the interpreter to another thread,
    as any switch between a read and its write-back would."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        time.sleep(0)
        return value


def test_launch_counts_are_exact_across_threads(monkeypatch):
    """8 threads x 10,000 ``count_launch`` calls count 80,000: the
    counters update under the runtime's lock."""
    monkeypatch.setattr(runtime, "LAUNCHES",
                        _YieldingCounts(runtime.LAUNCHES))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        runtime.reset_launches()
        threads = [threading.Thread(
            target=lambda: [runtime.count_launch("summary_dot")
                            for _ in range(10_000)]) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        assert runtime.LAUNCHES["summary_dot"] == 80_000
    finally:
        sys.setswitchinterval(old)


def test_sync_stream_waits_on_the_current_stream(monkeypatch):
    """On CUDA, ``sync_stream`` synchronizes the current stream, never
    the device; on the CPU it does nothing."""
    waited = []

    class Stream:
        def synchronize(self):
            waited.append("stream")

    def device_wide(*a):
        raise AssertionError("device-wide synchronize")

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    monkeypatch.setattr(torch.cuda, "synchronize", device_wide)
    runtime.sync_stream(torch.device("cuda", 0))
    runtime.sync_stream(torch.device("cpu"))
    assert waited == ["stream"]


# ------------------------------------------------------------- serving

SERVERS = {
    "one width": dict(max_batch=8, launch_widths=(4,), cache_size=0,
                      coalesce=False),
    "ladder, cache, coalesce": dict(max_batch=16, launch_widths=(2, 4, 8),
                                    cache_size=32, coalesce=True),
    "default ladder": dict(max_batch=32, cache_size=8, coalesce=True),
}


@pytest.mark.parametrize("name", sorted(SERVERS))
def test_async_answers_match_pipeline_and_reference(
        small_collection, index, reference, jax_answers, name):
    c, v = host_queries(small_collection)
    srv = AsyncSeismicServer(index, SearchParams(**KW), query_nnz=16,
                             deadline_s=0.01, **SERVERS[name])
    got = serve_all(srv, c, v)
    assert_bitwise(got, reference)
    for g, want in zip(got, jax_answers):
        assert_topk(g.ids[None], g.scores[None], want.ids[None],
                    want.scores[None])
        assert g.docs_evaluated == want.docs_evaluated
    tel = srv.telemetry_export()
    assert tel["counters"]["requests"] == len(ORDER)
    hits = tel["cache"]["hits"] if tel["cache"] is not None else 0
    assert tel["counters"]["served"] + hits == len(ORDER)
    widths = {int(k[len("launch_width_"):]) for k in tel["counters"]
              if k.startswith("launch_width_")}
    assert widths <= set(srv.launch_widths)


def test_ladder_picks_the_smallest_cover(index):
    srv = AsyncSeismicServer(index, SearchParams(**KW), max_batch=128)
    assert srv.launch_widths == (8, 32, 128)
    assert [srv._pick_width(n) for n in (1, 8, 9, 33, 128)] == \
        [8, 8, 32, 128, 128]
    with pytest.raises(ValueError):
        AsyncSeismicServer(index, SearchParams(**KW), max_batch=8,
                           launch_widths=(16,))


def test_cache_and_coalescing_serve_equal_answers(small_collection, index,
                                                  reference):
    """Requests queued before the worker starts coalesce into their
    primary's slot; repeats after it completes are cache hits; both are
    bitwise the launch's answers."""
    c, v = host_queries(small_collection)
    srv = AsyncSeismicServer(index, SearchParams(**KW), max_batch=8,
                             query_nnz=16, cache_size=16, coalesce=True)
    futs = [srv.submit(c[q], v[q]) for q in (3, 3, 3, 4)]
    with srv:
        first = [f.result(TIMEOUT) for f in futs]
        again = srv.submit(c[3], v[3]).result(TIMEOUT)
    assert [r.coalesced for r in first] == [False, True, True, False]
    assert again.cached
    assert_bitwise(first + [again], reference, [3, 3, 3, 4, 3])
    assert srv.telemetry_export()["counters"]["coalesced"] == 2


@pytest.mark.parametrize("n_replicas", [1, 2, 4])
def test_mirror_replicas_are_bitwise_the_async_server(
        small_collection, index, reference, n_replicas):
    c, v = host_queries(small_collection)
    srv = ReplicaSeismicServer(index, SearchParams(**KW),
                               n_replicas=n_replicas, max_batch=4,
                               query_nnz=16, deadline_s=0.005,
                               cache_size=0, coalesce=False)
    got = serve_all(srv, c, v)
    assert_bitwise(got, reference)
    snap = srv.balancer.snapshot()
    assert sum(snap["dispatches"]) == \
        srv.telemetry_export()["counters"]["batches"]
    text = parse_prometheus_text(prometheus_text(srv.telemetry.registry))
    assert len(text["seismic_replica_dispatch_share"]["samples"]) == \
        n_replicas


def test_shard_mode_names_the_missing_module(index):
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        ReplicaSeismicServer(index, SearchParams(**KW), n_replicas=2,
                             mode="shard")
    with pytest.raises(ValueError):
        ReplicaSeismicServer(index, SearchParams(**KW), n_replicas=0)
    with pytest.raises(ValueError):
        ReplicaSeismicServer(index, SearchParams(**KW), n_replicas=2,
                             replica_delay_s=(0.0,))


def test_swap_index_invalidates_cached_results(small_collection, index):
    """Cache keys carry the serving epoch: after ``swap_index`` a cached
    answer is unreachable and the query is answered by the new index."""
    c, v = host_queries(small_collection)
    srv = AsyncSeismicServer(index, SearchParams(**KW), max_batch=8,
                             query_nnz=16, deadline_s=0.02, cache_size=32)
    with srv:
        first = srv.submit(c[0], v[0]).result(TIMEOUT)
        assert srv.submit(c[0], v[0]).result(TIMEOUT).cached
        top = int(first.ids[0])
        mut = make_mutable(index)
        mut.delete_docs([top])
        assert srv.swap_index(mut.index) == 1
        after = srv.submit(c[0], v[0]).result(TIMEOUT)
        assert not after.cached and top not in after.ids
        again = srv.submit(c[0], v[0]).result(TIMEOUT)
        assert again.cached and top not in again.ids
    assert srv.telemetry_export()["counters"]["swaps"] == 1


def test_mirror_swap_reaches_every_replica(small_collection, index):
    c, v = host_queries(small_collection)
    srv = ReplicaSeismicServer(index, SearchParams(**KW), n_replicas=2,
                               max_batch=4, query_nnz=16, deadline_s=0.01,
                               coalesce=False)
    with srv:
        top = int(srv.submit(c[0], v[0]).result(TIMEOUT).ids[0])
        mut = make_mutable(index)
        mut.delete_docs([top])
        srv.apply_mutation(mut)
        for _ in range(8):
            assert top not in srv.submit(c[0], v[0]).result(TIMEOUT).ids
    assert srv.epoch == 1


def test_swap_publishes_params_and_auditor_together(small_collection, index,
                                                    reference):
    """A swap to other params (and their auditor) answers with them from
    the next dispatch on; the old auditor sees no launch of the new
    generation."""
    c, v = host_queries(small_collection)
    p2 = SearchParams(k=5, cut=4, block_budget=2)
    reg = MetricsRegistry()
    a1 = ShadowAuditor(index, SearchParams(**KW), reg, audit_sample_every=1)
    a2 = ShadowAuditor(index, p2, MetricsRegistry(), audit_sample_every=1)
    srv = AsyncSeismicServer(index, SearchParams(**KW), max_batch=4,
                             query_nnz=16, auditor=a1)
    with srv:
        before = [srv.submit(c[q], v[q]).result(TIMEOUT) for q in (0, 1)]
        srv.swap_index(index, p2, auditor=a2)
        after = [srv.submit(c[q], v[q]).result(TIMEOUT) for q in (0, 1)]
    assert_bitwise(before, reference, [0, 1])
    want = search_pipeline(index, PaddedSparse(
        torch.from_numpy(c[:2]), torch.from_numpy(v[:2]), 1024), p2)
    assert_bitwise(after, want, [0, 1])
    assert a1._q.qsize() == 2 and a2._q.qsize() == 2
    assert srv.params == p2 and srv.auditor is a2


def test_tuned_drift_gauges(small_collection, index):
    c, v = host_queries(small_collection)
    p = SearchParams(**KW)
    tuned = attach_tuned(index, [TunedPolicy(
        target=0.9, measured_recall=0.95, measured_cost=100.0,
        policy=p.policy, **KW)])
    srv = AsyncSeismicServer(tuned, p, max_batch=4, query_nnz=16,
                             obs=Observability.create(stage_sample_every=0))
    res = serve_all(srv, c, v, order=list(range(8)))
    mean = np.mean([r.docs_evaluated for r in res])
    parsed = parse_prometheus_text(prometheus_text(srv.telemetry.registry))
    docs = parsed["seismic_tuned_drift_docs"]["samples"]
    ratio = parsed["seismic_tuned_drift_ratio"]["samples"]
    key = (("target", "0.9"),)
    assert docs[("seismic_tuned_drift_docs", key)] == \
        pytest.approx(mean - 100.0)
    assert ratio[("seismic_tuned_drift_ratio", key)] == \
        pytest.approx(mean / 100.0)
    assert JTuned.__dataclass_fields__.keys() == \
        TunedPolicy.__dataclass_fields__.keys()


def test_observed_audited_serving(small_collection, index, reference):
    """Traces, sampled staged launches, device accounting and the shadow
    auditor through the async server; answers stay bitwise."""
    c, v = host_queries(small_collection)
    obs = Observability.create(stage_sample_every=2)
    p = SearchParams(**KW)
    obs.auditor = ShadowAuditor(index, p, obs.registry,
                                audit_sample_every=3)
    srv = AsyncSeismicServer(index, p, max_batch=4, query_nnz=16,
                             deadline_s=0.005, cache_size=16, obs=obs)
    with obs.auditor:
        got = serve_all(srv, c, v)
        obs.auditor.drain()
    assert_bitwise(got, reference)
    traces = obs.tracer.finished()
    assert traces
    for t in traces:
        validate_trace(t)
    names = {s.name for t in traces for s in t.spans}
    assert {"request", "queue_wait", "launch", "stage_router",
            "audit"} <= names
    snap = obs.auditor.snapshot()
    assert snap["audits"] > 0 and snap["errors"] == 0
    assert sum(snap["loss"].values()) == snap["misses"]
    parsed = parse_prometheus_text(prometheus_text(obs.registry))
    for name in ("seismic_stage_modeled_bytes_per_query",
                 "seismic_launch_width_occupancy", "seismic_cache_hit_rate",
                 "seismic_live_recall", "seismic_index_epoch"):
        assert parsed[name]["samples"], name


def test_shed_oldest_admission(small_collection, index):
    c, v = host_queries(small_collection)
    srv = AsyncSeismicServer(index, SearchParams(**KW), max_batch=4,
                             query_nnz=16, queue_bound=2,
                             admission="shed_oldest", coalesce=False)
    futs = [srv.submit(c[q], v[q]) for q in range(4)]
    with srv:
        for f in futs:
            assert f.wait(TIMEOUT)
    assert [f.status for f in futs] == ["shed", "shed", "done", "done"]
    rej = AsyncSeismicServer(index, SearchParams(**KW), max_batch=4,
                             query_nnz=16, queue_bound=1, coalesce=False)
    futs = [rej.submit(c[q], v[q]) for q in range(2)]
    with rej:
        assert futs[0].result(TIMEOUT) is not None
    assert futs[1].status == "rejected"


def test_a_failed_launch_fails_its_futures(small_collection, index,
                                           monkeypatch):
    """An exception inside a launch ends its requests ``error: ...``; the
    worker keeps serving."""
    c, v = host_queries(small_collection)
    real = batcher.search_pipeline
    calls = []

    def failing(*a):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("kernel launch failed")
        return real(*a)

    monkeypatch.setattr(batcher, "search_pipeline", failing)
    srv = AsyncSeismicServer(index, SearchParams(**KW), max_batch=4,
                             query_nnz=16, coalesce=False)
    f = srv.submit(c[0], v[0])
    try:
        srv.start(warmup=False)
        assert f.wait(TIMEOUT)
        assert f.status.startswith("error: RuntimeError: kernel launch")
        ok = srv.submit(c[1], v[1]).result(TIMEOUT)
    finally:
        srv.stop()
    assert ok.ids.shape == (5,)


def test_partial_fulfil_then_failure_keeps_done_futures(small_collection,
                                                        index):
    c, v = host_queries(small_collection)
    srv = AsyncSeismicServer(index, SearchParams(**KW), max_batch=2,
                             query_nnz=16, deadline_s=0.05, cache_size=8,
                             coalesce=False)
    real_put, calls = srv.cache.put, []

    def exploding_put(key, value):
        calls.append(key)
        if len(calls) == 2:
            raise RuntimeError("cache backend down")
        return real_put(key, value)

    srv.cache.put = exploding_put
    f0, f1 = srv.submit(c[0], v[0]), srv.submit(c[1], v[1])
    with srv:
        assert f0.wait(TIMEOUT) and f1.wait(TIMEOUT)
        assert f0.status == "done" and f1.status.startswith("error:")
        assert srv.submit(c[2], v[2]).wait(TIMEOUT)


def test_search_convenience_and_epoch_keys(small_collection, index,
                                          reference):
    c, v = host_queries(small_collection)
    srv = AsyncSeismicServer(index, SearchParams(**KW), max_batch=8,
                             query_nnz=16, cache_size=4)
    try:
        srv.start()
        out = srv.search(PaddedSparse(torch.from_numpy(c),
                                      torch.from_numpy(v), 1024),
                         timeout=TIMEOUT)
    finally:
        srv.stop()
    for got, want in zip((out.scores, out.ids, out.docs_evaluated),
                         reference):
        assert torch.equal(got, want)
    # the epoch prefixes every cache key
    key = srv.cache._d and next(iter(srv.cache._d))
    assert key[:8] == struct.pack("<Q", 0)
    with pytest.raises(RuntimeError, match="stopped"):
        srv.start()
