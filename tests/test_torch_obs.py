"""Port parity: the observability plane (``repro_torch.obs``: trace,
exporters, report, device, quality; ``retrieval.workmodel``,
``core.build.doc_block_map``, the staged pipeline's audit captures)
against the JAX package, on ``small_index`` and a JAX-built kNN graph.

Tolerances:
* text outputs are string-equal for equal contents: Chrome trace JSON,
  Prometheus exposition, the report's tables;
* byte counts, the doc -> block map, miss attribution, Wilson intervals
  and sample statistics are equal;
* captured router scores are ``allclose(rtol=1e-5, atol=1e-6)`` (the
  summation order differs); every integer capture is equal.
"""
import dataclasses
import json
import urllib.request

import numpy as np
import pytest
import torch

from repro.core.build import doc_block_map as jax_doc_block_map
from repro.core.oracle import exact_topk as jax_exact_topk
from repro.graph import build_doc_graph as jax_build_graph
from repro.obs import exporters as jexp
from repro.obs import quality as jq
from repro.obs import report as jrep
from repro.obs import trace as jtrace
from repro.obs.device import DeviceAccounting as JDevice
from repro.obs.registry import MetricsRegistry as JRegistry
from repro.retrieval import SearchParams as JParams
from repro.retrieval import workmodel as jwm
from repro.retrieval.pipeline import run_pipeline_staged as jax_staged
from repro.tune.policy import TunedPolicy as JTuned
from repro_torch.core.build import doc_block_map
from repro_torch.kernels.gather_dot.ops import (CAND_TILE_N,
                                                cand_tiles_processed)
from repro_torch.obs import (FUNNEL_STAGES, DeviceAccounting,
                             MetricsRegistry, Observability, ShadowAuditor,
                             Tracer, chrome_trace_json,
                             parse_prometheus_text, per_query_recall,
                             prometheus_text, recall_at_k, sample_stats,
                             start_exporter, validate_trace,
                             wilson_interval, write_jsonl_snapshot)
from repro_torch.obs import quality as pq
from repro_torch.obs import report
from repro_torch.retrieval import SearchParams, run_pipeline_staged
from repro_torch.retrieval import pipeline as port_pipeline
from repro_torch.retrieval import workmodel as wm
from repro_torch.serve import SeismicServer
from repro_torch.tune.policy import TunedPolicy, attach_tuned
from test_torch_pipeline import assert_scores, carry, port_queries

QUERY = dict(k=5, cut=4, block_budget=2, policy="budget")


@pytest.fixture(scope="module")
def graph_index(small_index):
    """(JAX index with a JAX-built degree-4 graph, the same on the port)."""
    jindex = jax_build_graph(small_index[0], degree=4, batch=256)
    return jindex, carry(jindex)


# ---------------------------------------------------------------- trace

def _fill_tracer(tracer):
    """The same span trees through either package's tracer."""
    t = tracer.start_trace("request", 1.0, width=8)
    tracer.add_span(t, "queue_wait", 1.0, 1.25)
    launch = tracer.add_span(t, "launch", 1.25, 2.0, occupancy=3)
    tracer.add_span(t, "stage_router", 1.3, 1.5, parent=launch)
    tracer.end_trace(t, 2.0, status="done", docs_evaluated=40)
    u = tracer.start_trace("request", 3.0)
    tracer.end_trace(u, 3.5, status="done", cached=True)
    return [t, u]


def test_chrome_trace_json_is_string_equal():
    jt, pt = jtrace.Tracer(capacity=4), Tracer(capacity=4)
    jtr, ptr = _fill_tracer(jt), _fill_tracer(pt)
    assert chrome_trace_json(ptr) == jtrace.chrome_trace_json(jtr)
    assert pt.export_chrome() == jt.export_chrome()
    for t in pt.finished():
        validate_trace(t)
    assert report.slowest_traces_table(pt.export_chrome(), 2) == \
        jrep.slowest_traces_table(jt.export_chrome(), 2)


@pytest.mark.parametrize("fault", ["open", "outside", "orphan"])
def test_validate_trace_rejects_as_reference(fault):
    def broken(mod):
        tracer = mod.Tracer()
        t = tracer.start_trace("request", 1.0)
        if fault == "open":
            tracer.add_span(t, "launch", 1.1)
        elif fault == "outside":
            tracer.add_span(t, "launch", 0.5, 1.2)
        else:
            t.spans.append(mod.Span(t.trace_id, 99, 98, "lost", 1.1, 1.2))
        tracer.end_trace(t, 1.5)
        return t
    with pytest.raises(ValueError) as want:
        jtrace.validate_trace(broken(jtrace))
    from repro_torch.obs import trace
    with pytest.raises(ValueError) as got:
        validate_trace(broken(trace))
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ exporters

def _fill_registry(reg):
    c = reg.counter("seismic_events_total", "Serving events", ("event",))
    c.labels("requests").inc(7)
    c.labels('odd "quoted"\nname\\').inc(2)
    reg.gauge("seismic_index_epoch", "Generation").labels().set(3)
    reg.gauge("seismic_cb", "callback").labels().set_fn(lambda: 0.25)
    h = reg.histogram("seismic_latency_seconds", "Latency", ("span",))
    for x in (1e-4, 2e-3, 2e-3, 0.5):
        h.labels("launch").record(x)
    return reg


def test_prometheus_text_is_string_equal_and_round_trips():
    jreg, reg = _fill_registry(JRegistry()), _fill_registry(
        MetricsRegistry())
    text = prometheus_text(reg)
    assert text == jexp.prometheus_text(jreg)
    assert parse_prometheus_text(text) == jexp.parse_prometheus_text(text)
    parsed = parse_prometheus_text(text)
    ev = parsed["seismic_events_total"]["samples"]
    assert ev[("seismic_events_total", (("event", "requests"),))] == 7.0
    assert ev[("seismic_events_total",
               (("event", 'odd "quoted"\nname\\'),))] == 2.0
    assert report.snapshot_table(reg.snapshot()) == \
        jrep.snapshot_table(jreg.snapshot())


def test_exporter_endpoints_and_jsonl(tmp_path):
    reg = _fill_registry(MetricsRegistry())
    tracer = Tracer()
    _fill_tracer(tracer)
    rec = write_jsonl_snapshot(reg, str(tmp_path / "s.jsonl"),
                               extra={"tag": "t"})
    assert rec["tag"] == "t" and "seismic_index_epoch" in rec["metrics"]
    with start_exporter(reg, tracer, quality=lambda: {"k": 5}) as ex:
        def get(path):
            with urllib.request.urlopen(ex.url + path, timeout=10) as r:
                return r.read().decode()
        assert parse_prometheus_text(get("/metrics")) == \
            parse_prometheus_text(prometheus_text(reg))
        assert json.loads(get("/healthz")) == {"status": "ok"}
        assert json.loads(get("/quality.json")) == {"k": 5}
        assert len(json.loads(get("/traces"))["traceEvents"]) == 5
    assert report.main(["--snapshot", str(tmp_path / "s.jsonl")]) == 0


# ------------------------------------------------------------ workmodel

@pytest.mark.parametrize("fuse", [0, 1, 2])
@pytest.mark.parametrize("route", [dict(), dict(
    n_superblocks=8, fanout=4, superblock_budget=6, superblock_nnz=128)])
def test_router_bytes_match_reference(fuse, route):
    kw = dict(cut=8, n_blocks=12, summary_nnz=32, dim=1024,
              fuse_level=fuse, **route)
    assert wm.router_bytes(**kw) == jwm.router_bytes(**kw)


@pytest.mark.parametrize("fuse", [0, 1, 2])
@pytest.mark.parametrize("quant", [False, True])
def test_scorer_and_refine_bytes_match_reference(fuse, quant):
    s = dict(n_slots=256, scored_slots=96, nnz=48, quant=quant, dim=1024,
             fuse_level=fuse)
    assert wm.scorer_bytes(**s) == jwm.scorer_bytes(**s)
    r = dict(k=10, degree=4, rounds=2, nnz=48, quant=quant, dim=1024,
             fuse_level=fuse)
    assert wm.refine_bytes(**r) == jwm.refine_bytes(**r)
    assert wm.refine_bytes(**r, scored_slots_per_round=7) == \
        jwm.refine_bytes(**r, scored_slots_per_round=7)


def test_workmodel_counts_the_planes_element_sizes():
    """u16 coordinates and bf16 values: each forward entry moves 4 bytes
    where the reference's i32/f32 model counts 8."""
    kw = dict(n_slots=100, scored_slots=100, nnz=128, quant=False,
              dim=30522, fuse_level=1)
    assert wm.scorer_bytes(**kw) - wm.scorer_bytes(
        **kw, coord_bytes=2, val_bytes=2) == 100 * 128 * 4
    assert wm.summary_row_bytes(96, coord_bytes=2) == 96 * 3 + 8


# --------------------------------------------------------------- device

@pytest.mark.parametrize("fuse", [0, 1, 2])
def test_device_accounting_matches_reference(small_collection, graph_index,
                                             fuse):
    """The static router and refine bytes equal the JAX package's on an
    i32/f32 index; the scorer charges the port kernel's processed tiles
    (``CAND_TILE_N``-candidate tiles)."""
    _, queries, *_ = small_collection
    jindex, index = graph_index
    kw = dict(QUERY, graph_degree=4, refine_rounds=2, fuse_level=fuse)
    jreg, reg = JRegistry(), MetricsRegistry()
    jdev = JDevice(jindex, JParams(**kw), jreg)
    dev = DeviceAccounting(index, SearchParams(**kw), reg)
    assert dev._static == jdev._static
    assert dev.scorer_bytes_per_query() == jdev.scorer_bytes_per_query()
    probed = {}
    pq_ = port_queries(queries)
    run_pipeline_staged(index, pq_.coords, pq_.vals, SearchParams(**kw),
                        probe=probed.__setitem__)
    cand = probed["cand"]
    dev.observe({"router": 0.5, "scorer": 0.25, "refine": 0.0}, 16,
                cand=cand)
    tiles = int(cand_tiles_processed(cand, index.n_docs).sum())
    scored = tiles * CAND_TILE_N // cand.shape[0] if fuse else cand.shape[1]
    want = wm.scorer_bytes(n_slots=cand.shape[1], scored_slots=scored,
                           nnz=index.fwd.coords.shape[1], quant=False,
                           dim=index.dim, fuse_level=fuse)
    snap = reg.snapshot()
    got = {tuple(sorted(s["labels"].items())): s["value"] for s in
           snap["seismic_stage_modeled_bytes_per_query"]["samples"]}
    assert got[(("fuse_level", str(fuse)), ("stage", "scorer"))] == want
    rates = {s["labels"]["stage"]: s["value"] for s in
             snap["seismic_stage_achieved_bytes_per_second"]["samples"]}
    assert rates["scorer"] == want * 16 / 0.25
    assert "refine" not in rates             # zero seconds: no rate


# ---------------------------------------------------------------- quality

def test_doc_block_map_matches_reference(graph_index):
    jindex, index = graph_index
    want = jax_doc_block_map(jindex)
    got = doc_block_map(index, list_chunk=100)
    for a, b in zip(got, want):
        assert a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)


def test_wilson_and_recall_match_reference():
    for s, n in ((0, 0), (0, 10), (9, 10), (10, 10), (731, 800)):
        assert wilson_interval(s, n) == jq.wilson_interval(s, n)
        assert wilson_interval(s, n, 2.5) == jq.wilson_interval(s, n, 2.5)
    ids = np.array([[1, 2, -1, 2], [4, 5, 6, 7]])
    ex = np.array([[1, 3, -1, 8], [7, 6, 5, 4]])
    assert recall_at_k(ids[0], ex[0]) == jq.recall_at_k(ids[0], ex[0])
    np.testing.assert_array_equal(per_query_recall(torch.from_numpy(ids),
                                                   ex),
                                  jq.per_query_recall(ids, ex))


def test_sample_stats_match_reference(small_collection):
    _, queries, *_ = small_collection
    c, v = np.array(queries.coords), np.array(queries.vals)
    want = jq.sample_stats(c, v, 1024, n_hist_buckets=16)
    got = sample_stats(torch.from_numpy(c), torch.from_numpy(v), 1024,
                       n_hist_buckets=16)
    assert set(got) == set(want)
    for key in want:
        if key == "topcoord_hist":
            np.testing.assert_array_equal(got[key], want[key])
        else:
            assert got[key] == want[key], key


def _captures(small_collection, jindex, index, kw):
    """Staged captures (``audit=True``) of both packages on equal
    queries, and the port's without ``audit``."""
    _, queries, *_ = small_collection
    jprobe, probe, bare = {}, {}, {}
    jout = jax_staged(jindex, queries.coords, queries.vals, JParams(**kw),
                      probe=jprobe.__setitem__, audit=True)
    pq_ = port_queries(queries)
    p = SearchParams(use_kernel=False, fuse_level=0, **kw)
    out = run_pipeline_staged(index, pq_.coords, pq_.vals, p,
                              probe=probe.__setitem__, audit=True)
    run_pipeline_staged(index, pq_.coords, pq_.vals, p, None, None, None,
                        False, bare.__setitem__)
    return jout, jprobe, out, probe, bare


@pytest.mark.parametrize("refine", [False, True])
def test_staged_audit_captures_match_reference(small_collection,
                                               graph_index, refine):
    jindex, index = graph_index
    kw = dict(QUERY, graph_degree=4 if refine else 0,
              refine_rounds=1 if refine else 0)
    _, jprobe, out, probe, bare = _captures(small_collection, jindex, index,
                                            kw)
    assert set(probe) == {"cand", "lists", "router_r", "merge_ids"}
    assert set(bare) == {"cand"}                   # only with audit=True
    np.testing.assert_array_equal(probe["cand"].numpy(), jprobe["cand"])
    np.testing.assert_array_equal(probe["lists"].numpy(), jprobe["lists"])
    assert_scores(probe["router_r"].numpy(), np.asarray(jprobe["router_r"]))
    np.testing.assert_array_equal(probe["merge_ids"].numpy(),
                                  jprobe["merge_ids"])
    assert torch.equal(bare["cand"], probe["cand"])


def test_staged_pipeline_syncs_once_per_stage(small_collection, graph_index,
                                              monkeypatch):
    """Each stage (and refine round) waits on the calling thread's
    stream through ``sync_stream``, never on the whole device."""
    _, queries, *_ = small_collection
    index = graph_index[1]
    calls = []
    monkeypatch.setattr(port_pipeline, "sync_stream", calls.append)
    pq_ = port_queries(queries)
    p = SearchParams(**dict(QUERY, graph_degree=4, refine_rounds=2))
    run_pipeline_staged(index, pq_.coords, pq_.vals, p, split_refine=True)
    assert calls == [index.device] * 7       # 5 stages + 2 rounds
    calls.clear()
    run_pipeline_staged(index, pq_.coords, pq_.vals, p)
    assert calls == [index.device] * 6


@pytest.mark.parametrize("refine", [False, True])
def test_funnel_and_audit_match_reference(small_collection, graph_index,
                                          refine):
    """On the same captures both packages' auditors see the same misses
    and attribute each to the same stage, and their windows agree."""
    _, queries, *_ = small_collection
    jindex, index = graph_index
    kw = dict(QUERY, graph_degree=4 if refine else 0,
              refine_rounds=1 if refine else 0)
    jout, jprobe, out, probe, _ = _captures(small_collection, jindex, index,
                                            kw)
    jaud = jq.ShadowAuditor(jindex, JParams(**kw), JRegistry(),
                            audit_sample_every=1)
    aud = ShadowAuditor(index, SearchParams(**kw), MetricsRegistry(),
                        audit_sample_every=1)
    c, v = np.array(queries.coords), np.array(queries.vals)
    jids = np.asarray(jout[1])
    view, jview = pq._OracleView(index), jq._OracleView(jindex)
    for i in range(c.shape[0]):
        jaud.audit_once(c[i], v[i], jids[i], captures=jprobe, row=i)
        aud.audit_once(torch.from_numpy(c[i]), v[i], out[1][i],
                       captures=probe, row=i)
        # the same attribution on the JAX package's own captures
        _, eids = jax_exact_topk(jview.fwd_coords, jview.fwd_vals,
                                 jview.dim, c[i], v[i], kw["k"])
        np.testing.assert_array_equal(view.exact_ids(c[i], v[i], kw["k"]),
                                      eids)
        missing = sorted({int(x) for x in eids} - set(jids[i].tolist()))
        args = dict(cand_row=jprobe["cand"][i], lists_row=jprobe["lists"][i],
                    router_r_row=jprobe["router_r"][i], q_coords=c[i],
                    q_vals=v[i], n_blocks=jindex.config.n_blocks,
                    n_docs=jindex.n_docs,
                    knn_ids=np.asarray(jindex.knn_ids) if refine else None,
                    merge_row=jprobe["merge_ids"][i] if refine else None)
        assert pq.attribute_misses(missing, doc_map=view.doc_map, **args) \
            == jq.attribute_misses(missing, doc_map=jview.doc_map, **args)
    js, ps = jaud.snapshot(), aud.snapshot()
    assert ps["misses"] > 0                  # the small budget must bite
    assert sum(ps["loss"].values()) == ps["misses"]
    for key in ("window", "loss", "misses", "audits", "errors"):
        assert ps[key] == js[key], key
    assert report.funnel_table(ps) == jrep.funnel_table(js)


def test_oracle_view_dequantizes_as_reference(graph_index):
    from repro.graph import compact_forward_index as jax_compact
    jindex = jax_compact(graph_index[0])
    view, jview = pq._OracleView(carry(jindex)), jq._OracleView(jindex)
    np.testing.assert_array_equal(view.fwd_vals.numpy(), jview.fwd_vals)
    for got, want in zip(view.doc_map, jview.doc_map):
        np.testing.assert_array_equal(got, want)


def test_auditor_worker_drift_and_target(small_collection, small_index):
    """The worker thread audits fed requests; drift against the sample
    itself is none; the target resolves from a matching policy."""
    _, queries, *_ = small_collection
    kw = dict(QUERY, policy="adaptive")
    index = attach_tuned(carry(small_index[0]), [TunedPolicy(
        target=0.9, measured_recall=0.95, measured_cost=50.0, **kw)])
    c, v = np.asarray(queries.coords), np.asarray(queries.vals)
    ref = sample_stats(c, v, index.dim)
    reg = MetricsRegistry()
    aud = ShadowAuditor(index, SearchParams(**kw), reg, reference=ref)
    assert aud.target == 0.9
    assert ShadowAuditor(index, SearchParams(**dict(kw, block_budget=4)),
                         MetricsRegistry()).target is None
    jref = jq.sample_stats(c, v, index.dim)
    jaud = jq.ShadowAuditor(dataclasses.replace(
        small_index[0], tuned=(JTuned(target=0.9, measured_recall=0.95,
                                      measured_cost=50.0, **kw),)),
        JParams(**kw), JRegistry(), reference=jref)
    with aud:
        for i in range(c.shape[0]):
            aud.feed(c[i], v[i], np.zeros(5, np.int64))
            jaud.audit_once(c[i], v[i], np.zeros(5, np.int64))
        aud.drain()
    assert aud.snapshot()["audits"] == c.shape[0]
    assert aud.drift() == jaud.drift()
    assert aud.drift()["in_sample"] == 1.0
    assert aud.slo_state == jaud.slo_state == "breach"
    assert parse_prometheus_text(prometheus_text(reg))[
        "seismic_recall_slo_state"]["samples"][
            ("seismic_recall_slo_state", ())] == 2.0


def test_full_audit_queue_sheds(small_collection, small_index):
    _, queries, *_ = small_collection
    aud = ShadowAuditor(carry(small_index[0]), SearchParams(**QUERY),
                        MetricsRegistry(), queue_bound=1)
    c, v = np.asarray(queries.coords[0]), np.asarray(queries.vals[0])
    for _ in range(3):
        aud.feed(c, v, np.zeros(5, np.int64))
    assert aud.snapshot()["dropped"] == 2 and aud.snapshot()["audits"] == 0


def test_sync_server_with_obs_matches_pipeline(small_collection,
                                               graph_index):
    """``SeismicServer(obs=...)``: sampled staged launches and audited
    rows give the fused path's answers, traced and accounted."""
    _, queries, *_ = small_collection
    index = graph_index[1]
    p = SearchParams(**dict(QUERY, graph_degree=4, refine_rounds=2,
                            fuse_level=2))
    obs = Observability.create(stage_sample_every=2)
    obs.auditor = ShadowAuditor(index, p, obs.registry,
                                audit_sample_every=3)
    pq_ = port_queries(queries)
    srv = SeismicServer(index, p, max_batch=4, obs=obs)
    plain = SeismicServer(index, p, max_batch=4)
    got, want = srv.search(pq_), plain.search(pq_)
    for a, b in zip((got.ids, got.scores, got.docs_evaluated),
                    (want.ids, want.scores, want.docs_evaluated)):
        assert torch.equal(a, b)
    traces = obs.tracer.finished()
    assert len(traces) == 4                      # every launch: audited
    for t in traces:
        validate_trace(t)
        names = {s.name for s in t.spans}
        assert {"stage_router", "refine_round_1", "audit"} <= names
    assert obs.auditor._q.qsize() == 6           # 16 rows, every third
    snap = obs.registry.snapshot()
    assert "seismic_stage_achieved_bytes_per_second" in snap
    assert snap["seismic_events_total"]["samples"]


def test_sync_server_launch_waits_on_its_stream(small_collection,
                                                small_index, monkeypatch):
    """A telemetry launch of ``SeismicServer`` is timed to a synchronize
    of the calling thread's stream (``sync_stream``)."""
    from repro_torch.serve import ServerTelemetry, engine
    _, queries, *_ = small_collection
    index = carry(small_index[0])
    calls = []
    monkeypatch.setattr(engine, "sync_stream", calls.append)
    srv = SeismicServer(index, SearchParams(**QUERY), max_batch=8,
                        telemetry=ServerTelemetry())
    srv.search(port_queries(queries))
    assert calls == [index.device] * 2
    assert FUNNEL_STAGES == jq.FUNNEL_STAGES
