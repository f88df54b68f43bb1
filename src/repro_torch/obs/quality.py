"""Quality observability plane: shadow-oracle recall auditing,
per-stage loss attribution, and query-drift alerting (port of
``repro.obs.quality``).

The latency and byte metrics do not show whether the recall a
``TunedPolicy`` promises holds once traffic is live. This module is the
recall half:

``recall_at_k``     the port's one recall implementation
                    (``core.oracle.recall_at_k``, re-exported).
``ShadowAuditor``   samples every ``audit_sample_every``-th served
                    request into a bounded off-hot-path queue, recomputes
                    the exact top-k on a background thread and its own
                    CUDA stream (``core.oracle.exact_topk`` over the
                    index's forward plane, on the index's device), and
                    emits windowed live-recall gauges with Wilson
                    confidence intervals plus an ok/warn/breach SLO state
                    machine against the tuned recall target.
``attribute_misses`` the loss-attribution funnel: every missed oracle
                    doc maps to EXACTLY ONE dropping stage —

    router      no probed list routed any block holding the doc (the
                doc is reachable only through unprobed coordinates,
                dead blocks, or superblock-pruned blocks)
    selector    at least one routed block holds the doc, but the
                selector cut every such block (budget/threshold), so
                the doc was never exactly scored
    scorer      the doc WAS exactly scored (it is in the scorer's
                candidate row) yet lost the merge — u8 quantization
                error or a score tie displaced it
    refine      the doc sat in the refine stage's expansion frontier
                (a graph neighbor of the merged top-k) and refinement
                still did not keep it

The attribution is a total function over misses, so per-query funnel
counts sum to exactly the miss count — the benchmark gate.

Drift sketches: the auditor compares live query shape (nnz, L1 mass,
top-coordinate histogram, canonical row digests) against
:func:`sample_stats` of the tuning sample, so an SLO breach can be
triaged as "queries moved" vs "index degraded".

Ground truth caveat: the oracle scores through the index's forward
plane (u8 dequantized as the JAX package does, bf16 widened exactly to
float64): it measures what the index *could* return, which is the right
referent for attributing pipeline losses.
"""
from __future__ import annotations

import collections
import math
import queue
import threading

import numpy as np
import torch

from repro_torch.core.oracle import exact_topk, recall_at_k
from repro_torch.device import host_array as _host
from repro_torch.device import new_stream, on_stream

FUNNEL_STAGES = ("router", "selector", "scorer", "refine")
SLO_STATES = ("ok", "warn", "breach")


# --------------------------------------------------------------- recall


def per_query_recall(ids, exact_ids) -> np.ndarray:
    """Row-wise :func:`recall_at_k` over [Q, k] batches -> f64 [Q]."""
    ids = _host(ids)
    exact_ids = _host(exact_ids)
    return np.array([recall_at_k(ids[q], exact_ids[q])
                     for q in range(ids.shape[0])], np.float64)


def wilson_interval(successes: int, trials: int,
                    z: float = 1.96) -> tuple[float, float]:
    """Wilson score interval for a binomial proportion.

    Returns the maximally uninformative ``(0.0, 1.0)`` at zero trials.
    Unlike the normal approximation it never leaves [0, 1] and stays
    honest at the p≈1 recalls this plane watches.
    """
    if trials <= 0:
        return 0.0, 1.0
    n = float(trials)
    p = successes / n
    z2 = z * z
    denom = 1.0 + z2 / n
    center = (p + z2 / (2.0 * n)) / denom
    half = z * math.sqrt(p * (1.0 - p) / n + z2 / (4.0 * n * n)) / denom
    return max(0.0, center - half), min(1.0, center + half)


# -------------------------------------------------------- drift sketch

def sample_stats(coords, vals, dim: int, *,
                 n_hist_buckets: int = 32) -> dict:
    """Shape statistics of a query sample — the drift reference.

    Returns mean nnz / mean L1 mass, a normalized histogram of each
    query's heaviest coordinate over ``n_hist_buckets`` equal
    coordinate ranges, and the set of canonical per-row digests
    (:func:`repro_torch.tune.policy.row_digests`) so served queries can be
    tested for literal membership in the tuning sample.
    """
    c = _host(coords)
    v = _host(vals).astype(np.float32)
    live = v > 0
    nnz = live.sum(axis=1)
    l1 = np.where(live, v, 0.0).sum(axis=1)
    top = np.take_along_axis(c, np.argmax(v, axis=1)[:, None],
                             axis=1)[:, 0]
    buckets = np.clip(top.astype(np.int64) * n_hist_buckets // max(dim, 1),
                      0, n_hist_buckets - 1)
    hist = np.bincount(buckets, minlength=n_hist_buckets).astype(np.float64)
    hist /= max(hist.sum(), 1.0)
    from repro_torch.tune.policy import row_digests
    return {"n": int(c.shape[0]), "dim": int(dim),
            "n_hist_buckets": int(n_hist_buckets),
            "mean_nnz": float(nnz.mean()) if nnz.size else 0.0,
            "mean_l1": float(l1.mean()) if l1.size else 0.0,
            "topcoord_hist": hist,
            "digests": frozenset(row_digests(c, v))}


# ------------------------------------------------------------- funnel

def attribute_misses(missing_ids, *, cand_row, lists_row, router_r_row,
                     q_coords, q_vals, doc_map, n_blocks: int,
                     n_docs: int, knn_ids=None,
                     merge_row=None) -> dict[int, str]:
    """Attribute each missed oracle doc to exactly one dropping stage.

    Inputs are ONE query's audit captures: the scorer candidate row
    (``cand``, sentinel-padded — exactly the set of exactly-scored
    docs, because the scorer masks docs of unselected blocks to the
    sentinel before dedupe), the probed coordinate row (``lists``),
    the flat router score row (``router_r``, ``-inf`` = dead or
    pruned, laid out ``slot * n_blocks + block``), and — when the
    params refine — the pre-refine merged ids plus the index's kNN
    rows (trimmed to the served ``graph_degree``). ``doc_map`` is
    :func:`repro_torch.core.build.doc_block_map`'s CSR doc -> (list,
    block) membership as numpy arrays. Every input is one row on the
    host.

    Precedence (first match wins): scorer > refine > selector >
    router. Multi-round refinement uses the round-0 frontier — later
    rounds expand from docs already attributed by earlier checks.
    Total function: ``len(result) == len(missing_ids)`` always.
    """
    cand = np.asarray(cand_row).reshape(-1)
    cand_set = {int(x) for x in cand if 0 <= x < n_docs}
    frontier: set[int] = set()
    if knn_ids is not None and merge_row is not None:
        m = np.asarray(merge_row).reshape(-1)
        m = m[(m >= 0) & (m < n_docs)]
        if m.size:
            nbrs = np.asarray(knn_ids)[m].reshape(-1)
            frontier = {int(x) for x in nbrs if 0 <= x < n_docs}
    qpos = {int(c) for c, v in zip(np.asarray(q_coords).reshape(-1),
                                   np.asarray(q_vals).reshape(-1))
            if v > 0}
    slots_of: dict[int, list[int]] = {}
    for s, coord in enumerate(np.asarray(lists_row).reshape(-1)):
        coord = int(coord)
        if coord in qpos:           # skip padded probe slots (coord 0)
            slots_of.setdefault(coord, []).append(s)
    r_row = np.asarray(router_r_row, np.float64).reshape(-1)
    indptr, mem_lists, mem_blocks = doc_map
    out: dict[int, str] = {}
    for d in missing_ids:
        d = int(d)
        if d in cand_set:
            out[d] = "scorer"
            continue
        if d in frontier:
            out[d] = "refine"
            continue
        routed = False
        for j in range(int(indptr[d]), int(indptr[d + 1])):
            slots = slots_of.get(int(mem_lists[j]))
            if not slots:
                continue
            b = int(mem_blocks[j])
            if any(np.isfinite(r_row[s * n_blocks + b]) for s in slots):
                routed = True
                break
        out[d] = "selector" if routed else "router"
    return out


# ------------------------------------------------------------ auditor

# documents scored per step of an audit's exact top-k (bounds the float64
# gather of one query to 256 MiB at 128 non-zeros a document)
AUDIT_DOC_CHUNK = 1 << 18


class _OracleView:
    """The index's forward plane on its own device, ready for the exact
    top-k (u8 values dequantized to float64 as the JAX package does;
    bf16 and f32 widen exactly, per chunk, inside ``exact_topk``), and
    the funnel's structural maps on the host. Built once, lazily, on the
    audit worker thread and its stream."""

    def __init__(self, index):
        from repro_torch.core.build import doc_block_map
        q = index.fwd.vals
        if index.fwd_scale is not None:
            scale = index.fwd_scale.to(torch.float64)[:, None]
            zero = index.fwd_zero.to(torch.float64)[:, None]
            self.fwd_vals = torch.where(
                q > 0, (q.to(torch.float64) - 1.0) * scale + zero, 0.0)
        else:
            self.fwd_vals = q
        self.fwd_coords = index.fwd.coords
        self.device = index.device
        self.dim = index.dim
        self.n_docs = index.n_docs
        self.n_blocks = index.config.n_blocks
        self.doc_map = tuple(t.cpu().numpy() for t in doc_block_map(index))
        self.knn = None if index.knn_ids is None \
            else index.knn_ids.cpu().numpy()

    def exact_ids(self, coords: np.ndarray, vals: np.ndarray,
                  k: int) -> np.ndarray:
        """One query's exact top-k doc ids (ties keep the lower id)."""
        qc = torch.from_numpy(coords)[None].to(self.device)
        qv = torch.from_numpy(vals)[None].to(self.device)
        _, ids = exact_topk(self.fwd_coords, self.fwd_vals, self.dim, qc, qv,
                            k, doc_chunk=AUDIT_DOC_CHUNK)
        return ids[0].cpu().numpy()


class _AuditItem:
    __slots__ = ("coords", "vals", "ids", "captures")

    def __init__(self, coords, vals, ids, captures):
        self.coords = coords
        self.vals = vals
        self.ids = ids
        self.captures = captures


_CAPTURE_KEYS = ("cand", "lists", "router_r", "merge_ids")


class ShadowAuditor:
    """Shadow-oracle live-recall auditor for one serving operating
    point.

    The serving hot path calls :meth:`plan` once per launch (a counter
    bump) and, for each selected row, :meth:`feed` (row copies +
    ``put_nowait``; a full queue sheds the sample and increments
    ``seismic_audit_dropped_total`` — auditing never backpressures
    traffic). A daemon worker thread recomputes exact top-k per audited
    request, updates the sliding recall window, attributes misses
    through the funnel when stage captures rode along, and folds the
    query's drift features in.

    On a CUDA index the oracle runs on a stream of its own, which waits
    for the stream that was current when the auditor was made (the one
    that built the index), so it never reads a plane before it is
    written. :meth:`start` builds the oracle's view of the index (the
    doc -> block map, dequantized values) before the worker starts, so
    its device work and its device-to-host copies happen before traffic,
    not under it.

    ``target`` defaults to the attached ``TunedPolicy`` whose knobs
    match ``params`` (same resolution as the serving drift gauges);
    with no match the SLO machine reports ``ok`` forever. Pass
    ``target=`` explicitly to audit a deliberately mistuned point.

    Metrics (on ``registry``): ``seismic_audits_total``,
    ``seismic_audit_dropped_total``, ``seismic_audit_errors_total``,
    ``seismic_recall_loss_total{stage}``, ``seismic_live_recall{k}``
    (+ ``_wilson_lo`` / ``_wilson_hi``), ``seismic_recall_slo_state``
    (0=ok 1=warn 2=breach), ``seismic_recall_slo_target``, and — when
    a ``reference`` from :func:`sample_stats` is given —
    ``seismic_query_drift_nnz`` / ``_l1`` (live/reference mean ratio),
    ``seismic_query_drift_topcoord_tv`` (total variation distance),
    ``seismic_query_drift_in_sample`` (fraction of windowed queries
    literally in the tuning sample). One auditor per registry: the
    gauge callbacks are last-writer-wins.
    """

    def __init__(self, index, params, registry, *,
                 audit_sample_every: int = 64, queue_bound: int = 128,
                 window: int = 512, target: float | None = None,
                 reference: dict | None = None, z: float = 1.96):
        self.index = index
        self.params = params
        self.registry = registry
        self.audit_sample_every = int(audit_sample_every)
        self.z = float(z)
        self.reference = reference
        if target is None:
            from repro_torch.tune.policy import matching_policy
            match = matching_policy(index, params)
            target = match.target if match is not None else None
        self.target = target
        self._q: queue.Queue = queue.Queue(maxsize=queue_bound)
        self._lock = threading.Lock()
        self._served = 0
        self._win: collections.deque = collections.deque(maxlen=window)
        self._loss = {s: 0 for s in FUNNEL_STAGES}
        self._funnel_misses = 0
        self._view: _OracleView | None = None
        self._thread: threading.Thread | None = None
        self._stream = new_stream(index.device)
        self._register_metrics()

    # -------------------------------------------------------- metrics

    def _register_metrics(self) -> None:
        reg = self.registry
        self._c_audits = reg.counter(
            "seismic_audits_total",
            "Shadow-oracle audits completed").labels()
        self._c_dropped = reg.counter(
            "seismic_audit_dropped_total",
            "Audit samples shed because the audit queue was full"
            ).labels()
        self._c_errors = reg.counter(
            "seismic_audit_errors_total",
            "Audits aborted by an exception on the worker").labels()
        self._c_loss = reg.counter(
            "seismic_recall_loss_total",
            "Missed oracle docs attributed to the stage that dropped "
            "them", ("stage",))
        for s in FUNNEL_STAGES:        # pre-create: funnel rows scrape as 0
            self._c_loss.labels(s)
        k = str(self.params.k)
        reg.gauge("seismic_live_recall",
                  "Windowed live recall@k from shadow audits",
                  ("k",)).labels(k) \
            .set_fn(lambda: self.window_stats()["live_recall"])
        reg.gauge("seismic_live_recall_wilson_lo",
                  "Wilson lower bound of the windowed live recall",
                  ("k",)).labels(k) \
            .set_fn(lambda: self.window_stats()["wilson_lo"])
        reg.gauge("seismic_live_recall_wilson_hi",
                  "Wilson upper bound of the windowed live recall",
                  ("k",)).labels(k) \
            .set_fn(lambda: self.window_stats()["wilson_hi"])
        reg.gauge("seismic_recall_slo_state",
                  "Recall SLO state: 0=ok 1=warn 2=breach").labels() \
            .set_fn(lambda: float(SLO_STATES.index(self.slo_state)))
        reg.gauge("seismic_recall_slo_target",
                  "Recall target the SLO machine compares against "
                  "(0 = no target attached)").labels() \
            .set(self.target if self.target is not None else 0.0)
        if self.reference is not None:
            reg.gauge("seismic_query_drift_nnz",
                      "Windowed mean query nnz over the tuning sample's"
                      ).labels().set_fn(lambda: self.drift()["nnz_ratio"])
            reg.gauge("seismic_query_drift_l1",
                      "Windowed mean query L1 mass over the tuning "
                      "sample's").labels() \
                .set_fn(lambda: self.drift()["l1_ratio"])
            reg.gauge("seismic_query_drift_topcoord_tv",
                      "Total variation distance between live and "
                      "tuning top-coordinate histograms").labels() \
                .set_fn(lambda: self.drift()["topcoord_tv"])
            reg.gauge("seismic_query_drift_in_sample",
                      "Fraction of windowed queries literally in the "
                      "tuning sample").labels() \
                .set_fn(lambda: self.drift()["in_sample"])

    # ------------------------------------------------------ lifecycle

    def start(self) -> "ShadowAuditor":
        if self._thread is not None:
            raise RuntimeError("auditor already started")
        if self._view is None:
            with on_stream(self._stream):
                self._view = _OracleView(self.index)
        self._thread = threading.Thread(target=self._worker,
                                        name="seismic-auditor",
                                        daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        if self._thread is None:
            return
        self._q.put(None)               # blocking: the sentinel must land
        self._thread.join()
        self._thread = None

    def __enter__(self) -> "ShadowAuditor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def drain(self) -> None:
        """Block until every queued audit has been processed (the
        worker must be running)."""
        self._q.join()

    # ------------------------------------------------------- hot path

    def plan(self, n: int) -> tuple[int, ...]:
        """Which of the next ``n`` served requests to audit — row
        offsets into the launch. One counter bump under the lock;
        cadence is global across every thread that dispatches."""
        e = self.audit_sample_every
        if e <= 0 or n <= 0:
            return ()
        with self._lock:
            start = self._served
            self._served += n
        return tuple(range((-start) % e, n, e))

    def feed(self, coords, vals, ids, *, captures=None,
             row: int = 0) -> None:
        """Enqueue one served request for audit (row copies only; the
        oracle runs on the worker). ``captures`` is the staged
        pipeline's probe dict for the whole launch; ``row`` selects
        this request's rows. Sheds (and counts) when the queue is
        full."""
        item = self._make_item(coords, vals, ids, captures, row)
        try:
            self._q.put_nowait(item)
        except queue.Full:
            self._c_dropped.inc()

    def audit_once(self, coords, vals, ids, *, captures=None,
                   row: int = 0) -> None:
        """Synchronous single-request audit (tests, overhead
        measurement) — same computation as the worker path."""
        self._audit(self._make_item(coords, vals, ids, captures, row))

    def _make_item(self, coords, vals, ids, captures, row) -> _AuditItem:
        caps = None
        if captures is not None:
            caps = {}
            for key in _CAPTURE_KEYS:
                a = captures.get(key)
                if a is None:
                    caps = None
                    break
                caps[key] = _host(a[row]).copy()
        return _AuditItem(_host(coords).astype(np.int32).copy(),
                          _host(vals).astype(np.float32).copy(),
                          _host(ids).astype(np.int64).copy(), caps)

    # --------------------------------------------------------- worker

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                with on_stream(self._stream):
                    self._audit(item)
            except Exception:   # noqa: BLE001 — auditing must not kill serving
                self._c_errors.inc()
            finally:
                self._q.task_done()

    def _audit(self, item: _AuditItem) -> None:
        if self._view is None:
            self._view = _OracleView(self.index)
        view = self._view
        p = self.params
        eids = view.exact_ids(item.coords, item.vals, p.k)
        exact = {int(x) for x in eids}
        approx = {int(x) for x in item.ids if x >= 0}
        hits = len(approx & exact)
        trials = len(exact)
        missing = sorted(exact - approx)
        attributed: dict[int, str] = {}
        if item.captures is not None and missing:
            refine_on = (p.refine_rounds > 0 and p.graph_degree > 0
                         and view.knn is not None)
            attributed = attribute_misses(
                missing, cand_row=item.captures["cand"],
                lists_row=item.captures["lists"],
                router_r_row=item.captures["router_r"],
                q_coords=item.coords, q_vals=item.vals,
                doc_map=view.doc_map, n_blocks=view.n_blocks,
                n_docs=view.n_docs,
                knn_ids=view.knn[:, :p.graph_degree]
                if refine_on else None,
                merge_row=item.captures["merge_ids"]
                if refine_on else None)
        nnz, l1, bucket, in_ref = self._features(item)
        with self._lock:
            self._win.append((hits, trials, nnz, l1, bucket, in_ref))
            for stage in attributed.values():
                self._loss[stage] += 1
            if item.captures is not None:
                self._funnel_misses += len(missing)
        for stage in attributed.values():
            self._c_loss.labels(stage).inc()
        self._c_audits.inc()

    def _features(self, item: _AuditItem):
        live = item.vals > 0
        nnz = int(live.sum())
        l1 = float(item.vals[live].sum())
        ref = self.reference
        nb = ref["n_hist_buckets"] if ref is not None else 32
        dim = ref["dim"] if ref is not None else self.index.dim
        top = int(item.coords[int(np.argmax(item.vals))])
        bucket = min(max(top * nb // max(dim, 1), 0), nb - 1)
        in_ref = False
        if ref is not None and ref.get("digests"):
            from repro_torch.tune.policy import row_digest
            in_ref = row_digest(item.coords, item.vals) in ref["digests"]
        return nnz, l1, bucket, in_ref

    # -------------------------------------------------------- reading

    def window_stats(self) -> dict:
        with self._lock:
            rows = list(self._win)
        hits = sum(r[0] for r in rows)
        trials = sum(r[1] for r in rows)
        lo, hi = wilson_interval(hits, trials, self.z)
        return {"audited": len(rows), "hits": hits, "trials": trials,
                "live_recall": hits / trials if trials else 0.0,
                "wilson_lo": lo, "wilson_hi": hi}

    @property
    def slo_state(self) -> str:
        st = self.window_stats()
        if self.target is None or st["trials"] == 0:
            return "ok"
        if st["wilson_hi"] < self.target:
            return "breach"
        if st["live_recall"] < self.target:
            return "warn"
        return "ok"

    def drift(self) -> dict:
        """Live-vs-reference drift sketch over the current window."""
        ref = self.reference
        with self._lock:
            rows = list(self._win)
        if ref is None or not rows:
            return {"nnz_ratio": 1.0, "l1_ratio": 1.0,
                    "topcoord_tv": 0.0, "in_sample": 0.0}
        n = len(rows)
        nnz = sum(r[2] for r in rows) / n
        l1 = sum(r[3] for r in rows) / n
        nb = ref["n_hist_buckets"]
        hist = np.bincount([r[4] for r in rows],
                           minlength=nb).astype(np.float64) / n
        tv = 0.5 * float(np.abs(hist - ref["topcoord_hist"]).sum())
        return {"nnz_ratio": nnz / max(ref["mean_nnz"], 1e-12),
                "l1_ratio": l1 / max(ref["mean_l1"], 1e-12),
                "topcoord_tv": tv,
                "in_sample": sum(r[5] for r in rows) / n}

    def snapshot(self) -> dict:
        """JSON-serializable quality snapshot — the ``/quality.json``
        payload and the benchmark artifact record."""
        with self._lock:
            loss = dict(self._loss)
            funnel_misses = self._funnel_misses
            served = self._served
        return {"k": self.params.k,
                "target": self.target,
                "slo_state": self.slo_state,
                "served": served,
                "audit_sample_every": self.audit_sample_every,
                "audits": int(self._c_audits.value),
                "dropped": int(self._c_dropped.value),
                "errors": int(self._c_errors.value),
                "window": self.window_stats(),
                "loss": loss,
                "misses": funnel_misses,
                "drift": self.drift() if self.reference is not None
                else None}


__all__ = ["recall_at_k", "per_query_recall", "wilson_interval",
           "sample_stats", "attribute_misses", "ShadowAuditor",
           "FUNNEL_STAGES", "SLO_STATES"]
