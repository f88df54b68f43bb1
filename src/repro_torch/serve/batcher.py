"""Deadline-based micro-batching front end over the staged pipeline (port
of ``repro.serve.batcher``).

``AsyncSeismicServer`` accepts single queries (``submit``) from any
thread and gathers whatever is in flight into fixed-shape
``[width, query_nnz]`` launches of ``search_pipeline`` (dispatch on a
full batch or on the oldest deadline). Launch widths come from a ladder
(default ``8/32/128`` clipped to ``max_batch``): each dispatch pads to
the smallest width covering the batch, so a lone tail request does not
pay ``max_batch`` rows of work. Every width runs once through the
kernels at warmup (``nvcc`` and the allocator's first growth happen
there, not under a deadline); per-width dispatch counts land in
telemetry (``launch_width_<w>``). Around that core sit admission control
(bounded queue, ``reject`` / ``shed_oldest``), a quantized-fingerprint
LRU result cache, request coalescing (concurrently in-flight requests
with identical fingerprints share one launch slot) and telemetry.

On a CUDA index the worker thread launches on a CUDA stream of its own.
That stream waits for the stream that was current when the server was
made and at every ``swap_index`` (the one that built or compacted the
index), so no launch reads a plane before it is written. Each launch
copies its queries to the card in one pinned host-to-device copy and its
ids, scores and ``docs_evaluated`` back in one device-to-host copy, then
synchronizes its own stream only.

Observability (``obs=Observability.create()``): a trace is minted at
``submit`` and every request produces a span tree (``request`` root,
``queue_wait`` and ``launch`` children, and on every
``stage_sample_every``-th launch the six ``stage_*`` children plus
``refine_round_<j>`` grandchildren). The registry gains the serving
gauges (cache hit rate, shed and deadline-miss rates, occupancy per
width, tuned-policy drift) and, through
:class:`repro_torch.obs.device.DeviceAccounting`, modeled bytes and
achieved rates per stage on every staged launch.
"""
from __future__ import annotations

import dataclasses
import struct
import threading
import time

import numpy as np
import torch

from repro_torch.core.types import SeismicIndex
from repro_torch.device import host_array, new_stream, on_stream
from repro_torch.kernels.runtime import sync_stream
from repro_torch.obs.device import DeviceAccounting
from repro_torch.retrieval import SearchParams, search_pipeline
from repro_torch.retrieval.pipeline import (run_pipeline_staged, stage_fns,
                                            validate_params)
from repro_torch.serve.cache import LRUCache, fingerprint_candidates
from repro_torch.serve.queue import Request, RequestQueue, ServeFuture
from repro_torch.serve.telemetry import ServerTelemetry
from repro_torch.sparse.ops import PaddedSparse
from repro_torch.tune.policy import matching_policy, validate_tuned_index


@dataclasses.dataclass
class ServeResult:
    """Per-request retrieval result with serving metadata (host arrays)."""

    ids: np.ndarray            # int32 [k], -1 padding
    scores: np.ndarray         # f32 [k]
    docs_evaluated: int
    cached: bool = False
    coalesced: bool = False    # fulfilled from another request's slot
    latency_s: float = 0.0     # submit -> fulfil wall time
    occupancy: int = 0         # real queries in the serving launch


@dataclasses.dataclass(frozen=True)
class _Generation:
    """What one launch runs against, snapshotted together under the swap
    lock so a launch never mixes two generations."""

    index: SeismicIndex
    params: SearchParams
    fns: dict | None
    device: DeviceAccounting | None
    auditor: object | None


def attach_stage_spans(tracer, trace, parent, triples) -> None:
    """Turn ``run_pipeline_staged`` span triples ``(name, t0, t1)`` into
    child spans of ``parent``: ``stage_<name>`` for the six stages, with
    ``refine_round_<j>`` entries nested under the ``stage_refine`` span."""
    rounds = [t for t in triples if t[0].startswith("refine_round_")]
    refine_span = None
    for name, a, b in triples:
        if name.startswith("refine_round_"):
            continue
        sp = tracer.add_span(trace, f"stage_{name}", a, b, parent=parent)
        if name == "refine":
            refine_span = sp
    for name, a, b in rounds:
        tracer.add_span(trace, name, a, b,
                        parent=refine_span if refine_span is not None
                        else parent)


class AsyncSeismicServer:
    """Micro-batching async retrieval server over one Seismic index.

    Parameters
    ----------
    max_batch     maximum launch width; a dispatch never carries more
                  than this many distinct requests.
    launch_widths ascending launch widths (the ladder). ``None`` selects
                  ``(8, 32, 128)`` clipped to ``max_batch`` (always the
                  top rung). Each dispatch pads to the smallest rung
                  covering the batch.
    query_nnz     fixed per-query nnz width; longer queries keep their
                  ``query_nnz`` heaviest coordinates.
    deadline_s    default max time a request may wait for co-batching
                  before a (possibly partial) launch is forced.
    queue_bound   admission limit; beyond it ``admission`` applies
                  ("reject" new requests or "shed_oldest" queued ones).
    cache_size    LRU entries keyed on quantized query fingerprints;
                  0 disables caching.
    coalesce      share one launch slot among concurrently in-flight
                  requests with identical quantized fingerprints.
    stage_timing  serve every launch through the staged pipeline and
                  record ``stage_*`` latency histograms.
    obs           a ``repro_torch.obs.Observability`` bundle: request
                  tracing, the serving gauges, and sampled staged
                  launches with device accounting. Without
                  ``telemetry`` the telemetry facade writes into the
                  bundle's registry.
    auditor       a ``repro_torch.obs.ShadowAuditor`` (default
                  ``obs.auditor``): every ``audit_sample_every``-th
                  served request is copied off the hot path for
                  shadow-oracle recall auditing; audited launches run
                  the staged pipeline with the funnel's captures and
                  carry an ``audit`` span. The owner starts and closes
                  its worker.
    deadline_grace_s  slack before a dispatch past its deadline counts
                  as a deadline miss.

    A launch that raises fails its requests' futures (``status`` ``error:
    ...``) and the server keeps serving; nothing falls back to the CPU or
    to the plain versions.
    """

    DEFAULT_WIDTHS = (8, 32, 128)

    def __init__(self, index: SeismicIndex, params: SearchParams, *,
                 max_batch: int = 32, query_nnz: int = 32,
                 launch_widths: tuple[int, ...] | None = None,
                 deadline_s: float = 2e-3, queue_bound: int = 1024,
                 admission: str = "reject", cache_size: int = 0,
                 coalesce: bool = True, stage_timing: bool = False,
                 telemetry: ServerTelemetry | None = None,
                 obs=None, auditor=None,
                 deadline_grace_s: float = 1e-3):
        validate_params(index, params)      # fail before threads spin
        validate_tuned_index(index)         # a stale TunedPolicy, too
        self.max_batch = max_batch
        if launch_widths is None:
            launch_widths = tuple(w for w in self.DEFAULT_WIDTHS
                                  if w < max_batch)
        else:
            if any(w <= 0 or w > max_batch for w in launch_widths):
                raise ValueError(
                    f"launch_widths {launch_widths} must lie in "
                    f"[1, max_batch={max_batch}]")
            launch_widths = tuple(w for w in launch_widths
                                  if w < max_batch)
        # max_batch is always the top rung, so every batch has a cover
        self.launch_widths = tuple(sorted(set(launch_widths))) \
            + (max_batch,)
        self.query_nnz = query_nnz
        self.deadline_s = deadline_s
        self.deadline_grace_s = deadline_grace_s
        self.stage_timing = stage_timing
        self.obs = obs
        self.queue = RequestQueue(bound=queue_bound, policy=admission)
        self.cache = LRUCache(cache_size) if cache_size > 0 else None
        self.coalesce = coalesce
        self._inflight: dict[bytes, Request] = {}
        self._coalesce_lock = threading.Lock()
        # serving epoch: bumped on every swap_index and baked into every
        # cache/coalesce key, so a result computed against an earlier
        # index is never served after a swap
        self.epoch = 0
        self._swap_lock = threading.RLock()
        if telemetry is not None:
            self.telemetry = telemetry
        else:
            self.telemetry = ServerTelemetry(
                registry=obs.registry if obs is not None else None)
        self._tracer = obs.tracer if obs is not None else None
        if auditor is None:
            auditor = getattr(obs, "auditor", None)
        # an auditor needs the staged path: audited launches run staged
        # to capture the funnel's memberships
        self._staged_wanted = stage_timing or auditor is not None or (
            obs is not None and obs.stage_sample_every > 0)
        self._gen = self._generation(index, params, auditor)
        # launch counters are shared by every thread that may dispatch
        # (one worker here; N replica workers in ReplicaSeismicServer)
        self._stats_lock = threading.Lock()
        self._launch_seq = 0
        self._width_stats: dict[int, list[int]] = {}   # w -> [launches,
        self._ev_sum = 0.0                             #       slots]
        self._ev_n = 0
        self._stream = new_stream(index.device)
        self._register_gauges()
        self._thread: threading.Thread | None = None

    # ---------------------------------------------------- the generation

    def _generation(self, index, params, auditor) -> _Generation:
        fns = stage_fns(index, params) if self._staged_wanted else None
        device = DeviceAccounting(index, params, self.telemetry.registry) \
            if fns is not None else None
        return _Generation(index, params, fns, device, auditor)

    @property
    def index(self) -> SeismicIndex:
        return self._gen.index

    @property
    def params(self) -> SearchParams:
        return self._gen.params

    @property
    def auditor(self):
        return self._gen.auditor

    def _streams(self) -> list:
        """The CUDA streams this server's workers launch on."""
        return [] if self._stream is None else [self._stream]

    # ------------------------------------------------------ observability

    def _event(self, name: str):
        """Current value of one ``seismic_events_total`` counter."""
        return self.telemetry.registry.counter(
            "seismic_events_total", labels=("event",)).labels(name).value

    def _register_gauges(self) -> None:
        """Derived serving gauges, evaluated at scrape time. One bundle
        per server: servers sharing a registry would make the last one
        win these callbacks."""
        reg = self.telemetry.registry
        reg.gauge("seismic_index_epoch",
                  "Generation of the index being served (bumped on "
                  "every swap_index / mutation publish)").labels() \
            .set_fn(lambda: self.epoch)
        reg.gauge("seismic_cache_hit_rate",
                  "LRU result-cache hit rate since start").labels() \
            .set_fn(lambda: self.cache.stats()["hit_rate"]
                    if self.cache is not None else 0.0)
        reg.gauge("seismic_shed_rate",
                  "(shed + rejected) / submitted requests").labels() \
            .set_fn(lambda: (self._event("shed")
                             + self._event("rejected"))
                    / max(1, self._event("requests")))
        reg.gauge("seismic_deadline_miss_rate",
                  "dispatches later than deadline + grace / dispatched"
                  ).labels() \
            .set_fn(lambda: self._event("deadline_missed")
                    / max(1, self._event("dispatched")))
        self._width_occ = reg.gauge(
            "seismic_launch_width_occupancy",
            "Mean real-request fill fraction per compiled launch width",
            ("width",))
        self._ev_mean = reg.gauge(
            "seismic_docs_evaluated_mean",
            "Running mean docs exactly scored per served query"
            ).labels()
        self._tuned_match = matching_policy(self.index, self.params)
        if self._tuned_match is not None:
            cost = self._tuned_match.measured_cost
            reg.gauge("seismic_tuned_drift_docs",
                      "Served mean docs_evaluated minus the attached "
                      "TunedPolicy's measured cost", ("target",)) \
                .labels(f"{self._tuned_match.target:g}") \
                .set_fn(lambda: (self._ev_sum / self._ev_n - cost)
                        if self._ev_n else 0.0)
            reg.gauge("seismic_tuned_drift_ratio",
                      "Served mean docs_evaluated over the attached "
                      "TunedPolicy's measured cost", ("target",)) \
                .labels(f"{self._tuned_match.target:g}") \
                .set_fn(lambda: (self._ev_sum / self._ev_n / cost)
                        if self._ev_n and cost else 1.0)

    # ------------------------------------------------------- lifecycle

    def start(self, warmup: bool = True) -> "AsyncSeismicServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        if self.queue.closed:
            raise RuntimeError("server was stopped; its queue is closed "
                               "— build a new AsyncSeismicServer")
        if warmup:
            self.warmup()
        self._thread = threading.Thread(target=self._worker,
                                        name="seismic-batcher",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Close admission, drain queued requests, join the worker."""
        self.queue.close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "AsyncSeismicServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def warmup(self) -> None:
        """Run every ladder width once on each worker stream, through the
        fused pipeline and (with stage timing or sampled stage tracing)
        the staged one, before serving traffic."""
        for stream in self._streams() or [None]:
            with on_stream(stream):
                self._warmup_for(self._gen)

    def _warmup_for(self, gen: _Generation) -> None:
        """Warmup body against an explicit generation, so ``swap_index``
        can run the incoming index before it is published."""
        dev = gen.index.device
        for width in self.launch_widths:
            coords = torch.zeros((width, self.query_nnz), dtype=torch.int32,
                                 device=dev)
            vals = torch.zeros((width, self.query_nnz), dtype=torch.float32,
                               device=dev)
            if not self.stage_timing:
                search_pipeline(gen.index,
                                PaddedSparse(coords, vals, gen.index.dim),
                                gen.params)
            if gen.fns is not None:
                run_pipeline_staged(gen.index, coords, vals, gen.params,
                                    fns=gen.fns, split_refine=True)
            sync_stream(dev)

    # ----------------------------------------------------- index swap

    def swap_index(self, index: SeismicIndex,
                   params: SearchParams | None = None, *,
                   warmup: bool = True, auditor=None) -> int:
        """Atomically publish a new index (and optionally new params and
        a new shadow auditor for them); returns the new serving epoch.

        Every dispatch snapshots the generation (index, params, stage
        functions, device accounting, auditor) under ``_swap_lock``, so a
        launch runs entirely against one generation. The epoch bump makes
        every pre-swap cache/coalesce key unreachable. Requests already
        dispatched against the old index still complete; their results
        are cached under old-epoch keys, i.e. dropped. Every worker
        stream waits for the caller's current stream (which built or
        compacted ``index``) before the generation is published.

        With ``warmup`` (default) the new index runs every ladder width
        first, on the caller's stream, off the serving path."""
        params = self.params if params is None else params
        validate_params(index, params)
        validate_tuned_index(index)
        gen = self._generation(index, params,
                               self.auditor if auditor is None else auditor)
        if warmup:
            self._warmup_for(gen)
        with self._swap_lock:
            self._publish_swap(gen)
            epoch = self.epoch
        # re-derive the gauges bound to the served pair (tuned drift):
        # families are idempotent and set_fn callbacks overwrite
        self._register_gauges()
        self.telemetry.inc("swaps")
        return epoch

    def _publish_swap(self, gen: _Generation) -> None:
        """Swap commit point; runs under ``_swap_lock``."""
        if gen.index.device.type == "cuda":
            cur = torch.cuda.current_stream(gen.index.device)
            for stream in self._streams():
                stream.wait_stream(cur)
        self._gen = gen
        self.epoch += 1

    def apply_mutation(self, mutable, mutate_fn=None, *,
                       warmup: bool = True) -> int:
        """Serve a :class:`repro_torch.core.mutate.MutableSeismicIndex`'s
        current snapshot: optionally run ``mutate_fn(mutable)`` first
        (inserts, deletes, compaction), then publish the snapshot through
        :meth:`swap_index`. Returns the new serving epoch."""
        if mutate_fn is not None:
            mutate_fn(mutable)
        return self.swap_index(mutable.index, warmup=warmup)

    # ------------------------------------------------------ submission

    def submit(self, coords, vals,
               deadline_s: float | None = None) -> ServeFuture:
        """Enqueue one sparse query; returns its completion future.

        Cache hits fulfil at once without touching the queue; a request
        whose fingerprint matches one already in flight attaches to that
        request's launch slot (``coalesce``). Rejected or shed requests
        get a failed future (``status`` set), never an exception on the
        submitting thread. With tracing on, every path ends the request's
        trace with a ``status`` attr."""
        tel = self.telemetry
        tel.inc("requests")
        c, v = self._normalize(coords, vals)
        now = time.monotonic()
        tr = self._tracer.start_trace("request", now) \
            if self._tracer is not None else None
        key = None
        cand_keys: list[bytes] = []
        if self.cache is not None or self.coalesce:
            # the serving epoch prefixes every key; several fingerprint
            # candidates cover scale-bucket jitter (serve.cache): probe
            # all, file under the primary
            ep = struct.pack("<Q", self.epoch)
            cand_keys = [ep + fp for fp in fingerprint_candidates(c, v)]
            key = cand_keys[0]
        if self.cache is not None:
            hit = self.cache.get_any(cand_keys)
            if hit is not None:
                fut = ServeFuture()
                ids, scores, ev = hit
                fut._set(ServeResult(ids=ids.copy(), scores=scores.copy(),
                                     docs_evaluated=ev, cached=True))
                if tr is not None:
                    self._tracer.end_trace(tr, time.monotonic(),
                                           status="done", cached=True)
                return fut
        req = Request(coords=c, vals=v, submit_t=now,
                      deadline=now + (self.deadline_s if deadline_s is None
                                      else deadline_s),
                      future=ServeFuture(), cache_key=key, trace=tr)
        # check-attach-or-enqueue-and-register is atomic, or two racing
        # duplicates both become primaries
        with self._coalesce_lock:
            if self.coalesce:
                primary = next(
                    (p for ck in cand_keys
                     if (p := self._inflight.get(ck)) is not None), None)
                if primary is not None:
                    primary.followers.append((req.future, now, tr))
                    if tr is not None:
                        tr.root.attrs["coalesced_into"] = \
                            primary.trace.trace_id \
                            if primary.trace is not None else "untraced"
                    tel.inc("coalesced")
                    return req.future
            status, shed = self.queue.put(req)
            if status == "ok" and self.coalesce:
                self._inflight[key] = req
            if shed is not None:
                self._unregister(shed)
        if status != "ok":
            tel.inc(status)                 # "rejected" or "closed"
            req.future._fail(status)
            if tr is not None:
                self._tracer.end_trace(tr, time.monotonic(),
                                       status=status)
        elif shed is not None:
            tel.inc("shed")
            self._fail_all(shed, "shed")
        tel.observe_queue_depth(self.queue.depth)
        return req.future

    def search(self, queries: PaddedSparse,
               deadline_s: float | None = None, timeout: float = 60.0):
        """Synchronous batch convenience: submit every row, wait for all
        (each at most ``timeout`` seconds). Returns an
        ``engine.RetrievalResult`` of CPU tensors; rejected or shed rows
        come back as -1 ids."""
        from repro_torch.serve.engine import RetrievalResult
        coords = host_array(queries.coords)
        vals = host_array(queries.vals)
        futs = [self.submit(coords[i], vals[i], deadline_s)
                for i in range(coords.shape[0])]
        ids = np.full((len(futs), self.params.k), -1, np.int32)
        scores = np.full((len(futs), self.params.k), -np.inf, np.float32)
        ev = np.zeros((len(futs),), np.int32)
        for i, f in enumerate(futs):
            if not f.wait(timeout):
                raise TimeoutError(f"request {i} still pending after "
                                   f"{timeout} s")
            if f.status == "done":
                r = f._result
                ids[i], scores[i], ev[i] = r.ids, r.scores, \
                    r.docs_evaluated
        return RetrievalResult(ids=torch.from_numpy(ids),
                               scores=torch.from_numpy(scores),
                               docs_evaluated=torch.from_numpy(ev))

    # ---------------------------------------------------------- worker

    def _worker(self) -> None:
        with on_stream(self._stream):
            while True:
                batch = self.queue.next_batch(self.max_batch)
                if batch is None:
                    return
                try:
                    self._launch(batch)
                except Exception as e:   # noqa: BLE001 — fail, keep serving
                    for r in batch:
                        self._fail_all(r, f"error: {type(e).__name__}: {e}")

    # --------------------------------------------- in-flight coalescing

    def _unregister(self, req: Request) -> None:
        """Drop ``req`` from the in-flight map (caller holds the lock or
        owns the request). No more followers can attach after this."""
        if req.cache_key is not None \
                and self._inflight.get(req.cache_key) is req:
            del self._inflight[req.cache_key]

    def _finish_inflight(self, req: Request) -> list:
        """Atomically retire ``req`` from the in-flight map and snapshot
        its followers; later duplicates become fresh primaries."""
        with self._coalesce_lock:
            self._unregister(req)
            return req.followers

    def _fail_all(self, req: Request, status: str) -> None:
        """Fail a request's future and every coalesced follower.
        Completion is first-writer-wins, so a batch-wide failure after a
        partial fulfil leaves already-``done`` futures (and their ended
        traces) untouched."""
        now = time.monotonic()
        for f, _, ftr in self._finish_inflight(req):
            if f._fail(status) and ftr is not None:
                self._tracer.end_trace(ftr, now, status=status)
        if req.future._fail(status) and req.trace is not None:
            self._tracer.end_trace(req.trace, now, status=status)

    def _pick_width(self, n: int) -> int:
        """Smallest ladder rung covering ``n`` requests."""
        for w in self.launch_widths:
            if w >= n:
                return w
        return self.max_batch

    def _next_seq(self) -> int:
        with self._stats_lock:
            seq = self._launch_seq
            self._launch_seq += 1
            return seq

    def _pack(self, batch: list[Request],
              width: int) -> tuple[np.ndarray, np.ndarray]:
        """Batch rows -> fixed-shape [width, query_nnz] launch arrays."""
        coords = np.zeros((width, self.query_nnz), np.int32)
        vals = np.zeros((width, self.query_nnz), np.float32)
        for i, r in enumerate(batch):
            coords[i], vals[i] = r.coords, r.vals
        return coords, vals

    @staticmethod
    def _upload(coords: np.ndarray, vals: np.ndarray,
                dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        """[width, nnz] coords and values on ``dev``: one (pinned, on
        CUDA) host-to-device copy of both, as int32 words."""
        host = torch.from_numpy(np.stack([coords, vals.view(np.int32)]))
        if dev.type == "cuda":
            host = host.pin_memory().to(dev, non_blocking=True)
        return host[0], host[1].view(torch.float32)

    @staticmethod
    def _download(ids: torch.Tensor, scores: torch.Tensor,
                  ev: torch.Tensor
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(ids, scores, docs_evaluated) on the host: one device-to-host
        copy of the three as int32 words, waited for on the current
        stream only."""
        k = ids.shape[1]
        words = torch.cat([ids.to(torch.int32),
                           scores.to(torch.float32).view(torch.int32),
                           ev.to(torch.int32)[:, None]], dim=1)
        if words.device.type == "cuda":
            host = torch.empty(words.shape, dtype=torch.int32,
                               pin_memory=True)
            host.copy_(words, non_blocking=True)
            sync_stream(words.device)
        else:
            host = words
        a = host.numpy().copy()
        return a[:, :k], a[:, k:2 * k].view(np.float32), a[:, 2 * k]

    def _execute(self, gen: _Generation, coords: np.ndarray,
                 vals: np.ndarray, staged: bool, delay_s: float = 0.0, *,
                 audit: bool = False):
        """One pipeline execution against ``gen``; returns host arrays
        plus wall-time bounds and (staged only) per-stage span triples and
        the probed captures.

        ``delay_s`` injects artificial per-launch latency inside the
        timed window (replica tests and the degradation run: the
        balancer's EWMA must see it). ``audit`` (staged only) also probes
        the funnel's membership captures for the shadow auditor."""
        tel = self.telemetry
        index, p = gen.index, gen.params
        triples: list[tuple[str, float, float]] = []
        probed: dict[str, object] = {}
        t0 = time.monotonic()
        if delay_s > 0.0:
            time.sleep(delay_s)
        qc, qv = self._upload(coords, vals, index.device)
        if staged:
            scores, ids, ev = run_pipeline_staged(
                index, qc, qv, p, fns=gen.fns,
                record=lambda s, dt: tel.record_latency(f"stage_{s}", dt),
                span_cb=lambda name, a, b: triples.append((name, a, b)),
                split_refine=True, probe=probed.__setitem__, audit=audit)
        else:
            scores, ids, ev = search_pipeline(
                index, PaddedSparse(qc, qv, index.dim), p)
        ids, scores, ev = self._download(ids, scores, ev)
        t1 = time.monotonic()
        return ids, scores, ev, t0, t1, triples, probed

    def _account(self, n: int, width: int, ev: np.ndarray, staged: bool,
                 triples, probed, device=None) -> None:
        """Post-execution telemetry shared by every dispatch path."""
        tel = self.telemetry
        tel.inc("batches")
        tel.observe_occupancy(n)
        with self._stats_lock:
            ws = self._width_stats.setdefault(width, [0, 0])
            ws[0] += 1
            ws[1] += n
            occ = ws[1] / (ws[0] * width)
            self._ev_sum += float(ev[:n].sum())
            self._ev_n += n
            ev_mean = self._ev_sum / self._ev_n
        self._width_occ.labels(str(width)).set(occ)
        self._ev_mean.set(ev_mean)
        if staged and device is not None:
            stage_seconds = {name: b - a for name, a, b in triples}
            device.observe(stage_seconds, width, cand=probed.get("cand"))

    def _launch(self, batch: list[Request], *, delay_s: float = 0.0,
                span_attrs: dict | None = None, on_timing=None) -> None:
        """One fixed-shape pipeline launch serving ``len(batch)`` rows.

        The keyword hooks are the replica server's seam: ``delay_s``
        injects artificial latency, ``span_attrs`` lands extra attrs on
        every launch span (``replica=rid``), and ``on_timing(
        launch_seconds, stage_seconds)`` feeds the balancer's EWMA."""
        tel = self.telemetry
        n = len(batch)
        width = self._pick_width(n)
        tel.inc(f"launch_width_{width}")
        tel.inc("dispatched", n)
        seq = self._next_seq()
        # one atomic snapshot of the serving generation: a concurrent
        # swap_index never tears an old index against new stage fns,
        # params or auditor inside one launch
        with self._swap_lock:
            gen = self._gen
        audit_rows = gen.auditor.plan(n) if gen.auditor is not None \
            else ()
        have_fns = gen.fns is not None
        capture = bool(audit_rows) and have_fns
        staged = self.stage_timing or capture or (
            have_fns
            and self.obs is not None and self.obs.sample_stages(seq))
        coords, vals = self._pack(batch, width)
        dispatch_t = time.monotonic()
        ids, scores, ev, t0, t1, triples, probed = self._execute(
            gen, coords, vals, staged, delay_s, audit=capture)
        tel.record_latency("launch", t1 - t0)
        if on_timing is not None:
            on_timing(t1 - t0,
                      {name: b - a for name, a, b in triples})
        self._account(n, width, ev, staged, triples, probed, gen.device)
        audit_span = None
        if audit_rows:
            a0 = time.monotonic()
            for i in audit_rows:
                gen.auditor.feed(coords[i], vals[i], ids[i],
                                 captures=probed if capture else None,
                                 row=i)
            audit_span = (a0, time.monotonic())
        self._fulfil(batch, ids, scores, ev, dispatch_t=dispatch_t,
                     t1=t1, width=width, seq=seq, staged=staged,
                     triples=triples, span_attrs=span_attrs,
                     audit_span=audit_span)

    def _fulfil(self, batch: list[Request], ids: np.ndarray,
                scores: np.ndarray, ev: np.ndarray, *, dispatch_t: float,
                t1: float, width: int, seq: int, staged: bool,
                triples=(), span_attrs: dict | None = None,
                audit_span: tuple[float, float] | None = None) -> None:
        """Fulfil every request (and coalesced follower) of a batch from
        the launch's result rows; closes caches, histograms, spans."""
        tel = self.telemetry
        n = len(batch)
        attrs = span_attrs or {}
        done_t = time.monotonic()
        leader = batch[0]
        served = 0
        for i, r in enumerate(batch):
            if self.cache is not None and r.cache_key is not None:
                # copies: caller mutation must not poison hits
                self.cache.put(r.cache_key,
                               (ids[i].copy(), scores[i].copy(),
                                int(ev[i])))
            if dispatch_t > r.deadline + self.deadline_grace_s:
                tel.inc("deadline_missed")
            tel.record_latency("queue_wait", dispatch_t - r.submit_t)
            tel.record_latency("request_e2e", done_t - r.submit_t)
            if r.trace is not None:
                self._tracer.add_span(r.trace, "queue_wait",
                                      r.submit_t, dispatch_t)
                launch_span = self._tracer.add_span(
                    r.trace, "launch", dispatch_t, t1, width=width,
                    occupancy=n, batch_seq=seq, staged=staged, **attrs)
                # stages ran once for the batch: their spans attach to
                # the batch leader's launch span only
                if r is leader and staged:
                    attach_stage_spans(self._tracer, r.trace,
                                       launch_span, triples)
                # likewise the audit feed (one per launch), root-level
                # on the leader, after the launch window
                if r is leader and audit_span is not None:
                    self._tracer.add_span(r.trace, "audit",
                                          audit_span[0], audit_span[1])
            # retire from the in-flight map before fulfilling: once the
            # followers are snapshot no new duplicate can attach
            followers = self._finish_inflight(r)
            for f, t_sub, ftr in followers:
                # a follower attached mid-execution waited 0 in queue
                tel.record_latency("queue_wait",
                                   max(0.0, dispatch_t - t_sub))
                tel.record_latency("request_e2e",
                                   max(0.0, done_t - t_sub))
                if f._set(ServeResult(
                        ids=ids[i].copy(), scores=scores[i].copy(),
                        docs_evaluated=int(ev[i]), coalesced=True,
                        latency_s=max(0.0, done_t - t_sub),
                        occupancy=n)) and ftr is not None:
                    # clamp a late follower's spans into [t_sub, ...] so
                    # the tree stays valid
                    f_disp = max(t_sub, dispatch_t)
                    f_end = max(f_disp, t1)
                    self._tracer.add_span(ftr, "queue_wait",
                                          t_sub, f_disp)
                    self._tracer.add_span(ftr, "launch", f_disp, f_end,
                                          width=width, occupancy=n,
                                          batch_seq=seq, staged=staged,
                                          **attrs)
                    self._tracer.end_trace(ftr, max(done_t, f_end),
                                           status="done")
            if r.future._set(ServeResult(
                    ids=ids[i], scores=scores[i],
                    docs_evaluated=int(ev[i]), cached=False,
                    latency_s=done_t - r.submit_t, occupancy=n)) \
                    and r.trace is not None:
                self._tracer.end_trace(r.trace, done_t, status="done",
                                       docs_evaluated=int(ev[i]))
            served += 1 + len(followers)
        tel.inc("served", served)

    # --------------------------------------------------------- helpers

    def _normalize(self, coords, vals) -> tuple[np.ndarray, np.ndarray]:
        """Pad/truncate one sparse query to the fixed ``query_nnz``."""
        c = host_array(coords).astype(np.int32).ravel()
        v = host_array(vals).astype(np.float32).ravel()
        if c.shape != v.shape:
            raise ValueError(f"coords {c.shape} vs vals {v.shape}")
        if c.size > self.query_nnz:          # keep heaviest coordinates
            keep = np.argpartition(v, -self.query_nnz)[-self.query_nnz:]
            c, v = c[keep], v[keep]
        out_c = np.zeros((self.query_nnz,), np.int32)
        out_v = np.zeros((self.query_nnz,), np.float32)
        out_c[:c.size], out_v[:v.size] = c, v
        out_c[out_v <= 0] = 0                # canonical padding slots
        out_v[out_v <= 0] = 0.0
        return out_c, out_v

    def telemetry_export(self) -> dict:
        """Telemetry snapshot plus cache stats, as one plain dict."""
        out = self.telemetry.export()
        out["cache"] = self.cache.stats() if self.cache is not None \
            else None
        return out
