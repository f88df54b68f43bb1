"""Synchronous serving facades (port of ``repro.serve.engine``; the
serving system, micro-batching and replicas, lives in
``serve.batcher`` and ``serve.replica``).

``LMDecoder``      KV-cache decode loop around ``lm.decode_step`` (greedy or
                   sampling) over a batch of requests.
``SeismicServer``  fixed-batch retrieval; params and the index's tuned
                   policies are checked before the first launch; optional
                   telemetry, observability (sampled staged launches,
                   traces, device accounting) and shadow auditing;
                   ``swap_index`` / ``apply_mutation`` publish a new index
                   (``repro_torch.core.mutate``) and bump the serving
                   ``epoch``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.base import TransformerConfig
from repro_torch.core.types import SeismicIndex
from repro_torch.kernels.runtime import sync_stream
from repro_torch.models.transformer import lm
from repro_torch.obs.device import DeviceAccounting
from repro_torch.obs.registry import weak_fn
from repro_torch.retrieval import SearchParams, search_pipeline
from repro_torch.retrieval.pipeline import (run_pipeline_staged, stage_fns,
                                            validate_params)
from repro_torch.serve.telemetry import ServerTelemetry
from repro_torch.sparse.ops import PaddedSparse
from repro_torch.tune.policy import validate_tuned_index


class LMDecoder:
    """Greedy or sampled generation for a batch of requests over one KV
    cache on the parameters' device."""

    def __init__(self, params: lm.LM, cfg: TransformerConfig, batch: int,
                 max_seq: int):
        self.params = params
        self.cfg = cfg
        self.batch = batch
        self.max_seq = max_seq
        self.device = params.embed.device
        # any of lm.init_cache's layouts (GQA, Gemma's dual cache, MLA)
        self.cache = lm.init_cache(cfg, batch, max_seq, device=self.device)

    def generate(self, prompts: torch.Tensor | np.ndarray, n_steps: int, *,
                 greedy: bool = True, seed: int = 0) -> torch.Tensor:
        """prompts [B, P] -> tokens int32 [B, P + n_steps] on the device.

        Prefills by stepping, as the JAX package does. Greedy takes the
        first maximum (``torch.argmax``, as ``jnp.argmax``); sampling
        follows the JAX package's key chain: ``PRNGKey(seed)``, a
        ``split`` each step, ``categorical`` with the second key over the
        logits in their dtype (``repro_torch.prng``), so equal logits give
        JAX's tokens."""
        prompts = torch.as_tensor(prompts, device=self.device).to(torch.int32)
        b, plen = prompts.shape
        if b != self.batch:
            raise ValueError(f"generate: {b} prompts for a decoder of batch "
                             f"{self.batch}")
        if plen == 0 or plen + n_steps > self.max_seq:
            raise ValueError(f"generate: prompt length {plen} plus {n_steps} "
                             f"steps must lie in 1..max_seq {self.max_seq}")
        key = prng.key(seed, self.device)
        toks = [prompts[:, i] for i in range(plen)]
        for i in range(plen):
            logits, self.cache = lm.decode_step(
                self.params, self.cache, toks[i][:, None], i, self.cfg)
        for j in range(n_steps):
            if greedy:
                nxt = torch.argmax(logits, dim=-1)
            else:
                key, sub = prng.split(key)
                nxt = prng.categorical(sub, logits)
            toks.append(nxt.to(torch.int32))
            logits, self.cache = lm.decode_step(
                self.params, self.cache, toks[-1][:, None], plen + j,
                self.cfg)
        return torch.stack(toks, dim=1)


@dataclasses.dataclass
class RetrievalResult:
    ids: torch.Tensor              # int32 [n, k], -1 padding
    scores: torch.Tensor           # f32 [n, k]
    docs_evaluated: torch.Tensor   # int32 [n]


class SeismicServer:
    """Fixed-batch retrieval front end over the shared pipeline: pads each
    request batch to a multiple of ``max_batch`` and answers it
    ``max_batch`` queries at a time, so every launch has one shape.

    Params and the index's tuned policies are checked before the first
    launch. With ``telemetry`` each launch's latency (to a synchronize of
    the calling thread's stream, taken only then), the batch count and
    its occupancy are recorded, and the ``seismic_index_epoch`` gauge
    reads the serving epoch. With ``obs`` (an
    ``repro_torch.obs.Observability``; telemetry then writes into its
    registry) every ``stage_sample_every``-th launch runs the staged
    pipeline, traced as a ``launch`` span with per-stage children and
    fed to device accounting; with an ``auditor`` (default
    ``obs.auditor``) the planned rows of each launch run staged with the
    funnel's captures and are fed to it. Staged and fused launches give
    equal results."""

    def __init__(self, index: SeismicIndex, params: SearchParams,
                 max_batch: int = 256, *,
                 telemetry: ServerTelemetry | None = None, obs=None,
                 auditor=None):
        validate_params(index, params)      # fail before the first launch
        validate_tuned_index(index)         # a stale TunedPolicy, too
        self.index = index
        self.params = params
        self.max_batch = max_batch
        if telemetry is None and obs is not None:
            telemetry = ServerTelemetry(registry=obs.registry)
        self.telemetry = telemetry
        self.obs = obs
        self.auditor = auditor if auditor is not None \
            else getattr(obs, "auditor", None)
        self._staged = self.auditor is not None or (
            obs is not None and obs.stage_sample_every > 0)
        self._fns = self._device = None
        self._bind(index, params)
        self._launch_seq = 0
        # serving generation, bumped on every swap_index (callers key their
        # own memoization on it)
        self.epoch = 0
        if telemetry is not None:
            telemetry.registry.gauge(
                "seismic_index_epoch",
                "Generation of the index being served (bumped on "
                "every swap_index / mutation publish)").labels() \
                .set_fn(weak_fn(self, lambda s: s.epoch))

    def _bind(self, index: SeismicIndex, params: SearchParams) -> None:
        """The staged stage functions and device accounting of one
        (index, params) pair, when staged launches are on."""
        if self._staged:
            self._fns = stage_fns(index, params)
        if self.obs is not None and self.obs.stage_sample_every > 0:
            self._device = DeviceAccounting(index, params,
                                            self.telemetry.registry)

    def swap_index(self, index: SeismicIndex,
                   params: SearchParams | None = None) -> int:
        """Publish a new index (and optionally new params) after checking
        them as the constructor does; returns the new serving epoch. The
        facade is synchronous: callers serialize ``search`` and
        ``swap_index`` themselves."""
        params = self.params if params is None else params
        validate_params(index, params)
        validate_tuned_index(index)
        self._bind(index, params)
        self.index = index
        self.params = params
        self.epoch += 1
        return self.epoch

    def apply_mutation(self, mutable, mutate_fn=None) -> int:
        """Optionally run ``mutate_fn(mutable)`` (inserts, deletes or a
        compaction on a ``repro_torch.core.mutate.MutableSeismicIndex``),
        then publish its current snapshot through :meth:`swap_index`."""
        if mutate_fn is not None:
            mutate_fn(mutable)
        return self.swap_index(mutable.index)

    def _search_staged(self, chunk: PaddedSparse, n_real: int,
                       audit_rows: tuple[int, ...] = ()):
        """One sampled (or audited) chunk through the staged pipeline: a
        ``launch`` trace with per-stage (and per-refine-round) child
        spans, device accounting, and the planned rows fed to the shadow
        auditor. Results equal the fused path's."""
        from repro_torch.serve.batcher import attach_stage_spans
        tracer = self.obs.tracer if self.obs is not None else None
        triples: list[tuple[str, float, float]] = []
        probed: dict[str, object] = {}
        tel = self.telemetry
        t0 = time.monotonic()
        out = run_pipeline_staged(
            self.index, chunk.coords, chunk.vals, self.params,
            fns=self._fns,
            record=(lambda s, dt: tel.record_latency(f"stage_{s}", dt))
            if tel is not None else None,
            span_cb=lambda name, a, b: triples.append((name, a, b)),
            split_refine=True, probe=probed.__setitem__,
            audit=bool(audit_rows))
        t1 = time.monotonic()
        a_span = None
        if audit_rows:
            a0 = time.monotonic()
            for i in audit_rows:
                self.auditor.feed(chunk.coords[i], chunk.vals[i], out[1][i],
                                  captures=probed, row=i)
            a_span = (a0, time.monotonic())
        if tracer is not None:
            tr = tracer.start_trace("launch", t0,
                                    width=chunk.coords.shape[0],
                                    occupancy=n_real, sync=True)
            attach_stage_spans(tracer, tr, tr.root, triples)
            if a_span is not None:
                tracer.add_span(tr, "audit", a_span[0], a_span[1])
            tracer.end_trace(tr, a_span[1] if a_span is not None else t1,
                             status="done")
        if self._device is not None:
            stage_seconds = {name: b - a for name, a, b in triples}
            self._device.observe(stage_seconds, chunk.coords.shape[0],
                                 cand=probed.get("cand"),
                                 query_nnz=chunk.coords.shape[1])
        return out, t1 - t0

    def search(self, queries: PaddedSparse) -> RetrievalResult:
        k, dev = self.params.k, self.index.device
        n = queries.coords.shape[0]
        if n == 0:
            return RetrievalResult(
                ids=torch.zeros((0, k), dtype=torch.int32, device=dev),
                scores=torch.zeros((0, k), dtype=torch.float32, device=dev),
                docs_evaluated=torch.zeros((0,), dtype=torch.int32,
                                           device=dev))
        pad = (-n) % self.max_batch
        coords = torch.nn.functional.pad(queries.coords, (0, 0, 0, pad))
        vals = torch.nn.functional.pad(queries.vals, (0, 0, 0, pad))
        tel = self.telemetry
        outs = []
        for s in range(0, n + pad, self.max_batch):
            chunk = PaddedSparse(coords[s:s + self.max_batch],
                                 vals[s:s + self.max_batch], queries.dim)
            seq = self._launch_seq
            self._launch_seq += 1
            n_chunk = min(self.max_batch, n - s)
            audit_rows = self.auditor.plan(n_chunk) \
                if self.auditor is not None else ()
            sampled = self.obs is not None and self.obs.sample_stages(seq)
            if self._fns is not None and (sampled or audit_rows):
                out, dt = self._search_staged(chunk, n_chunk, audit_rows)
            elif tel is None:
                outs.append(search_pipeline(self.index, chunk, self.params))
                continue
            else:
                t0 = time.perf_counter()
                out = search_pipeline(self.index, chunk, self.params)
                sync_stream(dev)
                dt = time.perf_counter() - t0
            outs.append(out)
            if tel is not None:
                tel.record_latency("launch", dt)
                tel.inc("batches")
                tel.observe_occupancy(n_chunk)
        scores, ids, ev = (torch.cat(parts)[:n] for parts in zip(*outs))
        if tel is not None:
            tel.inc("requests", n)
            tel.inc("served", n)
        return RetrievalResult(ids=ids, scores=scores, docs_evaluated=ev)
