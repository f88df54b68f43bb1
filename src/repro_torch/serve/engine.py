"""Synchronous serving facades (port of ``repro.serve.engine``; the
staged observability and shadow auditing paths are not ported yet).

``LMDecoder``      KV-cache decode loop around ``lm.decode_step`` (greedy or
                   sampling) over a batch of requests.
``SeismicServer``  fixed-batch retrieval; params are checked against the
                   index (route, refine) before the first launch; optional
                   telemetry; ``swap_index`` / ``apply_mutation`` publish a
                   new index (``repro_torch.core.mutate``) and bump the
                   serving ``epoch``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.base import TransformerConfig
from repro_torch.core.types import SeismicIndex
from repro_torch.models.transformer import lm
from repro_torch.retrieval import SearchParams, search_pipeline
from repro_torch.retrieval.pipeline import validate_params
from repro_torch.serve.telemetry import ServerTelemetry
from repro_torch.sparse.ops import PaddedSparse


class LMDecoder:
    """Greedy or sampled generation for a batch of requests over one KV
    cache on the parameters' device."""

    def __init__(self, params: lm.LM, cfg: TransformerConfig, batch: int,
                 max_seq: int):
        self.params = params
        self.cfg = cfg
        self.max_seq = max_seq
        self.device = params.embed.device
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
        if b != self.cache["k"].shape[1]:
            raise ValueError(f"generate: {b} prompts for a decoder of batch "
                             f"{self.cache['k'].shape[1]}")
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

    With ``telemetry`` each launch's latency (to a device synchronize,
    taken only then), the batch count and its occupancy are recorded, and
    the ``seismic_index_epoch`` gauge reads the serving epoch."""

    def __init__(self, index: SeismicIndex, params: SearchParams,
                 max_batch: int = 256, *,
                 telemetry: ServerTelemetry | None = None):
        validate_params(index, params)      # fail before the first launch
        self.index = index
        self.params = params
        self.max_batch = max_batch
        self.telemetry = telemetry
        # serving generation, bumped on every swap_index (callers key their
        # own memoization on it)
        self.epoch = 0
        if telemetry is not None:
            telemetry.registry.gauge(
                "seismic_index_epoch",
                "Generation of the index being served (bumped on "
                "every swap_index / mutation publish)").labels() \
                .set_fn(lambda: self.epoch)

    def swap_index(self, index: SeismicIndex,
                   params: SearchParams | None = None) -> int:
        """Publish a new index (and optionally new params) after checking
        them as the constructor does; returns the new serving epoch. The
        facade is synchronous: callers serialize ``search`` and
        ``swap_index`` themselves."""
        params = self.params if params is None else params
        validate_params(index, params)
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
            if tel is None:
                outs.append(search_pipeline(self.index, chunk, self.params))
                continue
            t0 = time.perf_counter()
            outs.append(search_pipeline(self.index, chunk, self.params))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            tel.record_latency("launch", time.perf_counter() - t0)
            tel.inc("batches")
            tel.observe_occupancy(min(self.max_batch, n - s))
        scores, ids, ev = (torch.cat(parts)[:n] for parts in zip(*outs))
        if tel is not None:
            tel.inc("requests", n)
            tel.inc("served", n)
        return RetrievalResult(ids=ids, scores=scores, docs_evaluated=ev)
