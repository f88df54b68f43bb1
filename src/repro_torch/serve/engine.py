"""Synchronous serving facades (port of ``repro.serve.engine``;
telemetry, observability, auditing and index mutation are not ported
yet).

``LMDecoder``      KV-cache decode loop around ``lm.decode_step`` (greedy
                   or sampling) over a batch of requests.
``SeismicServer``  fixed-batch retrieval; params are checked against the
                   index (route, refine) before the first launch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.base import TransformerConfig
from repro_torch.core.types import SeismicIndex
from repro_torch.models.transformer import lm
from repro_torch.retrieval import SearchParams, search_pipeline
from repro_torch.retrieval.pipeline import validate_params
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
    ``max_batch`` queries at a time, so every launch has one shape."""

    def __init__(self, index: SeismicIndex, params: SearchParams,
                 max_batch: int = 256):
        validate_params(index, params)      # fail before the first launch
        self.index = index
        self.params = params
        self.max_batch = max_batch

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
        outs = [search_pipeline(self.index,
                                PaddedSparse(coords[s:s + self.max_batch],
                                             vals[s:s + self.max_batch],
                                             queries.dim), self.params)
                for s in range(0, n + pad, self.max_batch)]
        scores, ids, ev = (torch.cat(parts)[:n] for parts in zip(*outs))
        return RetrievalResult(ids=ids, scores=scores, docs_evaluated=ev)
