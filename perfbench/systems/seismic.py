"""The system under test for Seismic configurations: ``repro_torch``'s
index, kNN graph and batched search pipeline.

A configuration names it with ``"system": "seismic"`` and holds
``collection`` (the generator's sizes), ``index`` (``SeismicConfig``
fields), ``graph`` (kNN degree and build batch, or null), ``search``
(``SearchParams`` fields but ``k``, which the traffic mix gives),
``kernels`` (the kernel sources to build or load) and ``control`` (the
program's own lower-precision path, merged into ``index`` for a control
run).

``inputs`` draws the collection and the query pool from the seed on the
device (``reference/collection.py``, the benchmark's own generator).
``Seismic`` builds the index and graph from them and answers batch
``b`` of the pool through ``search_pipeline`` at fuse level 2 (``call``),
or through ``run_pipeline_staged`` with each stage timed (``call_staged``).
An answer is ``(scores, ids, docs_evaluated)`` on the host.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from perfbench.reference import collection as gen


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_kernels(config: dict) -> None:
    """Build (or load) the configuration's CUDA kernels."""
    from repro_torch.kernels import runtime
    runtime.build_kernels(list(config["kernels"]))


def inputs(config: dict, traffic: dict, seed: int, dev) -> gen.Collection:
    """The collection and the pool of ``traffic["pool"]`` queries."""
    return gen.make_collection(config["collection"], traffic["pool"], seed,
                               dev)


def batches_of(coll: gen.Collection, batch: int) -> list:
    """The pool in batches of ``batch`` queries, on the host (pinned on a
    CUDA host), as the client holds them."""
    pin = torch.cuda.is_available()
    out = []
    for a in range(0, coll.q_coords.shape[0], batch):
        c = coll.q_coords[a:a + batch].cpu()
        v = coll.q_vals[a:a + batch].cpu()
        out.append((c.pin_memory() if pin else c,
                    v.pin_memory() if pin else v))
    return out


@dataclasses.dataclass
class Context:
    """What a metric's ``collect`` sees in a traced run: the program's
    index, what the staged pipeline showed of each distinct batch
    (``probes``: its ``cand``, ``lists`` and ``router_r``), how often the
    profiled stretch ran each (``repeats``), the collection and the
    configuration."""

    index: object
    params: object
    probes: list
    repeats: int
    coll: gen.Collection
    config: dict


class Seismic:
    """The index and graph built from ``coll`` and the search parameters
    of the configuration at the mix's ``k``. ``values`` holds what set-up
    measured: ``build_s``, ``graph_s`` and ``build_phases``."""

    def __init__(self, config: dict, traffic: dict, coll: gen.Collection,
                 dev: torch.device, control: bool = False):
        from repro_torch.core.build import build_index
        from repro_torch.core.types import SeismicConfig
        from repro_torch.graph import build_doc_graph
        from repro_torch.retrieval.params import SearchParams
        from repro_torch.retrieval.pipeline import search_pipeline
        from repro_torch.sparse.ops import PaddedSparse

        self.config, self.coll, self.dev = config, coll, dev
        fields = dict(config["index"])
        if control:
            fields.update(config["control"]["index"])
        phases: dict = {}
        t0 = time.perf_counter()
        self.index = build_index(
            PaddedSparse(coll.doc_coords, coll.doc_vals, coll.dim),
            SeismicConfig(**fields), timings=phases)
        _sync(dev)
        self.values = {"build_s": time.perf_counter() - t0, "graph_s": None,
                       "build_phases": phases}
        if config.get("graph"):
            t0 = time.perf_counter()
            self.index = build_doc_graph(self.index,
                                         degree=config["graph"]["degree"],
                                         batch=config["graph"]["batch"])
            _sync(dev)
            self.values["graph_s"] = time.perf_counter() - t0
        self.batches = batches_of(coll, traffic["batch"])
        self.entry = search_pipeline       # the timed entry
        self.set_params(SearchParams(**config["search"], k=traffic["k"],
                                     use_kernel=True, fuse_level=2))
        self._padded = PaddedSparse

    def set_params(self, p) -> None:
        from repro_torch.retrieval.pipeline import stage_fns
        self.params = p
        self.fns = stage_fns(self.index, p)
        self.values["params"] = p

    def size(self, b: int) -> int:
        """Queries in batch ``b``."""
        return self.batches[b][0].shape[0]

    def call(self, b: int) -> tuple:
        c, v = self.batches[b]
        out = self.entry(self.index, self._padded(c, v, self.coll.dim),
                         self.params)
        return tuple(t.cpu() for t in out)

    def call_staged(self, b: int, record) -> tuple:
        from repro_torch.retrieval.pipeline import run_pipeline_staged
        c, v = self.batches[b]
        out = run_pipeline_staged(self.index, c, v, self.params,
                                  fns=self.fns, record=record)
        return tuple(t.cpu() for t in out)

    def stretch(self, repeats: int) -> list:
        """Each distinct batch ``repeats`` times through the timed entry,
        for the profiler: [(b, answer)], the answers left on the device
        until the stretch ends."""
        out = []
        for _ in range(repeats):
            for b, (c, v) in enumerate(self.batches):
                out.append((b, self.entry(
                    self.index, self._padded(c, v, self.coll.dim),
                    self.params)))
        return out

    def context(self, repeats: int) -> Context:
        from repro_torch.retrieval.pipeline import run_pipeline_staged
        probes = []
        for c, v in self.batches:
            seen: dict = {}
            run_pipeline_staged(self.index, c, v, self.params, fns=self.fns,
                                probe=seen.__setitem__, audit=True)
            probes.append(seen)
        return Context(index=self.index, params=self.params, probes=probes,
                       repeats=repeats, coll=self.coll, config=self.config)

    def free(self) -> None:
        self.index = self.fns = self.entry = None


def setup(config: dict, traffic: dict, coll: gen.Collection, dev,
          control: bool = False) -> Seismic:
    return Seismic(config, traffic, coll, dev, control)
