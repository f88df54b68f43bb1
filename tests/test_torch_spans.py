"""The pipeline's stage spans on the profiler's clock: one
``seismic.search`` range a call with the six ``seismic.<stage>`` ranges
inside it, in order, opened only while a profiler records, and answers
bitwise those of a run without a profiler. Port only, no JAX."""
from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.build import build_index
from repro_torch.core.types import SeismicConfig
from repro_torch.data import SyntheticSparseConfig, make_collection
from repro_torch.graph import build_doc_graph
from repro_torch.retrieval import (STAGES, SearchParams, run_pipeline,
                                   run_pipeline_staged)
from repro_torch.retrieval import pipeline

PARAMS = SearchParams(k=5, cut=6, block_budget=6, graph_degree=4,
                      refine_rounds=2, use_kernel=True, fuse_level=2)


@pytest.fixture(scope="module")
def tiny():
    docs, queries, _ = make_collection(
        SyntheticSparseConfig(dim=256, n_docs=512, n_queries=16, doc_nnz=16,
                              query_nnz=8, n_topics=8, topic_coords=64,
                              seed=3), device="cpu")
    index = build_index(docs, SeismicConfig(lam=64, beta=4, block_cap=16,
                                            summary_nnz=16))
    return build_doc_graph(index, degree=4), queries


def _ranges(prof) -> list:
    """The ``seismic.*`` ranges of a CPU trace, as (start, end, name) in
    the order they open."""
    out = [(e.time_range.start, e.time_range.end, e.name)
           for e in prof.events() if e.name.startswith(pipeline.SPAN_PREFIX)]
    return sorted(out, key=lambda r: (r[0], -r[1]))


def _calls(ranges, ops) -> list:
    """For each ``seismic.search`` range: its stage children in order
    (each closed before the next opens), the ops under ``seismic.prep``,
    its other ``seismic.*`` ranges and the ops it holds outside every
    stage."""
    out = []
    for a, b, name in ranges:
        if name != "seismic.search":
            continue
        kids = [r for r in ranges if a <= r[0] and r[1] <= b
                and r[2] != "seismic.search"]
        stages = [r for r in kids if r[2].split(".", 1)[1] in STAGES]
        for (_, e0, _), (s1, _, _) in zip(stages, stages[1:]):
            assert e0 <= s1          # closed before the next opens
        prep = next(r for r in stages if r[2] == "seismic.prep")
        under = {o[2] for o in ops if prep[0] <= o[0] and o[1] <= prep[1]}
        loose = [o[2] for o in ops if a <= o[0] and o[1] <= b
                 and not o[2].startswith(pipeline.SPAN_PREFIX)
                 and not any(r[0] <= o[0] and o[1] <= r[1] for r in stages)]
        out.append(([r[2] for r in stages], under,
                    [r[2] for r in kids if r not in stages], loose))
    return out


@pytest.mark.parametrize("staged", [False, True])
def test_profiled_search_opens_a_search_span_with_six_stages(tiny, staged):
    index, queries = tiny
    c, v = queries.coords, queries.vals
    if staged:
        def call():
            return run_pipeline_staged(index, c, v, PARAMS,
                                       split_refine=True)
    else:
        def call():
            return run_pipeline(index, c, v, PARAMS)
    plain = call()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = [call(), call()]
    for got in traced:
        for a, b in zip(got, plain):
            assert torch.equal(a, b)
    ops = [(e.time_range.start, e.time_range.end, e.name)
           for e in prof.events()]
    calls = _calls(_ranges(prof), ops)
    assert len(calls) == 2
    for stages, under_prep, others, loose in calls:
        assert stages == [pipeline.SPAN_PREFIX + s for s in STAGES]
        assert "aten::to" in under_prep and loose == []
        assert others == (["seismic.refine_round_0", "seismic.refine_round_1"]
                          if staged else [])


def test_no_range_opens_without_a_profiler(tiny, monkeypatch):
    index, queries = tiny
    opened = []

    def counting(name):
        opened.append(name)
        return torch.autograd.profiler.record_function(name)
    monkeypatch.setattr(pipeline, "record_function", counting)
    seen = []
    run_pipeline(index, queries.coords, queries.vals, PARAMS)
    run_pipeline_staged(index, queries.coords, queries.vals, PARAMS,
                        record=lambda s, t: seen.append(s))
    assert opened == []
    assert seen == list(STAGES)
    with profile(activities=[ProfilerActivity.CPU]):
        run_pipeline(index, queries.coords, queries.vals, PARAMS)
    assert opened == [pipeline.SPAN_PREFIX + s for s in ("search",) + STAGES]
