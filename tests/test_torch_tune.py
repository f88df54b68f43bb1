"""Port parity: tuned operating points (``repro_torch.tune.policy``) and
their persistence (``repro_torch.ckpt``) against the JAX package's
``repro.tune.policy`` and ``repro.ckpt``, on ``small_index``.

Everything here is exact: digests byte-equal, knob sets and manifest
lists equal, and a stale policy raises ``ValueError`` with the JAX
package's message (the refine check names its own package's graph
builder), at construction of every server.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

from repro.ckpt.checkpoint import load_index as jax_load_index
from repro.ckpt.checkpoint import save_index as jax_save_index
from repro.retrieval import SearchParams as JParams
from repro.tune import policy as jpol
from repro_torch.ckpt import load_index, save_index
from repro_torch.retrieval import SearchParams
from repro_torch.serve import (AsyncSeismicServer, ReplicaSeismicServer,
                               SeismicServer)
from repro_torch.tune import policy as pol
from test_torch_pipeline import carry

FIELDS = dict(target=0.9, k=10, cut=8, block_budget=8, policy="budget",
              measured_recall=0.93, measured_cost=211.5, router_cost=3,
              sample_fingerprint="00ff", modeled=True)


def both(**kw):
    """The same policy in both packages."""
    return jpol.TunedPolicy(**kw), pol.TunedPolicy(**kw)


def test_policy_fields_and_defaults_match_reference():
    assert pol.KNOB_FIELDS == jpol.KNOB_FIELDS
    assert pol.RECALL_EPS == jpol.RECALL_EPS
    jf = [(f.name, f.default) for f in dataclasses.fields(jpol.TunedPolicy)]
    pf = [(f.name, f.default) for f in dataclasses.fields(pol.TunedPolicy)]
    assert pf == jf
    j, p = both(**FIELDS)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert p.satisfies(0.93) and not p.satisfies(0.93 + 1e-6)
    assert p.satisfies(0.93) == j.satisfies(0.93)


def test_to_params_and_knobs_match_reference():
    j, p = both(**FIELDS)
    jp, pp = j.to_params(), p.to_params(use_kernel=False, fuse_level=0)
    assert pol.knobs_from_params(pp) == jpol.knobs_from_params(jp)
    assert pp.use_kernel is False and pp.fuse_level == 0
    assert p.to_params().fuse_level == SearchParams().fuse_level


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_digests_are_byte_equal(seed):
    rng = np.random.default_rng(seed)
    coords = rng.integers(0, 30522, (12, 16)).astype(np.int32)
    vals = rng.uniform(0, 3, (12, 16)).astype(np.float32)
    vals[:, -3:] = 0.0                                  # padding entries
    assert pol.sample_fingerprint(coords, vals) == \
        jpol.sample_fingerprint(coords, vals)
    perm = rng.permutation(12)
    assert pol.sample_fingerprint(coords[perm], vals[perm]) == \
        pol.sample_fingerprint(coords, vals)            # order-invariant
    assert pol.row_digests(coords, vals) == jpol.row_digests(coords, vals)
    row = rng.permutation(16)
    assert pol.row_digest(coords[0, row], vals[0, row]) == \
        jpol.row_digest(coords[0], vals[0])


def test_attach_tuned_sorts_as_reference(small_index):
    jindex = small_index[0]
    index = carry(jindex)
    specs = [dict(FIELDS, target=0.95, measured_cost=300.0),
             dict(FIELDS, target=0.9, measured_cost=250.0),
             dict(FIELDS, target=0.9, measured_cost=120.0)]
    jt = jpol.attach_tuned(jindex, [jpol.TunedPolicy(**s) for s in specs])
    pt = pol.attach_tuned(index, [pol.TunedPolicy(**s) for s in specs])
    assert [dataclasses.asdict(t) for t in pt.tuned] == \
        [dataclasses.asdict(t) for t in jt.tuned]
    assert pol.matching_policy(pt, pt.tuned[0].to_params()) is pt.tuned[0]
    assert pol.matching_policy(pt, SearchParams(k=3)) is None


STALE = {
    "target": dict(target=0.0),
    "target_above_one": dict(target=1.5),
    "degenerate": dict(target=0.9, block_budget=0),
    "selector": dict(target=0.9, policy="no_such_selector"),
    "no_tier": dict(target=0.9, superblock_fanout=4),
    "no_graph": dict(target=0.9, graph_degree=4, refine_rounds=1),
}


def _errors(fn, *args):
    with pytest.raises(ValueError) as exc:
        fn(*args)
    return str(exc.value)


@pytest.mark.parametrize("case", sorted(STALE))
def test_validate_tuned_index_raises_as_reference(small_index, case,
                                                  monkeypatch):
    # the "selector" message lists the registered selectors, and
    # tests/test_retrieval.py registers a test-only one in the JAX
    # registry for the rest of its worker's session: read the JAX message
    # without the selectors that tests registered
    from repro.retrieval import selector as jsel
    monkeypatch.setattr(jsel, "_SELECTORS", {
        k: v for k, v in jsel._SELECTORS.items() if not k.startswith("_test")})
    jindex = small_index[0]
    jt, pt = both(**STALE[case])
    jbad = dataclasses.replace(jindex, tuned=(jt,))
    bad = dataclasses.replace(carry(jindex), tuned=(pt,))
    want = _errors(jpol.validate_tuned_index, jbad)
    got = _errors(pol.validate_tuned_index, bad)
    assert got == want.replace("repro.graph", "repro_torch.graph")


@pytest.mark.parametrize("server", ["sync", "async", "replica"])
def test_servers_refuse_a_stale_policy(small_index, server):
    """The servers check the index's tuned policies before the first
    launch, as the JAX package's do."""
    index = carry(small_index[0])
    bad = dataclasses.replace(
        index, tuned=(pol.TunedPolicy(**STALE["no_graph"]),))
    p = SearchParams(k=5, cut=8, block_budget=8)
    make = {"sync": lambda i: SeismicServer(i, p, max_batch=4),
            "async": lambda i: AsyncSeismicServer(i, p, max_batch=4),
            "replica": lambda i: ReplicaSeismicServer(i, p, n_replicas=2,
                                                      max_batch=4)}[server]
    with pytest.raises(ValueError, match="kNN graph"):
        make(bad)
    srv = make(index)
    with pytest.raises(ValueError, match="kNN graph"):
        srv.swap_index(bad)
    assert srv.epoch == 0 and srv.index is index


def test_tuned_round_trip_through_both_packages(tmp_path, small_index):
    """A JAX save loads here as ``TunedPolicy`` objects; the port's save
    writes the manifest ``tuned`` list the JAX package writes, and the JAX
    loader reads it back."""
    jindex = jpol.attach_tuned(small_index[0], [
        jpol.TunedPolicy(**FIELDS),
        jpol.TunedPolicy(**dict(FIELDS, target=0.95, cut=10))])
    jax_save_index(str(tmp_path / "jax"), jindex, step=1)
    index = load_index(str(tmp_path / "jax"), device="cpu")
    assert all(isinstance(t, pol.TunedPolicy) for t in index.tuned)
    assert [dataclasses.asdict(t) for t in index.tuned] == \
        [dataclasses.asdict(t) for t in jindex.tuned]
    assert carry(jindex).tuned == index.tuned
    save_index(str(tmp_path / "port"), index, step=1)

    def manifest(root):
        with open(os.path.join(root, "index_00000001",
                               "seismic_index.json")) as f:
            return json.load(f)
    assert manifest(tmp_path / "port")["tuned"] == \
        manifest(tmp_path / "jax")["tuned"]
    back = jax_load_index(str(tmp_path / "port"), step=1)
    assert back.tuned == jindex.tuned
    again = load_index(str(tmp_path / "port"), device="cpu")
    assert again.tuned == index.tuned


def test_untuned_manifest_has_no_tuned_key(tmp_path, small_index):
    save_index(str(tmp_path), carry(small_index[0]), step=0)
    with open(tmp_path / "index_00000000" / "seismic_index.json") as f:
        assert "tuned" not in json.load(f)
    assert load_index(str(tmp_path), device="cpu").tuned == ()


def test_to_params_matches_reference_search_params():
    j, p = both(**dict(FIELDS, superblock_fanout=4, superblock_budget=6,
                       graph_degree=4, refine_rounds=2))
    jp = j.to_params()
    assert isinstance(jp, JParams)
    pp = p.to_params()
    assert {f: getattr(pp, f) for f in pol.KNOB_FIELDS} == \
        {f: getattr(jp, f) for f in jpol.KNOB_FIELDS}


# ------------------------------------------------ sweep, frontier, tuner
#
# The JAX package's tuner fixture (tests/test_tune_properties.py: a
# 1,024-doc collection, an index with a degree-6 kNN graph, 16 held-out
# queries, its 12-point budget x refine grid and one JAX sweep) carried
# to the port. Exact: every MeasuredPoint (recall and docs_evaluated as
# floats, router_cost), the frontier, the TunedPolicy (fingerprint
# included) and from_tuned.

from repro.configs import seismic_msmarco as jcfg                # noqa: E402
from repro.core import SeismicConfig as JConfig                  # noqa: E402
from repro.core import build_index as jax_build_index            # noqa: E402
from repro.tune import frontier as jfront                        # noqa: E402
from repro_torch.configs import seismic_msmarco as pcfg          # noqa: E402
from repro_torch.sparse.ops import PaddedSparse                  # noqa: E402
import jax.numpy as jnp                                          # noqa: E402
import torch                                                     # noqa: E402
from repro_torch.tune import frontier as pfront                  # noqa: E402
from test_tune_properties import _fixture as jax_tuner_fixture   # noqa: E402
import importlib                                                 # noqa: E402

# the packages' ``sweep`` functions shadow their ``sweep`` modules
jsweep = importlib.import_module("repro.tune.sweep")
psweep = importlib.import_module("repro_torch.tune.sweep")


def knobs(p) -> tuple:
    return tuple(getattr(p, f) for f in pol.KNOB_FIELDS)


def same_point(pt, jt) -> bool:
    return (knobs(pt.params) == knobs(jt.params) and pt.recall == jt.recall
            and pt.docs_evaluated == jt.docs_evaluated
            and pt.router_cost == jt.router_cost)


def port_params(jp, **ex):
    return SearchParams(**{f: getattr(jp, f) for f in pol.KNOB_FIELDS},
                        **ex)


_tuner: dict = {}


def tuner_fixture():
    """(carried index, port queries, exact ids, JAX points, port points
    at fuse 1, port points at fuse 0 without the kernels)."""
    if not _tuner:
        jidx, jq, eids, jpoints = jax_tuner_fixture()
        index = carry(jidx)
        q = PaddedSparse(torch.from_numpy(np.array(jq.coords)),
                         torch.from_numpy(np.array(jq.vals)), jq.dim)
        grid = [port_params(pt.params) for pt in jpoints]
        pts = psweep.sweep(index, q, eids, grid=grid)
        plain = psweep.sweep(index, q, eids, grid=[
            port_params(pt.params, use_kernel=False, fuse_level=0)
            for pt in jpoints])
        _tuner.update(fix=(index, q, eids, jpoints, pts, plain))
    return _tuner["fix"]


def test_sweep_points_equal_reference():
    """Every MeasuredPoint equals the JAX package's, at the port's default
    execution knobs and on its unfused plain path alike (the measurement
    never depends on use_kernel / fuse_level)."""
    _, _, _, jpoints, pts, plain = tuner_fixture()
    assert len(pts) == len(jpoints) == len(plain)
    for pt, pp, jt in zip(pts, plain, jpoints):
        assert same_point(pt, jt), (pt, jt)
        assert same_point(pp, jt), (pp, jt)
        assert pt.stage_seconds == () and pt.advisory_seconds is None


def test_frontier_and_selection_equal_reference():
    _, _, _, jpoints, pts, _ = tuner_fixture()
    pf, jf = pfront.pareto_frontier(pts), jfront.pareto_frontier(jpoints)
    assert len(pf) == len(jf) >= 2
    assert all(same_point(a, b) for a, b in zip(pf, jf))
    for target in (0.5, 0.8, 0.9, 0.95, 1.0):
        try:
            want = jfront.select_operating_point(jpoints, target)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:40]):
                pfront.select_operating_point(pts, target)
            continue
        assert same_point(pfront.select_operating_point(pts, target), want)


@pytest.mark.parametrize("target", [0.8, 0.9, 0.95])
def test_tune_gives_the_reference_policy(target):
    """The identical TunedPolicy (fingerprint included), from a shared
    sweep and from the tuner's own; from_tuned resolves equal knobs."""
    index, q, eids, jpoints, pts, _ = tuner_fixture()
    jidx, jq, _, _ = jax_tuner_fixture()
    want = jfront.tune(jidx, jq, eids, target, points=jpoints)
    got = pfront.tune(index, q, eids, target, points=pts)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    j_attached = jpol.attach_tuned(jidx, [want])
    p_attached = pol.attach_tuned(index, [got])
    jp = JParams.from_tuned(j_attached, target)
    pp = SearchParams.from_tuned(p_attached, target, fuse_level=2)
    assert pol.knobs_from_params(pp) == jpol.knobs_from_params(jp)
    assert pp.fuse_level == 2 and pp.use_kernel


def test_tune_and_attach_equals_reference():
    index, q, eids, jpoints, _, _ = tuner_fixture()
    jidx, jq, _, _ = jax_tuner_fixture()
    grid_j = [pt.params for pt in jpoints]
    grid_p = [port_params(p) for p in grid_j]
    want = jfront.tune_and_attach(jidx, jq, eids, (0.8, 0.9), grid=grid_j)
    got = pfront.tune_and_attach(index, q, eids, (0.8, 0.9), grid=grid_p)
    assert [dataclasses.asdict(t) for t in got.tuned] == \
        [dataclasses.asdict(t) for t in want.tuned]
    pol.validate_tuned_index(got)
    with pytest.raises(ValueError, match="infeasible"):
        pfront.tune_and_attach(index, q, eids, (1.5,), grid=grid_p)


def test_refine_cotuning_property_on_the_port():
    """The reference suite's co-tuning property, read on the port's own
    sweep of the JAX-built fixture: the port's points equal JAX's (above),
    so the property has one outcome in both packages. Recorded here, not
    asserted either way: ROADMAP Queue 3 holds the diagnosis."""
    _, _, _, jpoints, pts, _ = tuner_fixture()

    def holds(points):
        pure = [pt for pt in points if pt.params.refine_rounds == 0]
        refined = [pt for pt in points if pt.params.refine_rounds > 0]
        return any(r.recall >= p.recall and
                   r.docs_evaluated < p.docs_evaluated
                   for p in pure for r in refined)
    assert holds(pts) == holds(jpoints)


def test_default_grid_equals_reference(small_collection):
    """Budgets x refine x policy factors x the superblock tier, on an
    index with a kNN graph and superblocks; the port's grid carries the
    caller's execution knobs."""
    docs = small_collection[0]
    jidx = jax_build_index(docs, JConfig(lam=128, beta=8, alpha=0.4,
                                         block_cap=32, summary_nnz=32,
                                         superblock_fanout=2),
                           list_chunk=16)
    jidx = dataclasses.replace(jidx, knn_ids=jnp.zeros(
        (jidx.n_docs, 6), jnp.int32))
    index = carry(jidx)
    for k, cut in ((10, 8), (5, 4)):
        want = jsweep.default_grid(jidx, k=k, cut=cut)
        got = psweep.default_grid(index, k=k, cut=cut, fuse_level=2)
        assert [knobs(p) for p in got] == [knobs(p) for p in want]
        assert all(p.fuse_level == 2 and p.use_kernel for p in got)
        assert any(p.superblock_fanout == 2 for p in got)
    flat = carry(small_index_without_graph(docs))
    assert [knobs(p) for p in psweep.default_grid(flat)] == \
        [knobs(p) for p in jsweep.default_grid(
            small_index_without_graph(docs))]


_flat: dict = {}


def small_index_without_graph(docs):
    if "idx" not in _flat:
        _flat["idx"] = jax_build_index(
            docs, JConfig(lam=128, beta=8, alpha=0.4, block_cap=32,
                          summary_nnz=32), list_chunk=16)
    return _flat["idx"]


@pytest.mark.parametrize("which", ["policies", "hierarchical"])
def test_measure_point_equals_reference_off_the_budget_ladder(
        small_collection, which):
    """Adaptive, global-threshold and hierarchical points, measured by
    both packages on the same index and sample: equal, and timings ride
    along as advisory seconds only."""
    docs, queries = small_collection[0], small_collection[1]
    fanout = 2 if which == "hierarchical" else 0
    jidx = jax_build_index(docs, JConfig(
        lam=128, beta=8, alpha=0.4, block_cap=32, summary_nnz=32,
        superblock_fanout=fanout), list_chunk=16)
    index = carry(jidx)
    q = PaddedSparse(torch.from_numpy(np.array(queries.coords)),
                     torch.from_numpy(np.array(queries.vals)), queries.dim)
    from repro.core.oracle import exact_topk as jexact
    dc, dv = np.array(docs.coords), np.array(docs.vals)
    eids = np.stack([jexact(dc, dv, docs.dim, np.array(queries.coords[i]),
                            np.array(queries.vals[i]), 10)[1]
                     for i in range(queries.n)])
    grid = [p for p in jsweep.default_grid(jidx)
            if (p.superblock_fanout > 0) == (fanout > 0)
            and (fanout > 0 or p.policy != "budget")][:4]
    for jp in grid:
        want = jsweep.measure_point(jidx, queries, eids, jp)
        got = psweep.measure_point(index, q, eids, port_params(jp),
                                   timings=True)
        assert same_point(got, want), (got, want)
        assert got.advisory_seconds > 0
        assert [n for n, _ in got.stage_seconds] == sorted(
            ["prep", "router", "selector", "scorer", "merge", "refine"])


def test_modeled_tuning_configs_equal_reference():
    """CONFIG_TUNED / REDUCED_TUNED: the modeled surface's rounded floats
    and the selected policies, field by field; from_tuned on the arch
    config gives the 0.95 point smoke phases use (budget 128,
    superblock_budget 32, 2 refine rounds)."""
    for p_arch, j_arch in ((pcfg.CONFIG_TUNED, jcfg.CONFIG_TUNED),
                           (pcfg.REDUCED_TUNED, jcfg.REDUCED_TUNED)):
        assert p_arch.name == j_arch.name
        assert [dataclasses.asdict(t) for t in p_arch.tuned] == \
            [dataclasses.asdict(t) for t in j_arch.tuned]
        for pt, jt in zip(pcfg._modeled_points(p_arch),
                          jcfg._modeled_points(j_arch)):
            assert same_point(pt, jt)
    p = SearchParams.from_tuned(pcfg.CONFIG_TUNED, 0.95)
    assert (p.block_budget, p.superblock_budget, p.refine_rounds,
            p.graph_degree) == (128, 32, 2, 8)
    assert pol.knobs_from_params(p) == jpol.knobs_from_params(
        JParams.from_tuned(jcfg.CONFIG_TUNED, 0.95))
    with pytest.raises(ValueError, match="no persisted TunedPolicy"):
        SearchParams.from_tuned(pcfg.CONFIG_TUNED, 0.99)
    with pytest.raises(ValueError, match="carries no TunedPolicy"):
        SearchParams.from_tuned(pcfg.CONFIG_HIER, 0.9)
