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
def test_validate_tuned_index_raises_as_reference(small_index, case):
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
