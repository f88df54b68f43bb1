"""``TunedPolicy``: a persisted recall-target operating point (port of
``repro.tune.policy``).

A policy pins every quality knob of ``SearchParams`` together with the
recall target it was tuned for and what the tuner measured on its
held-out sample. An index carries a tuple of them (``SeismicIndex.tuned``,
saved in the manifest by ``ckpt.save_index``); the servers check them
against the index before the first launch (:func:`validate_tuned_index`),
so a stale policy fails at construction, not at a launch.

The digests (:func:`sample_fingerprint`, :func:`row_digest`) are byte
for byte the JAX package's: the shadow auditor's drift sketch and a
persisted fingerprint compare them across packages.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from repro_torch.retrieval.params import SearchParams

# SearchParams quality knobs a tuned policy pins (everything except the
# execution details use_kernel / fuse_level, which never change results)
KNOB_FIELDS = ("k", "cut", "block_budget", "heap_factor", "policy",
               "probe_budget", "threshold_factor", "superblock_fanout",
               "superblock_budget", "graph_degree", "refine_rounds")

# a policy measured exactly at its target stays feasible after a JSON
# round trip
RECALL_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class TunedPolicy:
    """One tuned operating point (frozen and hashable, like the index's
    config); the same fields and defaults as the JAX package's."""

    target: float                  # recall@k target it was tuned for
    k: int = 10
    cut: int = 8
    block_budget: int = 32
    heap_factor: float = 0.9
    policy: str = "budget"
    probe_budget: int = 8
    threshold_factor: float = 0.75
    superblock_fanout: int = 0
    superblock_budget: int = 16
    graph_degree: int = 0
    refine_rounds: int = 0
    measured_recall: float = 0.0   # mean recall@k on the held-out sample
    measured_cost: float = 0.0     # mean docs exactly scored per query
    router_cost: int = 0           # summary dots per query
    sample_fingerprint: str = ""   # order-invariant sample digest
    modeled: bool = False          # True: config-time model, not measured

    def to_params(self, *, use_kernel: bool = True,
                  fuse_level: int = 1) -> SearchParams:
        """The pipeline params this policy pins, every knob as stored.
        ``use_kernel`` and ``fuse_level`` are execution details (results
        are equal at every level); they default to the port's
        ``SearchParams`` defaults."""
        return SearchParams(use_kernel=use_kernel, fuse_level=fuse_level,
                            **{f: getattr(self, f) for f in KNOB_FIELDS})

    def satisfies(self, target: float) -> bool:
        return self.measured_recall >= target - RECALL_EPS


def knobs_from_params(p: SearchParams) -> dict:
    """The persistable quality-knob subset of ``SearchParams``."""
    return {f: getattr(p, f) for f in KNOB_FIELDS}


def matching_policy(index, p: SearchParams) -> TunedPolicy | None:
    """The first policy attached to ``index`` whose knobs all equal
    ``p``'s (the one the drift gauges and the auditor's target read), or
    None."""
    return next((t for t in (getattr(index, "tuned", ()) or ())
                 if all(getattr(t, f) == getattr(p, f)
                        for f in KNOB_FIELDS)), None)


def sample_fingerprint(coords, vals) -> str:
    """Order-invariant digest of a held-out query sample: the sorted
    sha256 of each row's raw bytes (coords as given, values f32), hashed
    again, first 16 hex digits."""
    c = np.ascontiguousarray(np.asarray(coords))
    v = np.ascontiguousarray(np.asarray(vals, np.float32))
    rows = sorted(
        hashlib.sha256(c[i].tobytes() + v[i].tobytes()).digest()
        for i in range(c.shape[0]))
    return hashlib.sha256(b"".join(rows)).hexdigest()[:16]


def row_digest(coords_row, vals_row) -> bytes:
    """Canonical digest of one padded-sparse query row: i32 coords and
    f32 values, padding entries (value <= 0) zeroed, entries sorted by
    (coord, value), so the order and padding of the non-zeros do not
    matter."""
    c = np.asarray(coords_row, np.int32).reshape(-1)
    v = np.asarray(vals_row, np.float32).reshape(-1)
    c = np.where(v > 0, c, 0)
    v = np.where(v > 0, v, 0.0).astype(np.float32)
    order = np.lexsort((v, c))
    c = np.ascontiguousarray(c[order])
    v = np.ascontiguousarray(v[order])
    return hashlib.sha256(c.tobytes() + v.tobytes()).digest()


def row_digests(coords, vals) -> list[bytes]:
    """Per-row :func:`row_digest` over a [Q, nnz] padded sample."""
    c = np.asarray(coords)
    v = np.asarray(vals)
    return [row_digest(c[i], v[i]) for i in range(c.shape[0])]


def attach_tuned(index, policies):
    """The index carrying ``policies``, sorted by (target, cost, recall)
    so the persisted tuple does not depend on tuning order; each is
    validated against the index. Replaces any attached policies."""
    pols = tuple(sorted(policies,
                        key=lambda t: (t.target, t.measured_cost,
                                       t.measured_recall)))
    for t in pols:
        validate_policy(index, t)
    return dataclasses.replace(index, tuned=pols)


def validate_policy(index, policy: TunedPolicy) -> None:
    """Raise ``ValueError`` when a (possibly persisted) policy no longer
    fits the index it rides on."""
    from repro_torch.graph.refine import validate_refine_params
    from repro_torch.retrieval.selector import selector_names
    if not (0.0 < policy.target <= 1.0):
        raise ValueError(f"TunedPolicy.target must be in (0, 1], got "
                         f"{policy.target}")
    if policy.k < 1 or policy.cut < 1 or policy.block_budget < 1:
        raise ValueError(
            f"TunedPolicy has degenerate knobs: k={policy.k}, "
            f"cut={policy.cut}, block_budget={policy.block_budget}")
    if policy.policy not in selector_names():
        raise ValueError(
            f"TunedPolicy.policy {policy.policy!r} is not a registered "
            f"selector (have {sorted(selector_names())})")
    if policy.superblock_fanout > 0:
        if index.sup_coords is None:
            raise ValueError(
                "TunedPolicy routes hierarchically (superblock_fanout="
                f"{policy.superblock_fanout}) but the index has no "
                "superblock tier")
        if policy.superblock_fanout != index.config.superblock_fanout:
            raise ValueError(
                f"TunedPolicy superblock_fanout={policy.superblock_fanout}"
                f" mismatches the index tier "
                f"({index.config.superblock_fanout})")
    validate_refine_params(index, policy.to_params())


def validate_tuned_index(index) -> None:
    """Validate every policy attached to an index (the servers call it
    before the first launch)."""
    for t in getattr(index, "tuned", ()) or ():
        validate_policy(index, t)
