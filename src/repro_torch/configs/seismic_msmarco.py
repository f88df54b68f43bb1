"""The paper's own system as a selectable arch (port of
``repro.configs.seismic_msmarco``): Seismic over a SPLADE-statistics
MS MARCO-scale collection (8.8M docs, vocab 30522, lambda=6000,
beta=400, alpha=0.4 — the paper's best MS MARCO settings, §7.1).
``CONFIG_ESPLADE`` is the same collection under Efficient SPLADE (181
non-zeros a passage, 6 a query). ``CONFIG_HIER`` / ``REDUCED_HIER``
derive the superblock tier with the adaptive
``core.build.suggest_fanout`` instead of a hand-picked fanout.

``CONFIG_TUNED`` / ``REDUCED_TUNED`` carry modeled ``TunedPolicy``
operating points (``with_modeled_tuning``), picked by the tuner's own
frontier code over a modeled cost/recall surface;
``SearchParams.from_tuned(CONFIG_TUNED, 0.95)`` resolves them as it does
on a tuned index.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ShapeCell
from repro_torch.core.build import suggest_fanout
from repro_torch.core.types import SeismicConfig


@dataclasses.dataclass(frozen=True)
class SeismicArchConfig:
    name: str
    index: SeismicConfig
    n_docs: int
    dim: int
    doc_nnz: int
    query_nnz: int
    # modeled TunedPolicy tuple: config-time operating points picked by
    # the tuner's frontier and selection code over a modeled surface
    # (modeled=True); tune_and_attach on a built index supersedes them
    tuned: tuple = ()

    @property
    def family(self) -> str:
        return "retrieval"


CONFIG = SeismicArchConfig(
    name="seismic-msmarco",
    index=SeismicConfig(lam=6000, beta=400, alpha=0.4, block_cap=64,
                        summary_nnz=96, fwd_dtype="bfloat16"),
    n_docs=8_841_823, dim=30522, doc_nnz=128, query_nnz=48)

# Efficient SPLADE (Lassance & Clinchant, SIGIR 2022) over the same MS
# MARCO v1 passages, the second embedding Seismic's evaluation runs
# (arXiv:2404.18812, section 7.1, Table 1): about 181 non-zeros a passage
# and 5.9 a query over BERT's vocabulary, under the same index settings.
# Its queries are narrower than the cut of 10: each probes its own lists.
CONFIG_ESPLADE = dataclasses.replace(CONFIG, name="seismic-msmarco-esplade",
                                     doc_nnz=181, query_nnz=6)

SHAPES = [
    ShapeCell("query_batch", "retrieval", dict(batch=4096, k=10, cut=10,
                                               block_budget=64)),
    ShapeCell("query_online", "retrieval", dict(batch=256, k=10, cut=10,
                                                block_budget=64)),
]

REDUCED = SeismicArchConfig(
    name="seismic-reduced",
    index=SeismicConfig(lam=128, beta=8, alpha=0.4, block_cap=32,
                        summary_nnz=32),
    n_docs=2048, dim=1024, doc_nnz=48, query_nnz=16)


def estimated_live_blocks(arch: SeismicArchConfig) -> torch.Tensor:
    """Modeled per-list live-block counts (int32 [dim]) for a collection
    not built yet (the :func:`suggest_fanout` statistic at config time):
    expected postings per coordinate under a uniform token model,
    truncated by ``lam``, split at ``block_cap``. Once an index exists,
    ``core.build.live_blocks(index)`` replaces it."""
    per_list = min(arch.n_docs * arch.doc_nnz / arch.dim, arch.index.lam)
    return torch.full((arch.dim,),
                      math.ceil(per_list / arch.index.block_cap),
                      dtype=torch.int32)


def with_suggested_fanout(arch: SeismicArchConfig,
                          stats=None) -> SeismicArchConfig:
    """The hierarchical (superblock) variant of an arch config, with the
    fanout ``suggest_fanout`` picks from live-block stats (modeled when
    ``stats`` is None). Single- or few-block collections come back
    unchanged (fanout 0: flat routing)."""
    if stats is None:
        stats = estimated_live_blocks(arch)
    f = suggest_fanout(stats)
    if f == arch.index.superblock_fanout:
        return arch
    return dataclasses.replace(
        arch, name=f"{arch.name}-hier",
        index=dataclasses.replace(arch.index, superblock_fanout=f))


# MS MARCO lists saturate lam (~94 live blocks a list -> fanout 8, the
# cap); the reduced CPU config lands at 2
CONFIG_HIER = with_suggested_fanout(CONFIG)
REDUCED_HIER = with_suggested_fanout(REDUCED)


# ------------------------------------------------ tuned operating points

def _modeled_points(arch: SeismicArchConfig, k: int = 10, cut: int = 8,
                    graph_degree: int = 8):
    """Modeled recall/cost surface over the coupled knob grid, the
    config-time analog of ``repro_torch.tune.sweep``: the cost side is the
    work model (expected exactly-scored docs plus refine rescoring,
    ``router_work`` for routing), the recall side a saturating coverage
    model (early blocks carry most of the top-k mass; each refine round
    recovers a fixed fraction of what the budget dropped). The floats are
    rounded as the JAX package rounds them."""
    from repro_torch.retrieval.params import SearchParams
    from repro_torch.retrieval.router import router_work
    from repro_torch.tune.sweep import MeasuredPoint
    icfg = arch.index
    per_list = min(arch.n_docs * arch.doc_nnz / arch.dim, icfg.lam)
    pool = max(cut * per_list, 1.0)
    # impact concentration (paper Fig. 1): coverage is measured against
    # the concentrated quarter of the probed postings
    eff_pool = max(pool * 0.25, 1.0)
    gain_per_round = 0.8 * graph_degree / (graph_degree + k)
    f = icfg.superblock_fanout
    points = []
    for budget in (2, 4, 8, 16, 32, 64, 128):
        if budget > cut * icfg.n_blocks:
            continue
        for rounds in (0, 1, 2):
            cov = min(1.0, budget * icfg.block_cap / eff_pool)
            base = cov ** 0.3
            gain = 1.0 - (1.0 - gain_per_round) ** rounds
            recall = base + (1.0 - base) * gain
            docs = min(budget * icfg.block_cap, pool) \
                + rounds * k * graph_degree
            p = SearchParams(
                k=k, cut=cut, block_budget=budget, policy="budget",
                superblock_fanout=f,
                superblock_budget=max(2, budget // max(f // 2, 1)),
                graph_degree=graph_degree if rounds else 0,
                refine_rounds=rounds)
            points.append(MeasuredPoint(
                params=p, recall=round(recall, 6),
                docs_evaluated=float(round(docs, 3)),
                router_cost=router_work(icfg, p, arch.query_nnz)))
    return points


def with_modeled_tuning(arch: SeismicArchConfig,
                        targets=(0.9, 0.95)) -> SeismicArchConfig:
    """The ``*-tuned`` variant: one modeled ``TunedPolicy`` per recall
    target, selected by the tuner's frontier code over the modeled
    surface."""
    from repro_torch.tune.frontier import (policy_from_point,
                                           select_operating_point)
    points = _modeled_points(arch)
    pols = tuple(
        policy_from_point(select_operating_point(points, t), t,
                          fingerprint="modeled", modeled=True)
        for t in targets)
    return dataclasses.replace(arch, name=f"{arch.name}-tuned",
                               tuned=pols)


# the MS MARCO-scale surface needs its top budget rung plus refine rounds;
# on the reduced CPU arch the model trades budget down against a round
CONFIG_TUNED = with_modeled_tuning(CONFIG_HIER)
REDUCED_TUNED = with_modeled_tuning(REDUCED_HIER)
