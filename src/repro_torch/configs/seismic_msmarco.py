"""The paper's own system as a selectable arch (port of
``repro.configs.seismic_msmarco``): Seismic over a SPLADE-statistics
MS MARCO-scale collection (8.8M docs, vocab 30522, lambda=6000,
beta=400, alpha=0.4 — the paper's best MS MARCO settings, §7.1).
``CONFIG_HIER`` / ``REDUCED_HIER`` derive the superblock tier with the
adaptive ``core.build.suggest_fanout`` instead of a hand-picked fanout.

The modeled tuned variants (``with_modeled_tuning``, ``CONFIG_TUNED``)
need the tuner, which the port does not have yet.
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
    # modeled operating points of the JAX package's tuner; kept for the
    # field's sake (the port has no tuner yet)
    tuned: tuple = ()

    @property
    def family(self) -> str:
        return "retrieval"


CONFIG = SeismicArchConfig(
    name="seismic-msmarco",
    index=SeismicConfig(lam=6000, beta=400, alpha=0.4, block_cap=64,
                        summary_nnz=96, fwd_dtype="bfloat16"),
    n_docs=8_841_823, dim=30522, doc_nnz=128, query_nnz=48)

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
