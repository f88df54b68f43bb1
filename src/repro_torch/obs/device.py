"""Stage accounting: each sampled staged launch's measured stage time
beside the stage's modeled device-memory traffic (port of
``repro.obs.device``).

On every staged (sampled) launch it updates, per stage and fuse level,

    seismic_stage_modeled_bytes_per_query{stage,fuse_level}
        bytes one query moves through the stage
        (:mod:`repro_torch.retrieval.workmodel`, with the element sizes
        of the index's own planes). The scorer's value follows the
        launch: at ``fuse_level >= 1`` it charges only the candidate
        tiles the kernel processes, by the kernel's own skip predicate
        (``gather_dot.ops.cand_tiles_processed``, tiles of
        ``CAND_TILE_N`` candidates of one query).

    seismic_stage_achieved_bytes_per_second{stage,fuse_level}
        the launch's modeled bytes over the stage's measured time (the
        host clock up to a synchronize of the serving stream).

Only the three stages with a traffic model (router, scorer, refine) are
accounted; prep, selector and merge move output-sized arrays the model
treats as free.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from repro_torch.kernels.gather_dot.ops import (CAND_TILE_N, CAND_TILE_Q,
                                                cand_tiles_processed)
from repro_torch.retrieval.prep import probed_width
from repro_torch.retrieval.workmodel import (refine_bytes, router_bytes,
                                             scorer_bytes)

if TYPE_CHECKING:
    from repro_torch.core.types import SeismicIndex
    from repro_torch.obs.registry import MetricsRegistry
    from repro_torch.retrieval.params import SearchParams

MODELED_STAGES = ("router", "scorer", "refine")


def scored_slots_mirror(cand: torch.Tensor, n_docs: int) -> int:
    """Per-query candidate slots the candidate kernel processes: its
    tiles that hold a live id (``cand_tiles_processed``), times the tile,
    over the queries."""
    qn = cand.shape[0]
    proc = cand_tiles_processed(cand, n_docs)
    return int(proc.sum()) * CAND_TILE_Q * CAND_TILE_N // max(qn, 1)


class DeviceAccounting:
    """Registry-backed modeled-bytes and achieved-rate accounting for one
    (index, params) serving configuration."""

    def __init__(self, index: "SeismicIndex", p: "SearchParams",
                 registry: "MetricsRegistry"):
        self.index = index
        self.p = p
        self.fuse = str(p.fuse_level)
        cfg = index.config
        self.nnz = int(index.fwd.coords.shape[1])
        self.quant = index.fwd_scale is not None
        # the element sizes of the planes this index holds
        self.fwd_row = dict(coord_bytes=index.fwd.coords.element_size(),
                            val_bytes=index.fwd.vals.element_size())
        summary_row = dict(coord_bytes=index.sum_coords.element_size(),
                           level_bytes=index.sum_q.element_size())
        self._modeled = registry.gauge(
            "seismic_stage_modeled_bytes_per_query",
            "Modeled device-memory bytes per query per stage "
            "(repro_torch.retrieval.workmodel)", ("stage", "fuse_level"))
        self._bw = registry.gauge(
            "seismic_stage_achieved_bytes_per_second",
            "Modeled stage bytes moved / measured stage time",
            ("stage", "fuse_level"))
        self._summary_row = summary_row
        # router and refine traffic is static in the launch shape
        self._static = {
            "router": self.router_bytes_per_query(),
            "refine": refine_bytes(
                k=p.k, degree=p.graph_degree, rounds=p.refine_rounds,
                nnz=self.nnz, quant=self.quant, dim=index.dim,
                fuse_level=p.fuse_level, **self.fwd_row),
        }
        for stage, b in self._static.items():
            self._modeled.labels(stage, self.fuse).set(b)

    def router_bytes_per_query(self, query_nnz: int | None = None) -> int:
        """Router traffic for a launch of queries ``query_nnz`` wide (None:
        at least ``cut`` wide), over the lists they probe
        (``prep.probed_width``)."""
        p, cfg = self.p, self.index.config
        cut = p.cut if query_nnz is None else probed_width(p.cut, query_nnz)
        return router_bytes(
            cut=cut, n_blocks=cfg.n_blocks, summary_nnz=cfg.summary_nnz,
            dim=self.index.dim, fuse_level=p.fuse_level,
            n_superblocks=cfg.n_superblocks, fanout=p.superblock_fanout,
            superblock_budget=p.superblock_budget,
            superblock_nnz=cfg.superblock_nnz, **self._summary_row)

    def scorer_bytes_per_query(self, cand: torch.Tensor | None = None
                               ) -> int:
        """Scorer traffic for one launch's candidate ids ``cand`` [Q, C]
        (``None`` models every slot scored)."""
        if cand is None:
            n_slots = self.p.block_budget * self.index.config.block_cap
            scored = n_slots
        else:
            n_slots = cand.shape[1]
            scored = scored_slots_mirror(cand, self.index.n_docs) \
                if self.p.fuse_level >= 1 else n_slots
        return scorer_bytes(n_slots=n_slots, scored_slots=scored,
                            nnz=self.nnz, quant=self.quant,
                            dim=self.index.dim,
                            fuse_level=self.p.fuse_level, **self.fwd_row)

    def observe(self, stage_seconds: dict[str, float], width: int,
                cand: torch.Tensor | None = None,
                query_nnz: int | None = None) -> None:
        """Record one staged launch: ``stage_seconds`` maps a stage to
        its measured seconds, ``width`` is the launch's rows, ``cand`` the
        scorer's candidate ids if captured, ``query_nnz`` its queries'
        width."""
        per_query = dict(self._static)
        per_query["router"] = self.router_bytes_per_query(query_nnz)
        per_query["scorer"] = self.scorer_bytes_per_query(cand)
        for stage in MODELED_STAGES:
            b = per_query[stage]
            self._modeled.labels(stage, self.fuse).set(b)
            dt = stage_seconds.get(stage)
            if dt is not None and dt > 0 and b > 0:
                self._bw.labels(stage, self.fuse).set(b * width / dt)


__all__ = ["DeviceAccounting", "scored_slots_mirror", "MODELED_STAGES"]
