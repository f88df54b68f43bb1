"""Stage 6 — refine: kNN-graph neighbour expansion + exact rescore (port
of ``repro.graph.refine``).

Each round, per query:

    1. gather the graph neighbours of the current merged top-k
       (``knn_ids``): ``[Q, k * graph_degree]`` candidates;
    2. dedupe them among themselves (``scorer.dedupe_batch``) and
       against every id scored in an earlier round or the original
       merge (the seen set, sentinel-masked), so only the new frontier
       pays scoring work and ``docs_evaluated`` counts distinct docs;
    3. rescore the survivors exactly through the scorer's own forward
       plane (``scorer.score_candidates``), so merged scores share one
       scale and recall@k cannot fall from one round to the next (up to
       exact score ties);
    4. re-merge to top-k.

``refine_rounds == 0`` or ``graph_degree == 0`` is the identity.
``fuse_level`` changes execution, not results: level 1 compacts each
round's frontier before the candidate-driven gather_dot kernel; level 2
runs the whole round in one launch (``kernels.refine_fused``).
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from repro_torch.retrieval.params import SearchParams

if TYPE_CHECKING:
    from repro_torch.core.types import SeismicIndex


def validate_refine_params(index: "SeismicIndex", p: SearchParams) -> None:
    """Raise ``ValueError`` when the refine knobs do not fit the index."""
    if p.graph_degree <= 0:
        return
    if index.knn_ids is None:
        raise ValueError(
            f"graph refinement requested (graph_degree={p.graph_degree}) "
            "but the index has no kNN graph; attach one with "
            "repro_torch.graph.build_doc_graph")
    built = index.knn_ids.shape[1]
    if p.graph_degree > built:
        raise ValueError(
            f"graph_degree={p.graph_degree} exceeds the built graph "
            f"degree {built}; rebuild with a larger degree or lower the "
            "knob (neighbours are score-ordered, so any prefix is valid)")


def expand_neighbors(index: "SeismicIndex", ids: torch.Tensor,
                     degree: int) -> torch.Tensor:
    """Graph neighbours of the current top-k -> int32 [Q, k * degree].
    Rows of ``-1`` padding expand to the sentinel ``n_docs``; the first
    ``degree`` columns are the best edges of a larger-degree build."""
    safe = ids.long().clamp(0, index.n_docs - 1)
    nbrs = index.knn_ids[safe][..., :degree]                # [Q, k, deg]
    nbrs = torch.where(ids[..., None] >= 0, nbrs, index.n_docs)
    return nbrs.reshape(ids.shape[0], -1).to(torch.int32)


def scored_init(ids: torch.Tensor, n_docs: int) -> torch.Tensor:
    """The seen set for round 0: the merge's ids, padding -> sentinel."""
    return torch.where(ids >= 0, ids, n_docs)


def refine_one_round(index: "SeismicIndex", q_dense: torch.Tensor,
                     scores: torch.Tensor, ids: torch.Tensor,
                     ev: torch.Tensor, scored: torch.Tensor,
                     p: SearchParams
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """One expand + rescore + re-merge round. ``scored`` (every id scored
    so far, sentinel-padded) comes back widened by this round's
    candidates."""
    from repro_torch.retrieval.merge import merge_topk
    from repro_torch.retrieval.router import NEG
    from repro_torch.retrieval.scorer import (compact_candidates,
                                              dedupe_batch,
                                              mask_tombstoned,
                                              score_candidates)
    n_docs = index.n_docs
    if p.fuse_level >= 2:
        from repro_torch.kernels.refine_fused.ops import refine_round_batch
        cand, new_s = refine_round_batch(
            ids, scored, q_dense, index.knn_ids, index.fwd.coords,
            index.fwd.vals, index.fwd_scale, index.fwd_zero, n_docs=n_docs,
            degree=p.graph_degree)
    else:
        cand = dedupe_batch(expand_neighbors(index, ids, p.graph_degree),
                            n_docs)
        seen = (cand[:, :, None] == scored[:, None, :]).any(-1)
        cand = torch.where(seen, n_docs, cand)
        if p.fuse_level >= 1:
            cand = compact_candidates(cand)
        new_s = score_candidates(index, q_dense, cand, p.use_kernel,
                                 fuse_level=p.fuse_level)
    if index.tombstone is not None:
        # stale edges may point at deleted docs: mask after scoring, so
        # the fused and the unfused rounds are both covered
        cand = mask_tombstoned(index, cand)
        new_s = torch.where(cand < n_docs, new_s, NEG)
    all_ids = torch.cat([torch.where(ids >= 0, ids, n_docs), cand], dim=1)
    all_s = torch.cat([scores, new_s], dim=1)
    ev = ev + (cand < n_docs).sum(dim=-1).to(ev.dtype)
    scores, ids, _ = merge_topk(all_ids, all_s, p.k, n_docs)
    return scores, ids, ev, torch.cat([scored, cand], dim=1)


def refine_batch(index: "SeismicIndex", q_dense: torch.Tensor,
                 scores: torch.Tensor, ids: torch.Tensor, ev: torch.Tensor,
                 p: SearchParams
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Neighbour-expand + rescore + re-merge the merged top-k, with the
    ``merge_topk`` contract: (scores [Q, k], ids int32 [Q, k] with -1
    padding, docs_evaluated int32 [Q]). The identity when
    ``refine_rounds`` or ``graph_degree`` is 0."""
    if p.refine_rounds <= 0 or p.graph_degree <= 0:
        return scores, ids, ev
    validate_refine_params(index, p)
    scored = scored_init(ids, index.n_docs)
    for _ in range(p.refine_rounds):
        scores, ids, ev, scored = refine_one_round(
            index, q_dense, scores, ids, ev, scored, p)
    return scores, ids, ev
