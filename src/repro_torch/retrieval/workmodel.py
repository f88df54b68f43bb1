"""Per-query device-memory traffic model of the retrieval stages (port
of ``repro.retrieval.workmodel``).

The fusion ladder (``SearchParams.fuse_level``) changes how many times
intermediate arrays cross device memory without changing any result.
This module counts the bytes per query of the router, scorer and refine
stages from the launch shapes:

* bytes every level must move are counted once: streamed index rows
  (summaries, forward rows, graph rows), the dense query row, stage
  outputs;
* an intermediate the unfused paths materialize (gathered summary
  planes, the ``[C, nnz]`` gathered forward rows, the refine expansion)
  costs twice its size, written once and read once; the fused levels
  delete exactly these terms;
* candidate slots the candidate kernel skips (tiles of sentinels only,
  ``kernels.gather_dot.ops.cand_tiles_processed``) are charged only for
  the processed slots the caller passes in.

The JAX package takes row sizes from its TPU tiling model (i32
coordinates, u8 or f32 values, f32 scale and zero). Here each function
takes the element sizes of the planes the index really holds (the port's
MS MARCO index has bf16 forward values); with the defaults (i32
coordinates, f32 or u8 values, u8 summary levels) every count equals
the JAX package's. The model is advisory: serving reports it
(``obs.device``), nothing selects on it.
"""
from __future__ import annotations


def summary_row_bytes(s: int, *, coord_bytes: int = 4,
                      level_bytes: int = 1) -> int:
    """Streamed bytes per summary row: coordinates, quantized levels,
    and its f32 (scale, zero)."""
    return s * (coord_bytes + level_bytes) + 8


def gather_row_bytes(nnz: int, *, quant: bool, coord_bytes: int = 4,
                     val_bytes: int | None = None) -> int:
    """Streamed bytes per forward row: coordinates, values (u8 on the
    quantized plane, else ``val_bytes``, f32 by default) and, on the
    quantized plane, the doc's f32 (scale, zero)."""
    if val_bytes is None:
        val_bytes = 1 if quant else 4
    return nnz * (coord_bytes + val_bytes) + (8 if quant else 0)


def router_bytes(*, cut: int, n_blocks: int, summary_nnz: int, dim: int,
                 fuse_level: int, n_superblocks: int = 0, fanout: int = 0,
                 superblock_budget: int = 0, superblock_nnz: int = 0,
                 coord_bytes: int = 4, level_bytes: int = 1) -> int:
    """Modeled bytes per query for phase R (flat or hierarchical), over
    the ``cut`` lists a query probes (``prep.probed_width``: fewer in a
    batch narrower than the search's cut).

    ``fanout == 0`` models the flat route; otherwise the two-stage route
    with ``min(superblock_budget, cut * n_superblocks)`` kept
    superblocks. ``fuse_level >= 2`` deletes the gathered summary
    intermediates (the ``[cut*nb, S]`` probe gather; hierarchically also
    the ``[M, f, S]`` child gather between the stages). ``coord_bytes``
    and ``level_bytes`` are the summary planes' element sizes."""
    q = 4 * dim
    row = dict(coord_bytes=coord_bytes, level_bytes=level_bytes)
    if fanout <= 0:
        rows = cut * n_blocks
        row_b = summary_row_bytes(summary_nnz, **row)
        base = q + rows * row_b + 4 * rows          # stream + r output
        if fuse_level >= 2:
            return base
        return base + 2 * rows * row_b              # gathered intermediate
    m = min(superblock_budget, cut * n_superblocks)
    rows_a = cut * n_superblocks
    row_a = summary_row_bytes(superblock_nnz, **row)
    rows_b = m * fanout
    row_b = summary_row_bytes(summary_nnz, **row)
    base = (q + rows_a * row_a + rows_b * row_b
            + 8 * rows_b                            # (rb, flat) outputs
            + 4 * cut * n_blocks)                   # flat-layout scatter
    if fuse_level >= 2:
        return base
    return base + 2 * (rows_a * row_a + rows_b * row_b)


def scorer_bytes(*, n_slots: int, scored_slots: int, nnz: int, quant: bool,
                 dim: int, fuse_level: int, coord_bytes: int = 4,
                 val_bytes: int | None = None) -> int:
    """Modeled bytes per query for phase S.

    ``n_slots``: candidate slots entering the stage; ``scored_slots``:
    slots the candidate kernel processes (``n_slots`` at level 0, the
    tiles ``cand_tiles_processed`` keeps at level >= 1). Level 0 also
    pays the gathered ``[n_slots, nnz]`` forward rows both ways."""
    row_b = gather_row_bytes(nnz, quant=quant, coord_bytes=coord_bytes,
                             val_bytes=val_bytes)
    q = 4 * dim
    ids_io = 8 * n_slots                            # cand ids in, scores out
    if fuse_level >= 1:
        return q + ids_io + scored_slots * row_b
    return q + ids_io + n_slots * row_b + 2 * n_slots * row_b


def refine_bytes(*, k: int, degree: int, rounds: int, nnz: int,
                 quant: bool, dim: int, fuse_level: int,
                 scored_slots_per_round: int | None = None,
                 coord_bytes: int = 4, val_bytes: int | None = None) -> int:
    """Modeled bytes per query for the refine stage.

    Per round the frontier is ``k * degree`` slots. Level < 2 pays the
    expansion and dedupe intermediates and (at level 0) the gathered
    forward rows both ways; level 2 runs the round in one launch and
    streams only the graph rows and the forward rows."""
    if rounds <= 0 or degree <= 0:
        return 0
    c = k * degree
    scored = c if scored_slots_per_round is None else scored_slots_per_round
    row_b = gather_row_bytes(nnz, quant=quant, coord_bytes=coord_bytes,
                             val_bytes=val_bytes)
    q = 4 * dim
    graph = 4 * k * degree                          # streamed knn rows
    out = 8 * c                                     # (cand, scores) per round
    if fuse_level >= 2:
        per_round = q + graph + scored * row_b + out
    elif fuse_level >= 1:
        per_round = q + graph + 2 * (2 * 4 * c) + scored * row_b + out
    else:
        per_round = (q + graph + 2 * (2 * 4 * c)
                     + c * row_b + 2 * c * row_b + out)
    return rounds * per_round


__all__ = ["summary_row_bytes", "gather_row_bytes", "router_bytes",
           "scorer_bytes", "refine_bytes"]
