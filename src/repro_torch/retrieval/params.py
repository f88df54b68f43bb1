"""Query-time hyper-parameters (port of ``repro.retrieval.params``).

One deliberate difference from the JAX package: the port defaults to
``use_kernel=True, fuse_level=1``, so the default path on the card goes
through the hand-written kernels (the JAX default avoids Pallas because
it runs in interpret mode off a TPU). ``use_kernel=False, fuse_level=0``
selects the unfused tensor-op path, the reference for the kernel paths.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Query-time hyper-parameters shared by every pipeline stage."""

    k: int = 10
    cut: int = 8                  # probed query coordinates
    block_budget: int = 32        # max fully-evaluated blocks
    heap_factor: float = 0.9      # summary over-estimate correction
    policy: str = "adaptive"      # selector registry key ("budget" |
    #                               "adaptive" | "global_threshold" | ...)
    probe_budget: int = 8         # stage-1 blocks for the adaptive policy
    threshold_factor: float = 0.75  # global_threshold: keep blocks with
    #                                 summary >= factor * per-query max
    use_kernel: bool = True       # summary_dot / gather_dot kernels on the
    #                               unfused stages
    fuse_level: int = 1           # 0 = unfused; 1 = candidate compaction +
    #                               the candidate-driven gather_dot kernel
    #                               (ids and docs_evaluated equal at both);
    #                               2 = fused router/refine (not ported)
    superblock_fanout: int = 0    # hierarchical routing (not ported)
    superblock_budget: int = 16
    graph_degree: int = 0         # kNN-graph refinement (not ported)
    refine_rounds: int = 0

    def __post_init__(self):
        if self.fuse_level not in (0, 1, 2):
            raise ValueError(
                f"fuse_level must be 0, 1, or 2, got {self.fuse_level}")
