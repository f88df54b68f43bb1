"""Query-time hyper-parameters (port of ``repro.retrieval.params``).

One deliberate difference from the JAX package: the port defaults to
``use_kernel=True, fuse_level=1``, so the default path on the card goes
through the hand-written kernels (the JAX default avoids Pallas because
it runs in interpret mode off a TPU). ``use_kernel=False, fuse_level=0``
selects the unfused tensor-op path, the reference for the kernel paths.

``SearchParams.from_tuned(index, target)`` resolves the cheapest
persisted ``TunedPolicy`` meeting a recall target (on a tuned index, or
on an arch config's modeled ``tuned`` tuple) back into pipeline params.
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
    #                               the candidate-driven gather_dot kernel;
    #                               2 = level 1 + the fused router
    #                               (router_flat / router_hier) and the
    #                               fused refine round (refine_round), one
    #                               launch each. Results are equal at every
    #                               level; use_kernel governs the unfused
    #                               stages.
    superblock_fanout: int = 0    # 0 = flat route; > 0 = two-stage route
    #                               over the superblock tier (must equal
    #                               the index's SeismicConfig fanout)
    superblock_budget: int = 16   # superblocks kept per query after the
    #                               coarse stage
    graph_degree: int = 0         # kNN-graph refine: neighbours expanded
    #                               per merged top-k doc (<= built degree;
    #                               0 = refine is the identity)
    refine_rounds: int = 0        # refine rounds (0 = refine is the
    #                               identity)

    def __post_init__(self):
        if self.fuse_level not in (0, 1, 2):
            raise ValueError(
                f"fuse_level must be 0, 1, or 2, got {self.fuse_level}")

    @classmethod
    def from_tuned(cls, index, target: float, *, use_kernel: bool = True,
                   fuse_level: int = 1) -> "SearchParams":
        """Resolve the cheapest ``TunedPolicy`` carried by ``index`` whose
        MEASURED recall meets ``target`` (a policy tuned for 0.90 that
        measured 0.95 satisfies a 0.92 request); among those, the least
        ``(measured_cost, router_cost, target)``.

        Raises ``ValueError`` when ``index`` carries no policy meeting the
        target. Duck-typed on ``.tuned`` (an index or an arch config), so
        this module imports nothing of ``repro_torch.tune``."""
        policies = getattr(index, "tuned", ()) or ()
        if not policies:
            raise ValueError(
                "index carries no TunedPolicy; run repro.tune."
                "tune_and_attach (or pass explicit SearchParams)")
        feasible = [t for t in policies if t.satisfies(target)]
        if not feasible:
            best = max(t.measured_recall for t in policies)
            raise ValueError(
                f"no persisted TunedPolicy meets recall target "
                f"{target:.4f} (best measured {best:.4f} over "
                f"{len(policies)} policies); re-tune with a higher "
                "target or widen the tuning grid")
        chosen = min(feasible, key=lambda t: (t.measured_cost,
                                              t.router_cost, t.target))
        return chosen.to_params(use_kernel=use_kernel,
                                fuse_level=fuse_level)
