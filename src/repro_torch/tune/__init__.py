"""Recall-target operating-point autotuner (port of ``repro.tune``).

Sweeps the coupled quality-knob space (``block_budget`` x selector policy
factors x superblock budget x ``refine_rounds``) against a held-out query
sample through the batched pipeline, builds the recall/cost Pareto
frontier on the deterministic (docs_evaluated, router_work) cost model,
and freezes the cheapest point meeting a recall target into a persisted
``TunedPolicy``.

    from repro_torch.tune import tune_and_attach
    idx = tune_and_attach(idx, held_out, exact_ids, targets=[0.9, 0.95])
    p = SearchParams.from_tuned(idx, target=0.9)
"""
from repro_torch.tune.frontier import (pareto_frontier, policy_from_point,
                                       select_operating_point, tune,
                                       tune_and_attach)
from repro_torch.tune.policy import (KNOB_FIELDS, RECALL_EPS, TunedPolicy,
                                     attach_tuned, knobs_from_params,
                                     matching_policy, row_digest,
                                     row_digests, sample_fingerprint,
                                     validate_policy, validate_tuned_index)
from repro_torch.tune.sweep import (MeasuredPoint, default_grid,
                                    measure_point, sweep)

__all__ = [
    "TunedPolicy", "MeasuredPoint", "KNOB_FIELDS", "RECALL_EPS",
    "default_grid", "measure_point", "sweep",
    "pareto_frontier", "select_operating_point", "policy_from_point",
    "tune", "tune_and_attach",
    "attach_tuned", "knobs_from_params", "matching_policy", "row_digest",
    "row_digests", "sample_fingerprint", "validate_policy",
    "validate_tuned_index",
]
