"""Recall-target operating points (port of ``repro.tune``; the sweep
and the frontier are not ported yet)."""
from repro_torch.tune.policy import (KNOB_FIELDS, RECALL_EPS, TunedPolicy,
                                     attach_tuned, knobs_from_params,
                                     matching_policy, row_digest,
                                     row_digests, sample_fingerprint,
                                     validate_policy, validate_tuned_index)

__all__ = ["KNOB_FIELDS", "RECALL_EPS", "TunedPolicy", "attach_tuned",
           "knobs_from_params", "matching_policy", "row_digest",
           "row_digests", "sample_fingerprint", "validate_policy",
           "validate_tuned_index"]
