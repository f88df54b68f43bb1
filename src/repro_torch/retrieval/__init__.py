"""Staged batch-first retrieval pipeline (port of ``repro.retrieval``)."""
from repro_torch.retrieval.params import SearchParams
from repro_torch.retrieval.pipeline import (STAGES, run_pipeline,
                                            run_pipeline_staged,
                                            search_pipeline, stage_fns,
                                            validate_params)
from repro_torch.retrieval.selector import (Selection, get_selector,
                                            register_selector,
                                            selector_names)

__all__ = ["SearchParams", "STAGES", "run_pipeline", "run_pipeline_staged",
           "search_pipeline", "stage_fns", "validate_params", "Selection",
           "get_selector", "register_selector", "selector_names"]
