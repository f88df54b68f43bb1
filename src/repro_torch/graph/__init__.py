"""kNN-graph refinement (port of ``repro.graph``): ``build_doc_graph``
attaches ``knn_ids`` to a built index by running the batched pipeline
over the corpus; ``refine_batch`` is the pipeline's sixth stage."""
from repro_torch.graph.build import (build_doc_graph, compact_forward_index,
                                     doc_queries)
from repro_torch.graph.refine import (expand_neighbors, refine_batch,
                                      validate_refine_params)

__all__ = ["build_doc_graph", "compact_forward_index", "doc_queries",
           "expand_neighbors", "refine_batch", "validate_refine_params"]
