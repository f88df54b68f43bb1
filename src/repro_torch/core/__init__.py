from repro_torch.core.build import (DocBlockMap, build_index,
                                    doc_block_map, list_block_arrays,
                                    live_blocks, suggest_fanout)
from repro_torch.core.mutate import MutableSeismicIndex, make_mutable
from repro_torch.core.query import SearchParams, search_batch
from repro_torch.core.types import (SeismicConfig, SeismicIndex,
                                    index_from_arrays)

__all__ = ["DocBlockMap", "build_index", "doc_block_map",
           "list_block_arrays", "live_blocks",
           "suggest_fanout", "MutableSeismicIndex", "make_mutable",
           "SearchParams", "search_batch", "SeismicConfig", "SeismicIndex",
           "index_from_arrays"]
