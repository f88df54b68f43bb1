from repro_torch.data.pipeline import PrefetchLoader, lm_token_stream
from repro_torch.data.synthetic_sparse import (SyntheticSparseConfig,
                                               make_collection)

__all__ = ["PrefetchLoader", "lm_token_stream", "SyntheticSparseConfig",
           "make_collection"]
