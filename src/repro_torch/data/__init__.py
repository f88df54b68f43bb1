from repro_torch.data.synthetic_sparse import (SyntheticSparseConfig,
                                               make_collection)

__all__ = ["SyntheticSparseConfig", "make_collection"]
