"""fm [Rendle, ICDM'10]: n_sparse=39 embed_dim=10, pairwise
<v_i, v_j> x_i x_j via the O(nk) sum-square trick. Criteo-like field
vocabulary mix (~10.6M total rows)."""
from repro_torch.configs.base import RecsysConfig, RECSYS_SHAPES

_TABLE_ROWS = tuple([1_000_000] * 8 + [100_000] * 15 + [10_000] * 16)

CONFIG = RecsysConfig(
    name="fm", interaction="fm-2way", embed_dim=10, n_sparse=39,
    table_rows=_TABLE_ROWS, n_dense_feat=13)

SHAPES = RECSYS_SHAPES

REDUCED = RecsysConfig(
    name="fm-reduced", interaction="fm-2way", embed_dim=8, n_sparse=6,
    table_rows=(100, 100, 50, 50, 20, 20), n_dense_feat=4)
