"""wide-deep [arXiv:1606.07792]: n_sparse=40 embed_dim=32
mlp=1024-512-256, wide linear + deep MLP over concatenated embeddings."""
from repro_torch.configs.base import RecsysConfig, RECSYS_SHAPES

_TABLE_ROWS = tuple([1_000_000] * 8 + [100_000] * 16 + [10_000] * 16)

CONFIG = RecsysConfig(
    name="wide-deep", interaction="concat", embed_dim=32, n_sparse=40,
    table_rows=_TABLE_ROWS, n_dense_feat=13, mlp_dims=(1024, 512, 256))

SHAPES = RECSYS_SHAPES

REDUCED = RecsysConfig(
    name="wide-deep-reduced", interaction="concat", embed_dim=8,
    n_sparse=6, table_rows=(100, 100, 50, 50, 20, 20), n_dense_feat=4,
    mlp_dims=(32, 16))
