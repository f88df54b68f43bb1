"""bst [arXiv:1905.06874] (Behavior Sequence Transformer, Alibaba):
embed_dim=32 seq_len=20 n_blocks=1 n_heads=8 mlp=1024-512-256,
transformer over the behavior sequence + target item, MLP CTR head."""
from repro_torch.configs.base import RecsysConfig, RECSYS_SHAPES

CONFIG = RecsysConfig(
    name="bst", interaction="transformer-seq", embed_dim=32,
    seq_len=20, n_items=1_000_000, n_blocks=1, n_heads=8,
    mlp_dims=(1024, 512, 256))

SHAPES = RECSYS_SHAPES

REDUCED = RecsysConfig(
    name="bst-reduced", interaction="transformer-seq", embed_dim=16,
    seq_len=8, n_items=1000, n_blocks=1, n_heads=4,
    mlp_dims=(64, 32))
