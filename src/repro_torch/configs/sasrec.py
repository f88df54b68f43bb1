"""sasrec [arXiv:1808.09781]: embed_dim=50 n_blocks=2 n_heads=1
seq_len=50, self-attention sequential recommender. Item vocabulary is
production-scale 1M (the retrieval_cand cell scores 1M candidates)."""
from repro_torch.configs.base import RecsysConfig, RECSYS_SHAPES

CONFIG = RecsysConfig(
    name="sasrec", interaction="self-attn-seq", embed_dim=50,
    seq_len=50, n_items=1_000_000, n_blocks=2, n_heads=1)

SHAPES = RECSYS_SHAPES

REDUCED = RecsysConfig(
    name="sasrec-reduced", interaction="self-attn-seq", embed_dim=16,
    seq_len=12, n_items=1000, n_blocks=2, n_heads=1)
