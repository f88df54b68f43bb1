"""kimi-k2-1t-a32b [arXiv:2501.kimi2]: 61L d_model=7168 64H (GQA kv=8)
expert d_ff=2048 vocab=163840, MoE 384 experts top-8 — trillion-param
MoE (paper-table config). One leading dense layer (d_ff=18432) and one
shared expert, matching the released K2 stack."""
from repro_torch.configs.base import TransformerConfig, lm_shapes

CONFIG = TransformerConfig(
    name="kimi-k2-1t-a32b", n_layers=61, d_model=7168, n_heads=64,
    n_kv_heads=8, d_head=112, d_ff=18432, vocab=163840,
    moe=True, n_experts=384, n_shared_experts=1, moe_top_k=8,
    moe_d_ff=2048, n_dense_layers=1, rope_theta=50000.0)

SHAPES = lm_shapes(long_ok=False)

REDUCED = TransformerConfig(
    name="kimi-k2-reduced", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=160, vocab=256,
    moe=True, n_experts=8, n_shared_experts=1, moe_top_k=2,
    moe_d_ff=64, n_dense_layers=1, dtype="float32")
