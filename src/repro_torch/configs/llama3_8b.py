"""llama3-8b [arXiv:2407.21783]: 32L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=128256 — GQA, 128k vocab."""
from repro_torch.configs.base import TransformerConfig, lm_shapes

CONFIG = TransformerConfig(
    name="llama3-8b", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, d_head=128, d_ff=14336, vocab=128256,
    rope_theta=500000.0)

SHAPES = lm_shapes(long_ok=False)

REDUCED = TransformerConfig(
    name="llama3-8b-reduced", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=128, vocab=256, dtype="float32")
