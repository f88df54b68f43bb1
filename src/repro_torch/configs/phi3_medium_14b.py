"""phi3-medium-14b [arXiv:2404.14219]: 40L d_model=5120 40H (GQA kv=10)
d_ff=17920 vocab=100352 — RoPE SwiGLU GQA. The same code path as
llama3-8b with group 4; ``REDUCED`` has a single kv head."""
from repro_torch.configs.base import TransformerConfig, lm_shapes

CONFIG = TransformerConfig(
    name="phi3-medium-14b", n_layers=40, d_model=5120, n_heads=40,
    n_kv_heads=10, d_head=128, d_ff=17920, vocab=100352)

SHAPES = lm_shapes(long_ok=False)

REDUCED = TransformerConfig(
    name="phi3-medium-14b-reduced", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=1, d_head=16, d_ff=128, vocab=256, dtype="float32")
