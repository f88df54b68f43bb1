"""gemma3-27b [hf:google/gemma-3-*]: 62L d_model=5376 32H (GQA kv=16)
d_ff=21504 vocab=262144 — 5:1 local:global sliding-window attention,
window 1024, 128k context.

long_500k RUNS for this arch: 5/6 of the layers attend within a
1024-token window, so decode cost/caches are bounded for them; only
every 6th (global) layer touches the full 500k cache.
"""
from repro_torch.configs.base import TransformerConfig, lm_shapes

CONFIG = TransformerConfig(
    name="gemma3-27b", n_layers=62, d_model=5376, n_heads=32,
    n_kv_heads=16, d_head=128, d_ff=21504, vocab=262144,
    local_window=1024, local_per_global=5, rope_theta=1000000.0)

SHAPES = lm_shapes(long_ok=True)

REDUCED = TransformerConfig(
    name="gemma3-27b-reduced", n_layers=6, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
    local_window=16, local_per_global=5, dtype="float32")
