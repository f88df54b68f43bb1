"""deepseek-v2-lite-16b [arXiv:2405.04434]: 27L d_model=2048 16H
MLA kv_lora_rank=512, MoE 64 routed experts top-6 + 2 shared, expert
d_ff=1408, vocab=102400. First layer dense (d_ff=10944), per the
released V2-Lite. qk dims: nope 128, rope 64; v_head 128.

Note: the assignment line lists "GQA kv=16" alongside "MLA kv_lora=512";
MLA replaces GQA (latent KV), so n_kv_heads is recorded but unused on
the MLA path."""
from repro_torch.configs.base import TransformerConfig, lm_shapes

CONFIG = TransformerConfig(
    name="deepseek-v2-lite-16b", n_layers=27, d_model=2048, n_heads=16,
    n_kv_heads=16, d_head=128, d_ff=10944, vocab=102400,
    moe=True, n_experts=64, n_shared_experts=2, moe_top_k=6,
    moe_d_ff=1408, n_dense_layers=1,
    mla=True, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128)

SHAPES = lm_shapes(long_ok=False)

REDUCED = TransformerConfig(
    name="deepseek-v2-lite-reduced", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_head=16, d_ff=160, vocab=256,
    moe=True, n_experts=8, n_shared_experts=2, moe_top_k=2,
    moe_d_ff=48, n_dense_layers=1,
    mla=True, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
    v_head_dim=16, dtype="float32")
