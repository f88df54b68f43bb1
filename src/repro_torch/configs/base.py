"""Architecture configs of the ported model families.

A copy of ``TransformerConfig``, ``ShapeCell`` and ``lm_shapes`` of the
JAX package's ``configs/base.py`` (same field names, defaults and
``param_count``), kept here so that the port imports nothing of it.
``get_arch`` knows only the ids whose model the port runs. ``remat``
sets what the training path recomputes (``lm.forward_train``); the
fields ``unroll_layers``, ``seq_parallel`` and ``sharding_mode`` are
kept for parity and have no effect in the port.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (arch x input-shape) cell."""

    name: str
    kind: str                  # "train" | "prefill" | "decode" | "serve" | ...
    dims: dict
    skip: Optional[str] = None  # reason, if the cell is skipped


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    # MoE
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    n_dense_layers: int = 0          # leading dense layers in MoE stacks
    capacity_factor: float = 1.25
    # MLA (DeepSeek-V2)
    mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # local:global attention (Gemma-3)
    local_window: int = 0            # 0 = all layers global
    local_per_global: int = 0        # e.g. 5 -> pattern LLLLLG
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: str = "dots"              # "none" | "dots" | "full"
    unroll_layers: bool = False
    attn_q_chunk: int = 512          # q-tile of the plain chunked attention
    seq_parallel: bool = False
    sharding_mode: str = "tp"

    @property
    def family(self) -> str:
        return "lm"

    def param_count(self) -> int:
        """Analytic parameter count."""
        d, h, kv, dh = self.d_model, self.n_heads, self.n_kv_heads, self.d_head
        emb = self.vocab * d * 2  # in + out (untied)
        if self.mla:
            attn = d * (h * (self.qk_nope_dim + self.qk_rope_dim))  # W_q
            attn += d * self.kv_lora_rank + d * self.qk_rope_dim    # W_dkv, W_kr
            attn += self.kv_lora_rank * h * (self.qk_nope_dim + self.v_head_dim)
            attn += h * self.v_head_dim * d                          # W_o
        else:
            attn = d * h * dh + 2 * d * kv * dh + h * dh * d
        dense_ffn = 3 * d * self.d_ff
        n_moe = self.n_layers - self.n_dense_layers if self.moe else 0
        n_dense = self.n_layers - n_moe
        per_moe = 0
        if self.moe:
            per_moe = (self.n_experts + self.n_shared_experts) * 3 * d * self.moe_d_ff
            per_moe += d * self.n_experts  # router
        return (emb + self.n_layers * attn + n_dense * dense_ffn
                + n_moe * per_moe + self.n_layers * 2 * d + d)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        n_moe = self.n_layers - self.n_dense_layers
        all_experts = n_moe * self.n_experts * 3 * d * self.moe_d_ff
        active = n_moe * (self.moe_top_k + self.n_shared_experts) * 3 * d \
            * self.moe_d_ff
        return full - all_experts + active


# id -> module; modules define CONFIG, SHAPES, REDUCED. Only the ids whose
# model the port runs: the five LM archs (the GNN and recsys families and
# the retrieval config are not registered).
ARCH_REGISTRY: dict[str, str] = {
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
}


def list_archs() -> list[str]:
    return sorted(ARCH_REGISTRY)


def get_arch(arch_id: str):
    """The config module of a ported arch id (CONFIG, SHAPES, REDUCED)."""
    if arch_id not in ARCH_REGISTRY:
        raise KeyError(f"arch '{arch_id}' is not ported; ported: "
                       f"{list_archs()}")
    return importlib.import_module(ARCH_REGISTRY[arch_id])


def lm_shapes(long_ok: bool, why_not: str = "") -> list[ShapeCell]:
    """The assigned LM-family shape set."""
    cells = [
        ShapeCell("train_4k", "train", dict(seq_len=4096, global_batch=256)),
        ShapeCell("prefill_32k", "prefill", dict(seq_len=32768, global_batch=32)),
        ShapeCell("decode_32k", "decode", dict(seq_len=32768, global_batch=128)),
    ]
    skip = None if long_ok else (why_not or
                                 "pure full-attention arch; long_500k needs "
                                 "sub-quadratic attention")
    cells.append(ShapeCell("long_500k", "decode",
                           dict(seq_len=524288, global_batch=1), skip=skip))
    return cells
