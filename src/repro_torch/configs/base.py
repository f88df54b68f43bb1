"""Architecture configs of the ported model families.

A copy of ``TransformerConfig``, ``GNNConfig``, ``RecsysConfig``,
``ShapeCell``, ``lm_shapes``, ``GNN_SHAPES`` and ``RECSYS_SHAPES`` of the
JAX package's ``configs/base.py`` (same field names, defaults and
``param_count``), kept here so that the port imports nothing of it.
``ARCH_REGISTRY`` holds the JAX package's eleven ids. ``remat`` sets what
the training path recomputes (``lm.forward_train``); ``seq_parallel``,
``sharding_mode`` and GNNConfig's ``aggregate_mode`` select the sharded
paths under a mesh and, as in the JAX package, change nothing off one;
``unroll_layers`` (how XLA compiles the layer stack) is kept for parity
and has no effect in the port, nor ``learn_eps``, which the JAX forward
does not read either.
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


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int
    d_hidden: int
    aggregator: str = "sum"
    learn_eps: bool = True
    n_classes: int = 16
    mlp_layers: int = 2
    dtype: str = "float32"
    aggregate_mode: str = "psum"     # "psum" | "shard": mesh layouts only

    @property
    def family(self) -> str:
        return "gnn"


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    interaction: str                 # "fm-2way" | "concat" | "self-attn-seq" | "transformer-seq"
    embed_dim: int
    n_sparse: int = 0                # categorical fields (fm / wide-deep)
    table_rows: tuple = ()           # per-field vocab sizes
    n_dense_feat: int = 0
    mlp_dims: tuple = ()
    # sequence models (sasrec / bst)
    seq_len: int = 0
    n_items: int = 0
    n_blocks: int = 0
    n_heads: int = 0
    dtype: str = "float32"

    @property
    def family(self) -> str:
        return "recsys"

    def total_rows(self) -> int:
        return sum(self.table_rows) + self.n_items


ArchConfig = TransformerConfig | GNNConfig | RecsysConfig

# id -> module; modules define CONFIG, SHAPES, REDUCED: the JAX package's
# eleven ids, the paper's own system as a selectable arch among them
ARCH_REGISTRY: dict[str, str] = {
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "gin-tu": "repro_torch.configs.gin_tu",
    "sasrec": "repro_torch.configs.sasrec",
    "bst": "repro_torch.configs.bst",
    "fm": "repro_torch.configs.fm",
    "wide-deep": "repro_torch.configs.wide_deep",
    "seismic-msmarco": "repro_torch.configs.seismic_msmarco",
}


def list_archs() -> list[str]:
    return sorted(ARCH_REGISTRY)


def get_arch(arch_id: str):
    """The config module of an arch id (CONFIG, SHAPES, REDUCED)."""
    if arch_id not in ARCH_REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; known: {list_archs()}")
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


GNN_SHAPES = [
    ShapeCell("full_graph_sm", "train",
              dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7)),
    ShapeCell("minibatch_lg", "train",
              dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
                   fanout=(15, 10), d_feat=602, n_classes=41)),
    ShapeCell("ogb_products", "train",
              dict(n_nodes=2449029, n_edges=61859140, d_feat=100,
                   n_classes=47)),
    ShapeCell("molecule", "train",
              dict(n_nodes=30, n_edges=64, batch=128, d_feat=16,
                   n_classes=2)),
]

RECSYS_SHAPES = [
    ShapeCell("train_batch", "train", dict(batch=65536)),
    ShapeCell("serve_p99", "serve", dict(batch=512)),
    ShapeCell("serve_bulk", "serve", dict(batch=262144)),
    ShapeCell("retrieval_cand", "retrieval", dict(batch=1, n_candidates=1000000)),
]
