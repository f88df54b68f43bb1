"""BST (Behavior Sequence Transformer, arXiv:1905.06874; port of
``repro/models/recsys/bst.py``): one transformer block (8 heads) over
[history ; target item], concatenated output into a 1024-512-256 MLP CTR
head. Attention runs in plain float32, bidirectional, as in the JAX
package.

``retrieval_step`` runs the whole model once per candidate, as the JAX
package does, but ``RETRIEVAL_CHUNK`` candidates at a time: rows are
independent, so the result is the same, and at 1,000,448 candidates the
scores ``[C, 8, 21, 21]`` alone would take 14.1 GB in float32 (a chunk's
temporaries take about 3 GB). On a mesh the steps run on this rank's
rows, as ``fm``'s do; retrieval splits each chunk's candidates over the
data ranks and gathers the chunk's scores as it ends.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import (ParamTree, bce_with_logits, const,
                                       draw, layer_norm, mlp_apply, mlp_init,
                                       tree_from_jax, tree_to_jax)
from repro_torch.models.recsys.embedding import (gather_rows, init_table,
                                                 lookup, padded_rows,
                                                 place_rows)

RETRIEVAL_CHUNK = 65536


def init_params(cfg: RecsysConfig, *, seed: int = 0,
                device: str | torch.device | None = None) -> ParamTree:
    """The JAX ``init_params`` tree, drawn on ``device`` from ``seed``
    (undrawn on the meta device); see ``fm.init_params``."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" \
        else torch.Generator(device=dev).manual_seed(seed)
    d = cfg.embed_dim
    dtype = getattr(torch, cfg.dtype)
    s_total = cfg.seq_len + 1                     # history + target
    sc = d ** -0.5
    blocks = [dict(**{w: draw((d, d), sc, dtype, dev, gen)
                      for w in ("wq", "wk", "wv", "wo")},
                   w1=draw((d, 4 * d), sc, dtype, dev, gen),
                   w2=draw((4 * d, d), (4 * d) ** -0.5, dtype, dev, gen),
                   ln1_s=const((d,), 1.0, torch.float32, dev),
                   ln1_b=const((d,), 0.0, torch.float32, dev),
                   ln2_s=const((d,), 1.0, torch.float32, dev),
                   ln2_b=const((d,), 0.0, torch.float32, dev))
              for _ in range(cfg.n_blocks)]
    return ParamTree(dict(
        item_emb=init_table(padded_rows(cfg.n_items + 1), d, dtype, dev, gen),
        pos_emb=draw((s_total, d), 0.01, dtype, dev, gen),
        blocks=blocks,
        head=mlp_init((s_total * d,) + cfg.mlp_dims + (1,), dtype, dev, gen),
    ))


def params_from_jax(tree: dict, cfg: RecsysConfig, *,
                    device: str | torch.device | None = None) -> ParamTree:
    return tree_from_jax(tree, init_params(cfg, device="meta"),
                         resolve_device(device))


def params_to_jax(params: ParamTree, cfg: RecsysConfig) -> dict:
    return tree_to_jax(params)


def _attn(b, h: torch.Tensor, n_heads: int) -> torch.Tensor:
    bs, s, d = h.shape
    dh = d // n_heads
    q = (h @ b["wq"]).reshape(bs, s, n_heads, dh).transpose(1, 2).float()
    k = (h @ b["wk"]).reshape(bs, s, n_heads, dh).transpose(1, 2).float()
    v = (h @ b["wv"]).reshape(bs, s, n_heads, dh).transpose(1, 2).float()
    sc = (q @ k.transpose(-1, -2)) * dh ** -0.5               # [B, H, S, S]
    p = torch.softmax(sc, dim=-1)   # bidirectional (CTR scoring)
    o = (p @ v).transpose(1, 2)
    return o.reshape(bs, s, d).to(h.dtype) @ b["wo"]


def forward(params, seq: torch.Tensor, target: torch.Tensor,
            cfg: RecsysConfig) -> torch.Tensor:
    """seq [B, S], target [B] -> CTR logits [B] (this rank's rows on a
    mesh)."""
    full = torch.cat([seq, target[:, None].to(seq.dtype)], dim=1)  # [B, S+1]
    h = lookup(params["item_emb"], full) + params["pos_emb"][None]
    for b in params["blocks"]:
        h = h + _attn(b, layer_norm(h, b["ln1_s"], b["ln1_b"]), cfg.n_heads)
        f = layer_norm(h, b["ln2_s"], b["ln2_b"])
        h = h + torch.relu(f @ b["w1"]) @ b["w2"]
    x = h.reshape(h.shape[0], -1)
    return mlp_apply(params["head"], x,
                     len(cfg.mlp_dims) + 1)[..., 0].float()


def loss_fn(params, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    logits = forward(params, batch["seq"], batch["target"], cfg)
    return bce_with_logits(logits, place_rows(batch["labels"]))


@torch.no_grad()
def serve_step(params, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    """CTR logits [B] of a batch of requests {seq, target}, every row on
    every rank."""
    return gather_rows(forward(params, batch["seq"], batch["target"], cfg),
                       batch["seq"].shape[0])


@torch.no_grad()
def retrieval_step(params, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    """One user, C candidate targets: the transformer + MLP run batched
    over candidates, ``RETRIEVAL_CHUNK`` at a time (BST has no
    factorization shortcut: this is the cost of its interaction
    structure)."""
    seq, cand = batch["seq"], batch["cand"]
    c = cand.shape[0]
    out = torch.empty(c, dtype=torch.float32, device=cand.device)
    for i in range(0, c, RETRIEVAL_CHUNK):
        part = cand[i:i + RETRIEVAL_CHUNK]
        m = part.shape[0]
        out[i:i + m] = gather_rows(
            forward(params, seq.expand(m, seq.shape[1]), part, cfg), m)
    return out
