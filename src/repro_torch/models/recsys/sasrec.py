"""SASRec [arXiv:1808.09781]: self-attentive sequential recommendation
(port of ``repro/models/recsys/sasrec.py``).

2 causal transformer blocks (1 head, d=50) over the item history;
training uses the paper's BCE with one positive (next item) and one
sampled negative per position. Serving scores the last-position user
state against candidate item embeddings, a pure MIPS, which is where the
Seismic bridge applies (``examples/recsys_retrieval.py``; ``chip_smoke.py``
phase 22). Attention runs in plain float32, as in the JAX package (no
kernel there either); the causal mask writes -1e30.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RecsysConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import (ParamTree, const, draw, layer_norm,
                                       tree_from_jax, tree_to_jax)
from repro_torch.models.recsys.embedding import init_table, lookup, padded_rows


def init_params(cfg: RecsysConfig, *, seed: int = 0,
                device: str | torch.device | None = None) -> ParamTree:
    """The JAX ``init_params`` tree, drawn on ``device`` from ``seed``
    (undrawn on the meta device); see ``fm.init_params``. Item 0 is the
    padding id."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" \
        else torch.Generator(device=dev).manual_seed(seed)
    d = cfg.embed_dim
    dtype = getattr(torch, cfg.dtype)
    s = d ** -0.5
    blocks = [dict(**{w: draw((d, d), s, dtype, dev, gen)
                      for w in ("wq", "wk", "wv", "wo", "w1", "w2")},
                   ln1_s=const((d,), 1.0, torch.float32, dev),
                   ln1_b=const((d,), 0.0, torch.float32, dev),
                   ln2_s=const((d,), 1.0, torch.float32, dev),
                   ln2_b=const((d,), 0.0, torch.float32, dev))
              for _ in range(cfg.n_blocks)]
    return ParamTree(dict(
        item_emb=init_table(padded_rows(cfg.n_items + 1), d, dtype, dev, gen),
        pos_emb=draw((cfg.seq_len, d), 0.01, dtype, dev, gen),
        blocks=blocks,
    ))


def params_from_jax(tree: dict, cfg: RecsysConfig, *,
                    device: str | torch.device | None = None) -> ParamTree:
    return tree_from_jax(tree, init_params(cfg, device="meta"),
                         resolve_device(device))


def params_to_jax(params: ParamTree, cfg: RecsysConfig) -> dict:
    return tree_to_jax(params)


def _attn(b, h: torch.Tensor, cfg: RecsysConfig) -> torch.Tensor:
    bs, s, d = h.shape
    nh = cfg.n_heads
    dh = d // nh
    q = (h @ b["wq"]).reshape(bs, s, nh, dh).transpose(1, 2).float()
    k = (h @ b["wk"]).reshape(bs, s, nh, dh).transpose(1, 2).float()
    v = (h @ b["wv"]).reshape(bs, s, nh, dh).transpose(1, 2).float()
    sc = (q @ k.transpose(-1, -2)) * dh ** -0.5               # [B, H, S, S]
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    sc = torch.where(causal, sc, -1e30)
    p = torch.softmax(sc, dim=-1)
    o = (p @ v).transpose(1, 2)                               # [B, S, H, dh]
    return o.reshape(bs, s, d).to(h.dtype) @ b["wo"]


def forward(params, seq: torch.Tensor, cfg: RecsysConfig) -> torch.Tensor:
    """seq [B, S] item ids (0 = pad) -> states [B, S, D]."""
    h = lookup(params["item_emb"], seq) + params["pos_emb"][None]
    pad = (seq == 0)[..., None]
    h = torch.where(pad, 0.0, h)
    for b in params["blocks"]:
        h = h + _attn(b, layer_norm(h, b["ln1_s"], b["ln1_b"]), cfg)
        f = layer_norm(h, b["ln2_s"], b["ln2_b"])
        h = h + torch.relu(f @ b["w1"]) @ b["w2"]
        h = torch.where(pad, 0.0, h)
    return h


def loss_fn(params, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    """batch = {seq [B,S], pos [B,S], neg [B,S]}; pos/neg 0 = pad."""
    h = forward(params, batch["seq"], cfg)
    pe = lookup(params["item_emb"], batch["pos"])
    ne = lookup(params["item_emb"], batch["neg"])
    ps = (h * pe).sum(-1).float()
    ns = (h * ne).sum(-1).float()
    mask = (batch["pos"] != 0).float()
    loss = -(F.logsigmoid(ps) + F.logsigmoid(-ns)) * mask
    return loss.sum() / mask.sum().clamp_min(1.0)


@torch.no_grad()
def serve_step(params, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    """Score per-request candidates: batch = {seq [B,S], cand [B,C]}."""
    h = forward(params, batch["seq"], cfg)[:, -1]           # [B, D]
    ce = lookup(params["item_emb"], batch["cand"])          # [B, C, D]
    return torch.einsum("bd,bcd->bc", h.float(), ce.float())


@torch.no_grad()
def retrieval_step(params, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    """One user vs C item candidates: batch = {seq [1,S], cand [C]}, a
    single [C, D] @ [D] MIPS (the Seismic-applicable cell)."""
    h = forward(params, batch["seq"], cfg)[0, -1]
    ce = lookup(params["item_emb"], batch["cand"])
    return ce.float() @ h.float()
