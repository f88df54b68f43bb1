"""Wide & Deep [arXiv:1606.07792] (port of
``repro/models/recsys/wide_deep.py``): wide linear over categorical
fields + deep MLP over concatenated field embeddings and dense
features. On a mesh the steps run on this rank's rows, as ``fm``'s do."""
from __future__ import annotations

import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import (ParamTree, bce_with_logits, const,
                                       mlp_apply, mlp_init, tree_from_jax,
                                       tree_to_jax)
from repro_torch.models.recsys.embedding import (field_offsets,
                                                 fielded_lookup, gather_rows,
                                                 init_table, padded_rows,
                                                 place_rows)


def init_params(cfg: RecsysConfig, *, seed: int = 0,
                device: str | torch.device | None = None) -> ParamTree:
    """The JAX ``init_params`` tree, drawn on ``device`` from ``seed``
    (undrawn on the meta device); see ``fm.init_params``."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" \
        else torch.Generator(device=dev).manual_seed(seed)
    rows = padded_rows(sum(cfg.table_rows))
    dtype = getattr(torch, cfg.dtype)
    d_in = cfg.n_sparse * cfg.embed_dim + cfg.n_dense_feat
    return ParamTree(dict(
        wide=init_table(rows, 1, dtype, dev, gen),
        wide_dense=const((cfg.n_dense_feat,), 0.0, torch.float32, dev),
        emb=init_table(rows, cfg.embed_dim, dtype, dev, gen),
        deep=mlp_init((d_in,) + cfg.mlp_dims + (1,), dtype, dev, gen),
        b=const((), 0.0, torch.float32, dev),
    ))


def params_from_jax(tree: dict, cfg: RecsysConfig, *,
                    device: str | torch.device | None = None) -> ParamTree:
    return tree_from_jax(tree, init_params(cfg, device="meta"),
                         resolve_device(device))


def params_to_jax(params: ParamTree, cfg: RecsysConfig) -> dict:
    return tree_to_jax(params)


def forward(params, ids: torch.Tensor, dense: torch.Tensor,
            cfg: RecsysConfig) -> torch.Tensor:
    """ids [B, F], dense [B, Nd] -> logits [B] (this rank's rows on a
    mesh)."""
    offs = field_offsets(cfg.table_rows)
    dense = place_rows(dense)
    wide = fielded_lookup(params["wide"], ids, offs)[..., 0].sum(-1)
    emb = fielded_lookup(params["emb"], ids, offs)            # [B, F, D]
    x = torch.cat([emb.reshape(emb.shape[0], -1), dense.to(emb.dtype)],
                  dim=-1)
    deep = mlp_apply(params["deep"], x, len(cfg.mlp_dims) + 1)[..., 0]
    return (params["b"] + wide + dense @ params["wide_dense"]
            + deep).float()


def loss_fn(params, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    logits = forward(params, batch["ids"], batch["dense"], cfg)
    return bce_with_logits(logits, place_rows(batch["labels"]))


@torch.no_grad()
def serve_step(params, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    """The logits [B] of a batch of requests {ids, dense}, every row on
    every rank."""
    return gather_rows(forward(params, batch["ids"], batch["dense"], cfg),
                       batch["ids"].shape[0])


@torch.no_grad()
def retrieval_step(params, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    """Score C candidates in field 0 for one user context: the deep MLP
    runs batched over candidates (no factorization exists for an MLP),
    the context expanded to every candidate and the rows split over the
    data ranks."""
    ids, dense, cand = batch["ids"], batch["dense"], batch["cand"]
    c = cand.shape[0]
    full_ids = torch.cat([ids.new_zeros((ids.shape[0], 1)), ids], dim=1)
    full_ids = full_ids.expand(c, full_ids.shape[1]).clone()
    full_ids[:, 0] = cand
    return gather_rows(forward(params, full_ids,
                               dense.expand(c, dense.shape[1]), cfg), c)
