"""Factorization Machine [Rendle, ICDM'10] (port of
``repro/models/recsys/fm.py``).

score = w0 + sum_i w_i x_i + sum_{i<j} <v_i, v_j> x_i x_j, with the
pairwise term computed by the O(nk) identity
0.5 * ((sum_i v_i x_i)^2 - sum_i (v_i x_i)^2).

Categorical fields have x_i = 1 (one-hot); dense features enter with
their value. The retrieval cell uses the same identity: with a fixed user
context U and candidate item embedding v_c, score(c) = const(U) + w_c +
<sum(U), v_c>, one [C, D] @ [D] product for a million candidates. Ids
are int64 here (``fm.py:64`` writes ``jnp.int64``, which is int32 under
JAX's default; every id is below 2^31, so they are the same ids).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import (ParamTree, bce_with_logits, const,
                                       draw, tree_from_jax, tree_to_jax)
from repro_torch.models.recsys.embedding import (field_offsets,
                                                 fielded_lookup, init_table,
                                                 lookup, padded_rows)


def init_params(cfg: RecsysConfig, *, seed: int = 0,
                device: str | torch.device | None = None) -> ParamTree:
    """The JAX ``init_params`` tree, drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed`` (the port's draws, not
    JAX's: ``params_from_jax`` carries those across); on the meta device
    the leaves are left undrawn."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" \
        else torch.Generator(device=dev).manual_seed(seed)
    rows = padded_rows(sum(cfg.table_rows))
    dtype = getattr(torch, cfg.dtype)
    return ParamTree(dict(
        w0=const((), 0.0, torch.float32, dev),
        w_lin=init_table(rows, 1, dtype, dev, gen),
        v=init_table(rows, cfg.embed_dim, dtype, dev, gen),
        w_dense=const((cfg.n_dense_feat,), 0.0, torch.float32, dev),
        v_dense=draw((cfg.n_dense_feat, cfg.embed_dim), 0.01, dtype, dev,
                     gen),
    ))


def params_from_jax(tree: dict, cfg: RecsysConfig, *,
                    device: str | torch.device | None = None) -> ParamTree:
    """The JAX package's ``init_params`` tree (numpy arrays) as the
    port's parameters on ``device``."""
    return tree_from_jax(tree, init_params(cfg, device="meta"),
                         resolve_device(device))


def params_to_jax(params: ParamTree, cfg: RecsysConfig) -> dict:
    """The inverse of ``params_from_jax``: numpy arrays on the host."""
    return tree_to_jax(params)


def forward(params, ids: torch.Tensor, dense: torch.Tensor,
            cfg: RecsysConfig) -> torch.Tensor:
    """ids [B, F] (per-field local ids), dense [B, Nd] -> logits [B]."""
    offs = field_offsets(cfg.table_rows)
    lin = fielded_lookup(params["w_lin"], ids, offs)[..., 0].sum(-1)
    v_cat = fielded_lookup(params["v"], ids, offs)          # [B, F, D]
    v_den = params["v_dense"][None] * dense[..., None]      # [B, Nd, D]
    vx = torch.cat([v_cat, v_den], dim=1)
    s = vx.sum(dim=1)
    pair = 0.5 * ((s * s).sum(-1) - (vx * vx).sum(dim=-1).sum(-1))
    return (params["w0"] + lin + dense @ params["w_dense"]
            + pair).float()


def loss_fn(params, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    logits = forward(params, batch["ids"], batch["dense"], cfg)
    return bce_with_logits(logits, batch["labels"])


@torch.no_grad()
def retrieval_step(params, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    """One user context vs C candidates in field 0.
    batch = {ids [1, F-1] (fields 1..F-1), dense [1, Nd], cand [C]}."""
    offs = field_offsets(cfg.table_rows)
    ctx_offs = offs[1:]
    ids, dense, cand = batch["ids"], batch["dense"], batch["cand"]
    v_ctx = fielded_lookup(params["v"], ids, ctx_offs)[0]   # [F-1, D]
    v_den = params["v_dense"] * dense[0][:, None]
    u = torch.cat([v_ctx, v_den], 0)                        # [Fc, D]
    u_sum = u.sum(0)
    const_ = (params["w0"] + dense[0] @ params["w_dense"]
              + fielded_lookup(params["w_lin"], ids, ctx_offs)[0, :, 0].sum()
              + 0.5 * ((u_sum * u_sum).sum() - (u * u).sum()))
    cand_g = cand.long() + int(offs[0])
    v_c = lookup(params["v"], cand_g)                       # [C, D]
    w_c = lookup(params["w_lin"], cand_g)[:, 0]
    return const_ + w_c + v_c @ u_sum
