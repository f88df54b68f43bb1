"""Unified model API (port of ``repro/models/api.py``): one entry point
per (arch x shape cell) that the launchers, ``chip_smoke.py`` and the
tests share, for the LM, GNN and recsys families.

  bundle = get_bundle("llama3-8b")
  params = bundle.init(seed, cfg, dims, device=...)
  fn = bundle.step(cfg, dims, kind)   # "train" | "prefill" | "decode" |
                                      # "serve" | "retrieval"
  batch = bundle.make_batch(rng, cfg, dims, kind, device=...)

``dims`` comes from the shape cell. ``make_batch`` draws the JAX
package's numpy values from ``rng`` in the same spec order, so both
packages get the same batch. Serving and retrieval steps run without
autograd. ``param_specs`` gives each parameter's ``PartitionSpec`` by the
family's rule (``distributed.param_sharding``), keyed by parameter name,
and ``init(..., mesh=)`` draws each rank's slices under them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import (GNNConfig, RecsysConfig,
                                      TransformerConfig, get_arch)
from repro_torch.device import resolve_device

I32, F32 = torch.int32, torch.float32


class Spec(NamedTuple):
    """Shape and dtype of one batch entry (``jax.ShapeDtypeStruct``)."""
    shape: tuple[int, ...]
    dtype: torch.dtype


def _ints(rng, lo, hi, shape, device) -> torch.Tensor:
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int32)
                            ).to(device)


# ============================================================ LM family

def _lm_specs(cfg: TransformerConfig, dims: dict, kind: str) -> dict:
    if kind == "train":
        b, s = dims["global_batch"], dims["seq_len"]
        return dict(tokens=Spec((b, s), I32), labels=Spec((b, s), I32))
    if kind == "prefill":
        b, s = dims["global_batch"], dims["seq_len"]
        return dict(tokens=Spec((b, s), I32))
    if kind == "decode":
        return dict(tokens=Spec((dims["global_batch"], 1), I32),
                    pos=Spec((), I32))
    raise ValueError(kind)


def _lm_batch(rng: np.random.Generator, cfg: TransformerConfig, dims: dict,
              kind: str, device) -> dict:
    """The JAX package's draws from ``rng`` (the same numpy values), as
    int32 tensors on ``device``; ``pos`` is a Python int."""
    out = {}
    for k, s in _lm_specs(cfg, dims, kind).items():
        if k == "pos":
            out[k] = int(dims.get("pos", 3))
        else:
            out[k] = _ints(rng, 0, cfg.vocab, s.shape, device)
    return out


def _lm_step(cfg: TransformerConfig, kind: str) -> Callable:
    from repro_torch.models.transformer import lm
    if kind == "train":
        return lambda params, batch: lm.loss_fn(params, batch, cfg)
    if kind == "prefill":
        return lambda params, batch: lm.forward(params, batch["tokens"],
                                                cfg)[0]
    if kind == "decode":
        return lambda params, cache, batch: lm.decode_step(
            params, cache, batch["tokens"], int(batch["pos"]), cfg)
    raise ValueError(kind)


# =========================================================== GNN family

def _gnn_dims(cell_dims: dict) -> dict:
    d = dict(cell_dims)
    if "fanout" in d:  # minibatch_lg: padded subgraph shapes
        from repro_torch.models.gnn.sampler import subgraph_shapes
        n, e = subgraph_shapes(d["batch_nodes"], tuple(d["fanout"]))
        d["sub_nodes"], d["sub_edges"] = n, e
    return d


def _pad_edges(e: int) -> int:
    """Edge counts pad to 512-multiples so the edge axis shards on any
    production mesh (padding edges are sink self-loops)."""
    return e if e < 512 else -(-e // 512) * 512


def _pad_nodes(n: int) -> int:
    """Node counts (incl. sink) pad likewise for node-sharded layers."""
    return n if n < 512 else -(-n // 512) * 512


def _gnn_specs(cfg: GNNConfig, dims: dict, kind: str) -> dict:
    d = _gnn_dims(dims)
    if "batch" in d:      # molecule: batched small graphs
        n = _pad_nodes(d["batch"] * d["n_nodes"] + 1)
        e = _pad_edges(d["batch"] * d["n_edges"])
        return dict(feats=Spec((n, d["d_feat"]), F32),
                    edges=Spec((e, 2), I32),
                    graph_ids=Spec((n,), I32),
                    graph_labels=Spec((d["batch"],), I32))
    if "sub_nodes" in d:  # sampled minibatch
        return dict(feats=Spec((_pad_nodes(d["sub_nodes"]), d["d_feat"]), F32),
                    edges=Spec((_pad_edges(d["sub_edges"]), 2), I32),
                    labels=Spec((_pad_nodes(d["sub_nodes"]),), I32))
    n = _pad_nodes(d["n_nodes"] + 1)  # full graph + sink (+ pad)
    return dict(feats=Spec((n, d["d_feat"]), F32),
                edges=Spec((_pad_edges(d["n_edges"]), 2), I32),
                labels=Spec((n,), I32))


def _gnn_batch(rng, cfg: GNNConfig, dims: dict, kind: str, device) -> dict:
    """The JAX package's draws: features, then edges, then labels."""
    specs = _gnn_specs(cfg, dims, kind)
    n = specs["feats"].shape[0]
    out = dict(
        feats=torch.from_numpy(rng.standard_normal(specs["feats"].shape)
                               .astype(np.float32)).to(device),
        edges=_ints(rng, 0, n - 1, specs["edges"].shape, device),
    )
    ncls = dims.get("n_classes", cfg.n_classes)
    if "graph_labels" in specs:
        g = specs["graph_labels"].shape[0]
        out["graph_ids"] = torch.from_numpy(np.minimum(
            np.arange(n) // dims["n_nodes"], g - 1).astype(np.int32)
        ).to(device)
        out["graph_labels"] = _ints(rng, 0, ncls, (g,), device)
    else:
        labels = rng.integers(0, ncls, (n,))
        real = dims.get("n_nodes", n - 1)
        labels[min(real, n - 1):] = -1  # sink + node padding
        out["labels"] = torch.from_numpy(labels.astype(np.int32)).to(device)
    return out


def _gnn_step(cfg: GNNConfig, kind: str, dims: dict) -> Callable:
    from repro_torch.models.gnn import gin
    if "batch" in dims:
        return lambda params, batch: gin.graph_loss(params, batch, cfg)
    return lambda params, batch: gin.node_loss(params, batch, cfg)


# ======================================================== RecSys family

def _pad_cand(n: int) -> int:
    """Candidate counts pad up to a 512-multiple so the candidate axis
    shards on any production mesh (1,000,000 -> 1,000,448; padding
    candidates score and are dropped after top-k)."""
    return n if n < 512 else -(-n // 512) * 512


def _recsys_specs(cfg: RecsysConfig, dims: dict, kind: str) -> dict:
    b = dims.get("batch", 1)
    if cfg.interaction in ("fm-2way", "concat"):
        if kind == "retrieval":
            return dict(ids=Spec((1, cfg.n_sparse - 1), I32),
                        dense=Spec((1, cfg.n_dense_feat), F32),
                        cand=Spec((_pad_cand(dims["n_candidates"]),), I32))
        specs = dict(ids=Spec((b, cfg.n_sparse), I32),
                     dense=Spec((b, cfg.n_dense_feat), F32))
        if kind == "train":
            specs["labels"] = Spec((b,), F32)
        return specs
    if cfg.interaction == "self-attn-seq":       # sasrec
        if kind == "train":
            return dict(seq=Spec((b, cfg.seq_len), I32),
                        pos=Spec((b, cfg.seq_len), I32),
                        neg=Spec((b, cfg.seq_len), I32))
        if kind == "retrieval":
            return dict(seq=Spec((1, cfg.seq_len), I32),
                        cand=Spec((_pad_cand(dims["n_candidates"]),), I32))
        return dict(seq=Spec((b, cfg.seq_len), I32),
                    cand=Spec((b, 100), I32))
    # bst
    if kind == "train":
        return dict(seq=Spec((b, cfg.seq_len), I32),
                    target=Spec((b,), I32), labels=Spec((b,), F32))
    if kind == "retrieval":
        return dict(seq=Spec((1, cfg.seq_len), I32),
                    cand=Spec((_pad_cand(dims["n_candidates"]),), I32))
    return dict(seq=Spec((b, cfg.seq_len), I32), target=Spec((b,), I32))


def _recsys_batch(rng, cfg: RecsysConfig, dims: dict, kind: str,
                  device) -> dict:
    """The JAX package's draws, entry by entry in spec order."""
    out = {}
    for k, s in _recsys_specs(cfg, dims, kind).items():
        if k == "ids":
            cols = np.stack([rng.integers(0, cfg.table_rows[i], s.shape[0])
                             for i in range(s.shape[1])], axis=1)
            out[k] = torch.from_numpy(cols.astype(np.int32)).to(device)
        elif k in ("seq", "pos", "neg", "target", "cand"):
            out[k] = _ints(rng, 1, max(cfg.n_items, 2), s.shape, device)
        elif k == "dense":
            out[k] = torch.from_numpy(rng.standard_normal(s.shape)
                                      .astype(np.float32)).to(device)
        elif k == "labels":
            out[k] = torch.from_numpy(rng.integers(0, 2, s.shape)
                                      .astype(np.float32)).to(device)
    return out


def _recsys_module(cfg: RecsysConfig):
    from repro_torch.models.recsys import bst, fm, sasrec, wide_deep
    return {"fm-2way": fm, "concat": wide_deep, "self-attn-seq": sasrec,
            "transformer-seq": bst}[cfg.interaction]


def _recsys_step(cfg: RecsysConfig, kind: str) -> Callable:
    mod = _recsys_module(cfg)
    if kind == "train":
        return lambda params, batch: mod.loss_fn(params, batch, cfg)
    if kind == "retrieval":
        return lambda params, batch: mod.retrieval_step(params, batch, cfg)
    return lambda params, batch: mod.serve_step(params, batch, cfg)


# ============================================================== bundles

@dataclasses.dataclass(frozen=True)
class ModelBundle:
    arch_id: str
    config: object
    reduced: object
    shapes: list
    family: str

    def init(self, seed: int, cfg, dims: dict, *, device=None, mesh=None):
        """The family's ``init_params`` of ``cfg`` drawn from ``seed`` on
        ``device`` (the port's draws, not JAX's: each family module's
        ``params_from_jax`` carries those across). A GNN reads
        ``d_feat`` and ``n_classes`` from ``dims``. With a ``mesh`` each
        parameter is this rank's slice under ``param_specs`` of the same
        draws."""
        if self.family == "lm":
            from repro_torch.models.transformer import lm
            return lm.init_params(cfg, seed=seed, device=device, mesh=mesh)
        if self.family == "gnn":
            from repro_torch.models.gnn import gin
            build = lambda d, g: gin.init_params(
                cfg, dims["d_feat"], dims.get("n_classes", cfg.n_classes),
                seed=seed, device=d)
        else:
            mod = _recsys_module(cfg)
            build = lambda d, g: mod.init_params(cfg, seed=seed, device=d)
        if mesh is None:
            return build(device, None)
        from repro_torch.models.common import draw_sharded
        dev = resolve_device(device)
        return draw_sharded(build, dev, None, self.param_specs, mesh)

    def init_cache(self, cfg, dims: dict, *, device=None) -> dict:
        if self.family != "lm":
            raise ValueError(f"{self.arch_id}: only the LM family decodes")
        from repro_torch.models.transformer import lm
        return lm.init_cache(cfg, dims["global_batch"], dims["seq_len"],
                             device=device)

    def step(self, cfg, dims: dict, kind: str) -> Callable:
        if self.family == "lm":
            return _lm_step(cfg, kind)
        if self.family == "gnn":
            return _gnn_step(cfg, kind, _gnn_dims(dims))
        return _recsys_step(cfg, kind)

    def batch_specs(self, cfg, dims: dict, kind: str) -> dict:
        if self.family == "lm":
            return _lm_specs(cfg, dims, kind)
        if self.family == "gnn":
            return _gnn_specs(cfg, dims, kind)
        return _recsys_specs(cfg, dims, kind)

    def make_batch(self, rng, cfg, dims: dict, kind: str, *,
                   device=None) -> dict:
        dev = resolve_device(device)
        if self.family == "lm":
            return _lm_batch(rng, cfg, dims, kind, dev)
        if self.family == "gnn":
            return _gnn_batch(rng, cfg, dims, kind, dev)
        return _recsys_batch(rng, cfg, dims, kind, dev)

    def param_specs(self, params) -> dict:
        """{parameter name: PartitionSpec} of ``params`` (a module of
        this family; meta tensors will do), by the JAX package's rule for
        the family (the LM's in its ``sharding_mode``)."""
        from repro_torch.distributed.param_sharding import (
            gnn_param_specs, lm_param_specs, recsys_param_specs)
        if self.family == "lm":
            return lm_param_specs(
                params, mode=getattr(self.config, "sharding_mode", "tp"))
        if self.family == "gnn":
            return gnn_param_specs(params)
        return recsys_param_specs(params)


def get_bundle(arch_id: str) -> ModelBundle:
    """The bundle of an arch id; ``KeyError`` for an unknown one."""
    mod = get_arch(arch_id)
    cfg = mod.CONFIG
    return ModelBundle(arch_id=arch_id, config=cfg, reduced=mod.REDUCED,
                       shapes=mod.SHAPES, family=cfg.family)
