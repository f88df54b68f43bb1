"""Unified model API, LM family (port of ``repro/models/api.py``): one
entry point per (arch x shape cell) that the launchers and the tests
share.

  bundle = get_bundle("llama3-8b")
  params = bundle.init(seed, cfg, dims, device=...)
  fn = bundle.step(cfg, dims, kind)              # "train" | "prefill" | "decode"
  batch = bundle.make_batch(rng, cfg, dims, kind, device=...)

``dims`` comes from the shape cell (``global_batch``, ``seq_len``, and
``pos`` for decode). The GNN and recsys ids raise ``KeyError`` as
``get_arch`` does until their families are ported (ROADMAP Queue 1,
item 6); ``param_specs`` waits for ``distributed/`` (item 5).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import TransformerConfig, get_arch
from repro_torch.device import resolve_device


class Spec(NamedTuple):
    """Shape and dtype of one batch entry (``jax.ShapeDtypeStruct``)."""
    shape: tuple[int, ...]
    dtype: torch.dtype


def _lm_specs(cfg: TransformerConfig, dims: dict, kind: str) -> dict:
    i32 = torch.int32
    if kind == "train":
        b, s = dims["global_batch"], dims["seq_len"]
        return dict(tokens=Spec((b, s), i32), labels=Spec((b, s), i32))
    if kind == "prefill":
        b, s = dims["global_batch"], dims["seq_len"]
        return dict(tokens=Spec((b, s), i32))
    if kind == "decode":
        return dict(tokens=Spec((dims["global_batch"], 1), i32),
                    pos=Spec((), i32))
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
            out[k] = torch.from_numpy(
                rng.integers(0, cfg.vocab, s.shape).astype(np.int32)
            ).to(device)
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


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    arch_id: str
    config: object
    reduced: object
    shapes: list
    family: str

    def init(self, seed: int, cfg, dims: dict, *, device=None):
        """``lm.init_params`` of ``cfg`` drawn from ``seed`` on ``device``
        (the port's draws, not JAX's: ``params_from_jax`` carries those
        across)."""
        from repro_torch.models.transformer import lm
        return lm.init_params(cfg, seed=seed, device=device)

    def init_cache(self, cfg, dims: dict, *, device=None) -> dict:
        from repro_torch.models.transformer import lm
        return lm.init_cache(cfg, dims["global_batch"], dims["seq_len"],
                             device=device)

    def step(self, cfg, dims: dict, kind: str) -> Callable:
        return _lm_step(cfg, kind)

    def batch_specs(self, cfg, dims: dict, kind: str) -> dict:
        return _lm_specs(cfg, dims, kind)

    def make_batch(self, rng, cfg, dims: dict, kind: str, *,
                   device=None) -> dict:
        return _lm_batch(rng, cfg, dims, kind, resolve_device(device))

    def param_specs(self, params):
        raise NotImplementedError(
            "param_specs: parameter sharding needs the port of "
            "distributed/param_sharding.py (ROADMAP Queue 1, item 5)")


def get_bundle(arch_id: str) -> ModelBundle:
    """The bundle of a ported arch id; ``KeyError`` for any other (the
    GNN and recsys ids included)."""
    mod = get_arch(arch_id)
    cfg = mod.CONFIG
    return ModelBundle(arch_id=arch_id, config=cfg, reduced=mod.REDUCED,
                       shapes=mod.SHAPES, family=cfg.family)
