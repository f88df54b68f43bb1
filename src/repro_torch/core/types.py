"""Seismic index data model (port of ``repro.core.types``).

Same layout as the JAX package: inverted lists are a dense
``[n_coords, lam]`` doc-id matrix, block-permuted so each physical block
is ``(offset, length)`` into its list row; summaries are alpha-mass
subvectors of the block's coordinate-wise max, padded to
``summary_nnz`` and u8-quantized with per-block (scale, zero). Here the
index is a frozen dataclass of tensors on one device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.sparse.ops import PaddedSparse


@dataclasses.dataclass(frozen=True)
class SeismicConfig:
    """Indexing hyper-parameters (paper's lambda, beta, alpha); the same
    fields and defaults as the JAX package's config."""

    lam: int = 256            # max inverted-list length (static pruning)
    beta: int = 16            # max geometric clusters per list
    alpha: float = 0.4        # summary alpha-mass fraction
    block_cap: int = 64       # physical block capacity (gather window)
    summary_nnz: int = 64     # padded summary size
    fwd_dtype: str = "float32"   # forward index value dtype
    fwd_quant: bool = False      # u8 values + per-doc affine + u16 coords
    cluster_mode: str = "gather"  # kept for manifest compatibility
    blocking: str = "geometric"   # "geometric" | "fixed"
    summary_kind: str = "max"     # "max" | "centroid"
    superblock_fanout: int = 0    # coarse summary tier (0 = none)
    seed: int = 0

    @property
    def n_blocks(self) -> int:
        return self.beta + math.ceil(self.lam / self.block_cap)

    @property
    def n_superblocks(self) -> int:
        if self.superblock_fanout <= 0:
            return 0
        return math.ceil(self.n_blocks / self.superblock_fanout)

    @property
    def superblock_nnz(self) -> int:
        return self.superblock_fanout * self.summary_nnz


@dataclasses.dataclass(frozen=True)
class SeismicIndex:
    """The built index. ``n_docs`` is the sentinel doc id (one past the
    last real doc). Optional planes are ``None`` when absent."""

    fwd: PaddedSparse                # forward index  [N, nnz_d]
    list_docs: torch.Tensor          # int32 [L, lam]  block-permuted doc ids
    list_vals: torch.Tensor          # f32 [L, lam]
    list_len: torch.Tensor           # int32 [L]
    block_off: torch.Tensor          # int32 [L, n_blocks]
    block_len: torch.Tensor          # int32 [L, n_blocks] (0 = unused)
    sum_coords: torch.Tensor         # int32 [L, n_blocks, S]
    sum_q: torch.Tensor              # uint8 [L, n_blocks, S]
    sum_scale: torch.Tensor          # f32   [L, n_blocks]
    sum_zero: torch.Tensor           # f32   [L, n_blocks]
    fwd_scale: torch.Tensor | None = None   # f32 [N] (fwd_quant)
    fwd_zero: torch.Tensor | None = None    # f32 [N] (fwd_quant)
    sup_coords: torch.Tensor | None = None  # int32 [L, ns, S2] superblocks
    sup_q: torch.Tensor | None = None       # uint8 [L, ns, S2]
    sup_scale: torch.Tensor | None = None   # f32   [L, ns]
    sup_zero: torch.Tensor | None = None    # f32   [L, ns]
    knn_ids: torch.Tensor | None = None     # int32 [N, degree] kNN graph
    tail_ids: torch.Tensor | None = None    # int32 [tail_cap] mutation tail
    tombstone: torch.Tensor | None = None   # bool [N] delete marks
    tuned: tuple = ()                       # manifest operating points, raw
    config: SeismicConfig = dataclasses.field(default_factory=SeismicConfig)

    @property
    def dim(self) -> int:
        return self.fwd.dim

    @property
    def n_docs(self) -> int:
        return self.fwd.n

    @property
    def n_lists(self) -> int:
        return self.list_docs.shape[0]

    @property
    def device(self) -> torch.device:
        return self.list_docs.device

    @property
    def graph_degree(self) -> int:
        return 0 if self.knn_ids is None else self.knn_ids.shape[1]

    @property
    def tail_cap(self) -> int:
        return 0 if self.tail_ids is None else self.tail_ids.shape[0]

    def to(self, device) -> "SeismicIndex":
        moved = {name: (t.to(device) if isinstance(t, torch.Tensor) else t)
                 for name, t in self._tensor_fields().items()}
        return dataclasses.replace(self, fwd=self.fwd.to(device), **moved)

    def _tensor_fields(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if f.name not in ("fwd", "tuned", "config")}

    def nbytes(self) -> dict:
        """Index size accounting (Table 2 analog), in bytes."""
        def nb(*ts):
            return sum(t.nbytes for t in ts if t is not None)
        fwd = nb(self.fwd.coords, self.fwd.vals)
        inv = nb(self.list_docs, self.list_vals, self.list_len,
                 self.block_off, self.block_len)
        summaries = nb(self.sum_coords, self.sum_q, self.sum_scale,
                       self.sum_zero)
        superblocks = nb(self.sup_coords, self.sup_q, self.sup_scale,
                         self.sup_zero)
        graph = nb(self.knn_ids)
        mutation = nb(self.tail_ids, self.tombstone)
        return dict(forward=fwd, inverted=inv, summaries=summaries,
                    superblocks=superblocks, graph=graph, mutation=mutation,
                    total=(fwd + inv + summaries + superblocks + graph
                           + mutation))


def _tensor(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch, including bfloat16 arrays (``ml_dtypes.bfloat16``,
    or a raw 2-byte void dtype after an npz round trip), which
    ``torch.from_numpy`` rejects: they travel as their uint16 bits."""
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                      and a.dtype.itemsize == 2):
        return torch.from_numpy(np.array(a).view(np.uint16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))          # a writable copy


def config_from(config) -> SeismicConfig:
    """A port ``SeismicConfig`` from a port config or a field mapping
    (unknown keys are ignored, as the JAX loader does)."""
    if isinstance(config, SeismicConfig):
        return config
    known = {f.name for f in dataclasses.fields(SeismicConfig)}
    return SeismicConfig(**{k: v for k, v in config.items() if k in known})


def index_from_arrays(arrays: Mapping[str, np.ndarray], dim: int, config,
                      device=None, tuned: tuple = ()) -> SeismicIndex:
    """Carry a JAX-built index across: ``arrays`` holds numpy arrays named
    as in the JAX ``save_index``'s ``index.npz`` (``fwd_coords``,
    ``fwd_vals``, ``list_docs``, ...; optional planes may be absent)."""
    device = resolve_device(device)
    arrays = dict(arrays)
    fwd = PaddedSparse(_tensor(arrays.pop("fwd_coords")).to(device),
                       _tensor(arrays.pop("fwd_vals")).to(device), dim)
    fields = {f.name for f in dataclasses.fields(SeismicIndex)}
    kwargs = {k: _tensor(np.asarray(v)).to(device)
              for k, v in arrays.items() if k in fields}
    return SeismicIndex(fwd=fwd, config=config_from(config), tuned=tuned,
                        **kwargs)
