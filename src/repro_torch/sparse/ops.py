"""Padded-sparse vector substrate (port of ``repro.sparse.ops``).

Learned sparse embeddings are nonnegative vectors in R^d with ~40-200
non-zeros out of d~30k, stored as *padded CSR rows*:

    coords: int32 [N, nnz_max]   (padding entries point at coord 0)
    vals:   float [N, nnz_max]   (padding entries are exactly 0.0)

A padded entry contributes 0 to every inner product, so the scoring path
needs no masks. A compact forward index may carry uint16 coords; the
plain (tensor-op) paths widen them with :func:`widen_coords`.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PaddedSparse:
    """A batch of sparse vectors in padded CSR-row layout."""

    coords: torch.Tensor  # int32 (or uint16) [N, nnz_max]
    vals: torch.Tensor    # float [N, nnz_max], padding == 0.0
    dim: int = 0

    @property
    def n(self) -> int:
        return self.coords.shape[0]

    @property
    def nnz_max(self) -> int:
        return self.coords.shape[1]

    @property
    def device(self) -> torch.device:
        return self.coords.device

    def nnz(self) -> torch.Tensor:
        return (self.vals != 0).sum(dim=-1)

    def astype(self, dtype: torch.dtype) -> "PaddedSparse":
        return PaddedSparse(self.coords, self.vals.to(dtype), self.dim)

    def to(self, device) -> "PaddedSparse":
        return PaddedSparse(self.coords.to(device), self.vals.to(device),
                            self.dim)

    def __getitem__(self, idx) -> "PaddedSparse":
        return PaddedSparse(self.coords[idx], self.vals[idx], self.dim)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values,
    descending, ties broken by the LOWEST index first. ``torch.topk``
    promises no tie order, so this is a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def widen_coords(coords: torch.Tensor) -> torch.Tensor:
    """Coordinates as int64 gather indices (uint16 read as unsigned)."""
    if coords.dtype == torch.uint16:
        return coords.view(torch.int16).to(torch.int64) & 0xFFFF
    return coords.to(torch.int64)


def take_rows(plane: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``plane[ids]`` for in-range ids, keeping the plane's dtype
    (a uint16 plane is gathered through its int16 view)."""
    if plane.dtype == torch.uint16:
        return plane.view(torch.int16)[ids].view(torch.uint16)
    return plane[ids]


def densify(ps: PaddedSparse, dtype: torch.dtype = torch.float32
            ) -> torch.Tensor:
    """[N, nnz] padded-sparse -> [N, d] dense. Padding adds 0 at coord 0."""
    n = ps.coords.shape[0]
    out = torch.zeros((n, ps.dim), dtype=dtype, device=ps.coords.device)
    rows = torch.arange(n, device=out.device)[:, None].expand(ps.coords.shape)
    out.index_put_((rows, widen_coords(ps.coords)), ps.vals.to(dtype),
                   accumulate=True)
    return out


def densify_one(coords: torch.Tensor, vals: torch.Tensor, dim: int,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[nnz] sparse -> [d] dense (repeated coordinates add up)."""
    out = torch.zeros((dim,), dtype=dtype, device=coords.device)
    return out.index_put_((widen_coords(coords),), vals.to(dtype),
                          accumulate=True)


def inner_product_padded(q_dense: torch.Tensor, coords: torch.Tensor,
                         vals: torch.Tensor) -> torch.Tensor:
    """<q, x> for dense q [d] against padded-sparse rows [N, nnz] -> [N]
    (the plain version of the ``gather_dot`` kernel for one query)."""
    return (q_dense[widen_coords(coords)] * vals).sum(dim=-1)


def sparsify(dense: torch.Tensor, nnz_max: int) -> PaddedSparse:
    """[N, d] dense -> padded-sparse keeping the nnz_max largest entries."""
    vals, coords = top_k(dense, nnz_max)
    vals = torch.where(vals > 0, vals, 0.0)
    coords = torch.where(vals > 0, coords, 0)
    return PaddedSparse(coords.to(torch.int32), vals, dense.shape[-1])


def alpha_mass_subvector(coords: torch.Tensor, vals: torch.Tensor,
                         alpha: float, out_nnz: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Definition 3.1 over the last axis: keep the largest-|value| entries
    while their cumulative L1 mass stays within ``alpha * ||x||_1``; the
    first entry is always kept. Value ties keep ascending position
    (stable sort). Output is padded to ``out_nnz`` entries."""
    order = torch.sort(-vals.abs(), dim=-1, stable=True).indices
    sv = vals.gather(-1, order)
    sc = coords.gather(-1, order)
    cum = torch.cumsum(sv.abs(), dim=-1)
    keep = cum <= alpha * cum[..., -1:]
    keep[..., 0] = True                      # never emit an empty subvector
    sv = torch.where(keep, sv, 0.0)[..., :out_nnz]
    sc = torch.where(keep, sc, 0)[..., :out_nnz]
    pad = out_nnz - sv.shape[-1]
    if pad > 0:
        sv = torch.nn.functional.pad(sv, (0, pad))
        sc = torch.nn.functional.pad(sc, (0, pad))
    return sc.to(torch.int32), sv


def top_cut(coords: torch.Tensor, vals: torch.Tensor, cut: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``cut`` largest-value entries of sparse vectors (Alg. 2, L1)."""
    v, idx = top_k(vals, cut)
    c = coords.gather(-1, idx)
    c = torch.where(v > 0, c, 0)
    v = torch.where(v > 0, v, 0.0)
    return c.to(torch.int32), v


def l1_mass_fraction(vals, top: int) -> torch.Tensor:
    """Fraction of L1 mass the ``top`` largest-|value| entries of each row
    carry (in the values' float dtype; rows of zeros give 0), as the Fig. 1
    concentration benchmark measures it."""
    v = torch.as_tensor(vals).abs()
    v = torch.sort(v, dim=-1, descending=True).values
    total = v.sum(dim=-1)
    total = torch.where(total == 0, 1.0, total)
    return v[..., :top].sum(dim=-1) / total
