"""Plain PyTorch versions of the gather_dot kernels."""
from __future__ import annotations

import torch

from repro_torch.sparse.ops import take_rows, widen_coords


def _dot(q_dense, coords, vals, scale, zero):
    qn = coords.shape[0]
    gathered = q_dense.gather(1, widen_coords(coords).reshape(qn, -1))
    gathered = gathered.reshape(coords.shape)
    if scale is not None:
        u8 = vals.to(q_dense.dtype)
        deq = (u8 - 1.0) * scale[..., None].to(q_dense.dtype) \
            + zero[..., None].to(q_dense.dtype)
        v = torch.where(u8 > 0, deq, 0.0)
    else:
        v = vals.to(q_dense.dtype)
    return (gathered * v).sum(dim=-1)


def gather_dot_ref(q_dense: torch.Tensor, coords: torch.Tensor,
                   vals: torch.Tensor) -> torch.Tensor:
    """Single query: scores[n] = sum_j q_dense[coords[n, j]] * vals[n, j]."""
    return (q_dense[widen_coords(coords)] * vals.to(q_dense.dtype)).sum(dim=-1)


def gather_dot_batch_ref(q_dense: torch.Tensor, coords: torch.Tensor,
                         vals: torch.Tensor, scale: torch.Tensor | None = None,
                         zero: torch.Tensor | None = None) -> torch.Tensor:
    """scores[q, n] = <q_dense[q], row[q, n]>; with (scale, zero), vals is
    u8 and dequantized first (level 0 -> 0)."""
    return _dot(q_dense, coords, vals, scale, zero)


def gather_dot_cand_ref(q_dense: torch.Tensor, cand: torch.Tensor,
                        fwd_coords: torch.Tensor, fwd_vals: torch.Tensor,
                        fwd_scale: torch.Tensor | None,
                        fwd_zero: torch.Tensor | None,
                        n_docs: int) -> torch.Tensor:
    """scores[q, c] = <q_dense[q], fwd[cand[q, c]]>; sentinel ids
    (>= n_docs) score -inf. Ids are clamped into range before the row
    gather (the JAX ``mode="clip"``), then masked."""
    idx = cand.long().clamp(0, fwd_coords.shape[0] - 1)
    scale = zero = None
    if fwd_scale is not None:
        scale, zero = fwd_scale[idx], fwd_zero[idx]
    out = _dot(q_dense, take_rows(fwd_coords, idx), fwd_vals[idx], scale,
               zero)
    return torch.where(cand < n_docs, out, -torch.inf)
