"""Plain PyTorch version of the summary_dot kernel."""
from __future__ import annotations

import torch

from repro_torch.sparse.quant import dequantize_u8


def summary_dot_batch_ref(q_dense: torch.Tensor, sum_coords: torch.Tensor,
                          sum_q: torch.Tensor, sum_scale: torch.Tensor,
                          sum_zero: torch.Tensor) -> torch.Tensor:
    """r[q, l] = <q_dense[q], dequant(summary[q, l])>."""
    qn, l, s = sum_coords.shape
    sv = dequantize_u8(sum_q, sum_scale, sum_zero, dtype=q_dense.dtype)
    gathered = q_dense.gather(1, sum_coords.reshape(qn, l * s).long())
    return (gathered.reshape(qn, l, s) * sv).sum(dim=-1)
