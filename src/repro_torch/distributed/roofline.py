"""Roofline math for one NVIDIA H100 SXM5 80GB HBM3 at its 700 W limit
(port of ``repro/distributed/roofline.py``, whose constants are a TPU
v5e's). The dry-run (``launch.dryrun``) derives the terms from a traced
step, not from wall time.

Constants (per GPU, H100 SXM5 80GB HBM3, 700 W):
  peak bf16 compute : 989 TFLOP/s dense (tensor cores)
  HBM bandwidth     : 3.35 TB/s (HBM3)
  link bandwidth    : 50 GB/s, one 400 Gb/s NDR InfiniBand port per GPU

The link is the per-GPU inter-node rate: on the production meshes
((16, 16), (2, 16, 16)) of 8-GPU nodes every axis crosses nodes, so the
slowest hop of each collective is InfiniBand. Within a node NVLink 4
moves 450 GB/s a direction (``NVLINK_BW``, for reference; no term uses
it). The machine this port is measured on has one card, so the
collective term cannot be measured there: it stays a model.

Terms (seconds, per device, per step), the JAX package's convention:
  T_compute    = flops / PEAK_FLOPS
  T_memory     = hbm_bytes / HBM_BW
  T_collective = collective_bytes / (n_links * LINK_BW)
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 50e9
NVLINK_BW = 450e9
CARD = "NVIDIA H100 80GB HBM3, 700 W"


@dataclasses.dataclass(frozen=True)
class Roofline:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    n_links: int = 1

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.n_links * LINK_BW)

    @property
    def bottleneck(self) -> str:
        terms = dict(compute=self.t_compute, memory=self.t_memory,
                     collective=self.t_collective)
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Lower-bound step time = max term (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def compute_fraction(self) -> float:
        """How compute-bound the cell is: t_compute / t_bound. 1.0 means
        the card's tensor cores are the limiter (the roofline optimum for
        flops-dominated kernels)."""
        t = self.t_bound
        return self.t_compute / t if t > 0 else 0.0

    def as_dict(self) -> dict:
        return dict(flops=self.flops, hbm_bytes=self.hbm_bytes,
                    coll_bytes=self.coll_bytes,
                    t_compute=self.t_compute, t_memory=self.t_memory,
                    t_collective=self.t_collective,
                    bottleneck=self.bottleneck,
                    compute_fraction=self.compute_fraction())


def model_flops_train(n_params_active: int, n_tokens: int) -> float:
    """6 * N * D for one training step (fwd+bwd)."""
    return 6.0 * n_params_active * n_tokens


def model_flops_infer(n_params_active: int, n_tokens: int) -> float:
    """2 * N * D for forward-only."""
    return 2.0 * n_params_active * n_tokens
