"""Host-side caps and policy of the kernels that stream summary rows
through a ring of bulk copies (``summary_dot``, ``router_hier``).

The ring's layout and the tile sizes are defined once, in
``common/csrc/row_tiles.cuh``: each C entry point sizes its launch from
the shapes, and each library exports the sizes it would use
(``summary_dot.ops.geometry``, ``router_fused.ops.hier_geometry``, read
through ``read_geometry``). Here are what the wrappers check before a
launch (d and shared memory caps, which raise: nothing falls back) and
router_hier's blocks per query.
"""
from __future__ import annotations

import ctypes

from repro_torch.kernels.runtime import require

SMEM_MAX = 232448           # dynamic shared memory one H100 block can have
# The q bitmap (d / 8 bytes) may take at most 96 KB beside the ring.
MAX_DIM = 96 * 1024 * 8
# router_hier's largest cluster, the portable cluster size
MAX_CLUSTER = 8


def check_dim(name: str, d: int) -> None:
    require(d <= MAX_DIM, f"{name}: dimension {d} beyond the kernel's "
            f"{MAX_DIM} (its q bitmap lives in shared memory)")


def check_smem(name: str, smem: int) -> None:
    require(smem <= SMEM_MAX, f"{name}: the kernel needs {smem} bytes of "
            f"shared memory at these shapes, more than a block's "
            f"{SMEM_MAX}")


def read_geometry(name: str, fn, keys: tuple[str, ...], *shape) -> dict:
    """Call a library's geometry export ``fn(*shape, int out[len(keys)])``
    and name its values; raises where it refuses the shapes."""
    out = (ctypes.c_int * len(keys))()
    require(fn(*shape, out) == 0,
            f"{name}: the kernel's geometry refuses the shapes {shape}")
    return dict(zip(keys, out))


def cluster_size(qn: int, sms: int) -> int:
    """router_hier's blocks per query, a thread block cluster: the most (a
    power of two up to ``MAX_CLUSTER``) whose ``qn * C`` blocks still have
    an SM each. A query's time is its chain through its blocks, so a
    small batch (an online server's 8 queries: 8 blocks each) spreads it
    over idle SMs; once blocks would share SMs, a further split only
    repeats the query's set-up and sort in more blocks, and a batch that
    fills the card alone (256) runs one block per query (chip_smoke.py
    phase 8 times every size at 256, 32 and 8 queries)."""
    c = 1
    while c < MAX_CLUSTER and qn * 2 * c <= sms:
        c *= 2
    return c


__all__ = ["SMEM_MAX", "MAX_DIM", "MAX_CLUSTER",
           "check_dim", "check_smem", "read_geometry", "cluster_size"]
