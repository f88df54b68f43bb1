"""Collective, dot-flop and operation accounting of a traced step (the
counterpart of ``repro/distributed/hlo_analysis.py``, kept under its name
so that a reader finds it).

The JAX package parses these quantities out of the compiled, per-device
HLO text. The port has no HLO: its SPMD program runs each rank's step
eagerly, so the same quantities are counted while the step runs, on
``meta`` tensors under ``collectives.dry_run`` (``launch.dryrun``):

* collective bytes from ``collectives.recording()``: every all-gather /
  all-reduce / reduce-scatter / all-to-all contributes the bytes of its
  RESULT per device, at the tensor's own dtype (NCCL moves a bf16 tensor
  as it is; gloo's float32 staging is not what a deployment moves). An
  all-reduce's 2x wire volume (reduce-scatter + all-gather) is folded
  into ``total_wire``, as the JAX package does. A collective over two
  mesh axes runs as one per axis in the port (``collectives``), and
  each is counted: an all-gather over (data, model) counts its two
  stages, where an XLA all-gather over the combined group counts one.
* dot flops and operation counts from a :class:`StepTrace` (a
  ``TorchDispatchMode``): ``2 * M * N * K`` for every matmul-class
  operation that reaches the dispatcher (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``; ``einsum``, ``matmul`` and ``linear`` lower to them),
  forward and backward, over the whole depth: the port's layer loop is
  eager, so there is no ``while`` body to extrapolate over (``n_while``
  is 0) and no probe.
* the peak of the step's live storage: every storage an operation
  creates is held from its creation until it is freed (a finalizer on
  the storage), storages that existed before the trace (the
  arguments) excluded.
"""
from __future__ import annotations

import collections
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# bytes per element of the JAX package's HLO types (its ``_DTYPE_BYTES``)
_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
}

# torch dtypes by their HLO names
HLO_TYPES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.uint16: "u16", torch.bfloat16: "bf16",
    torch.float16: "f16", torch.int32: "s32", torch.uint32: "u32",
    torch.float32: "f32", torch.int64: "s64", torch.uint64: "u64",
    torch.float64: "f64",
}

_KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
          "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}


def shape_bytes(dtype: torch.dtype, shape) -> int:
    """Bytes of a tensor of ``shape`` and ``dtype`` (the JAX package's
    ``_shape_bytes`` of one ``f32[16,8]``-style type)."""
    return math.prod(shape) * _DTYPE_BYTES[HLO_TYPES[dtype]]


def collective_bytes(records, sizes=None) -> dict:
    """{kind: bytes, ..., 'total': bytes, 'total_wire': bytes} per device
    of the collectives in ``records`` (``collectives.recording()``'s
    ``(kind, axis, dtype, shape)`` of each one's input), under the JAX
    package's keys. A result's bytes: an all-reduce's or all-to-all's
    its input's, an all-gather's n times, a reduce-scatter's 1 / n, with
    n the ranks of its axis (``sizes[axis]``, or the ambient mesh's).
    'total' sums the results; 'total_wire' weights all-reduce 2x."""
    from repro_torch.distributed.sharding import mesh_axis_size
    out: dict = collections.defaultdict(int)
    for kind, axis, dtype, shape in records:
        n = sizes[axis] if sizes is not None else mesh_axis_size(axis)
        nbytes = shape_bytes(dtype, shape)
        if kind == "all_gather":
            nbytes *= n
        elif kind == "reduce_scatter":
            nbytes //= n
        out[_KINDS[kind]] += nbytes
    out["total"] = sum(v for k, v in out.items() if k != "total")
    out["total_wire"] = out["total"] + out.get("all-reduce", 0)
    return dict(out)


# --------------------------------------------------------- the step trace

def _mm(a, b):
    return 2.0 * a.shape[0] * b.shape[1] * a.shape[1]


def _bmm(a, b):
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[2] * a.shape[2]


_aten = torch.ops.aten
# matmul-class operations -> their flops from the call's arguments
_DOTS = {
    _aten.mm: lambda args: _mm(args[0], args[1]),
    _aten.addmm: lambda args: _mm(args[1], args[2]),
    _aten.bmm: lambda args: _bmm(args[0], args[1]),
    _aten.baddbmm: lambda args: _bmm(args[1], args[2]),
}


class StepTrace(TorchDispatchMode):
    """Counts what runs inside it: operations by name (``ops``),
    matmul-class flops (``dot_flops``, ``n_dots``) and the peak bytes of
    the storages its operations create (``peak_bytes``; storages of
    tensors given to :meth:`exclude`, or existing before, are not
    counted when an operation returns them again)."""

    def __init__(self):
        super().__init__()
        self.ops: collections.Counter = collections.Counter()
        self.dot_flops = 0.0
        self.n_dots = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._held: dict = {}          # storage address -> finalizer
        self._known: set = set()

    def exclude(self, tensors) -> None:
        """Storages of ``tensors`` (the step's arguments) are not the
        step's allocations."""
        for t in tensors:
            self._known.add(t.untyped_storage()._cdata)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket
        self.ops[packet.__name__] += 1
        flops = _DOTS.get(packet)
        if flops is not None:
            self.dot_flops += flops(args)
            self.n_dots += 1
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._hold(t)
        return out

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._known or key in self._held:
            return
        n = st.nbytes()
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        self._held[key] = weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self.live_bytes -= n
        self._held.pop(key, None)

    def __exit__(self, *exc):
        for fin in list(self._held.values()):
            fin.detach()
        self._held.clear()
        return super().__exit__(*exc)


def dot_flops(trace: StepTrace) -> dict:
    """The JAX package's ``hlo_dot_flops`` result of a traced step:
    matmul flops, the number of matmuls, and ``n_while`` 0 (the port's
    layers run eagerly: every layer is counted)."""
    return dict(dot_flops=trace.dot_flops, n_dots=trace.n_dots, n_while=0)


def count_ops(trace: StepTrace, names=None) -> dict:
    """Operations the step dispatched, by aten name (all of them, or
    those of ``names``)."""
    if names is None:
        return dict(trace.ops)
    return {n: trace.ops.get(n, 0) for n in names}


__all__ = ["shape_bytes", "collective_bytes", "StepTrace", "dot_flops",
           "count_ops", "HLO_TYPES"]
