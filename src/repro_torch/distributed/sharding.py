"""Logical-axis sharding helpers (port of ``repro/distributed/sharding.py``).

Model code names tensor axes logically ("dp", "tp", None); they resolve
against the ambient mesh, set with :func:`set_mesh`:

  "dp" -> every data-parallel axis present:   ("pod", "data")
  "tp" -> the tensor/model-parallel axis:     "model"

With no ambient mesh every helper is the identity or returns ``()`` /
``1``, so the same model code runs unsharded on one device and sharded
on a ``torch.distributed.device_mesh.DeviceMesh`` whose axes are named
("data", "model") or ("pod", "data", "model").

The JAX package's ``shard()`` (a ``with_sharding_constraint``) has no
runtime counterpart: the port's model code places the collective that
GSPMD would insert. What stays is the layout: a :class:`PartitionSpec`
(one entry per tensor dim: None, an axis name, or a tuple of axis names,
major first) says how a full tensor is cut, and a rank holds its slice
(:func:`local_part`, :func:`shard_tensor`); :func:`gather_tensor` puts the
slices back together. Parameters, optimizer state and checkpoints use
these.
"""
from __future__ import annotations

import contextlib

import torch

# the ambient mesh: a process-wide value, not a context variable, because
# autograd runs the backward of CUDA work (and recomputes checkpointed
# blocks) on its own device threads, which must see the caller's mesh
_MESH = [None]


def _entry(e):
    """One spec entry as JAX normalizes it: a sequence of one axis is
    the axis, an empty one None."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: a tuple of per-dim entries (None,
    an axis name or a tuple of axis names), normalized as JAX does it;
    equal to the same tuple."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(_entry(e) for e in parts))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(p) for p in self) + ")"


P = PartitionSpec


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` (a DeviceMesh, or None) the ambient mesh of the
    process inside this context (``jax.set_mesh``)."""
    before = _MESH[0]
    _MESH[0] = mesh
    try:
        yield mesh
    finally:
        _MESH[0] = before


def get_mesh():
    """The ambient mesh, or None."""
    return _MESH[0]


def axis_names(mesh=None) -> tuple[str, ...]:
    mesh = get_mesh() if mesh is None else mesh
    if mesh is None:
        return ()
    return tuple(mesh.mesh_dim_names)


def _ambient_axes() -> tuple[str, ...]:
    return axis_names()


def dp_axes() -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in _ambient_axes())


def tp_axis() -> str | None:
    return "model" if "model" in _ambient_axes() else None


def mesh_axis_size(name: str, mesh=None) -> int:
    mesh = get_mesh() if mesh is None else mesh
    names = axis_names(mesh)
    if name not in names:
        return 1
    return int(mesh.mesh.shape[names.index(name)])


def axes_size(axes, mesh=None) -> int:
    """The ranks of the mesh axes ``axes`` together (1 off the mesh)."""
    n = 1
    for a in axes:
        n *= mesh_axis_size(a, mesh)
    return n


def axis_index(name: str, mesh=None) -> int:
    """This rank's position on mesh axis ``name`` (0 off the mesh)."""
    mesh = get_mesh() if mesh is None else mesh
    if name not in axis_names(mesh):
        return 0
    return int(mesh.get_local_rank(name))


def _resolve(n):
    if n == "dp":
        ax = dp_axes()
        return ax if ax else None
    if n == "tp":
        return tp_axis()
    if n is None:
        return None
    return n if n in _ambient_axes() else None


def logical(*names) -> PartitionSpec:
    """Resolve logical axis names to a PartitionSpec on the ambient
    mesh. A tuple entry (e.g. ("dp", "tp")) combines the resolved axes
    of its members onto one positional dimension (FSDP batch)."""
    out = []
    for n in names:
        if isinstance(n, tuple):
            axes: list = []
            for m in n:
                r = _resolve(m)
                if r is None:
                    continue
                axes.extend(r if isinstance(r, tuple) else (r,))
            out.append(tuple(axes) if axes else None)
        else:
            out.append(_resolve(n))
    return PartitionSpec(*out)


# ------------------------------------------------------- slices of a spec

def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def spec_axes(spec) -> tuple[str, ...]:
    """Every mesh axis a spec shards over."""
    return tuple(a for e in spec for a in entry_axes(e))


def local_part(spec, shape, mesh=None) -> tuple[slice, ...]:
    """This rank's slice of a full tensor of ``shape`` cut by ``spec``:
    each dim split evenly over the product of its axes, the rank's block
    at its row-major position over them. Axes missing from the mesh
    count as size 1; a dim that does not divide raises."""
    mesh = get_mesh() if mesh is None else mesh
    return _part_at(spec, shape, lambda ax: axis_index(ax, mesh),
                    lambda ax: mesh_axis_size(ax, mesh))


def _part_at(spec, shape, index, size) -> tuple[slice, ...]:
    """``local_part`` at the mesh position ``index(axis)``."""
    parts = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, parts):
        n, pos = 1, 0
        for ax in entry_axes(entry):
            n, pos = n * size(ax), pos * size(ax) + index(ax)
        if dim % n:
            raise ValueError(f"local_part: dim {dim} of {tuple(shape)} does "
                             f"not split over {n} ranks ({spec!r})")
        per = dim // n
        out.append(slice(pos * per, (pos + 1) * per))
    return tuple(out)


def local_shape(spec, shape, mesh=None) -> tuple[int, ...]:
    return tuple(s.stop - s.start for s in local_part(spec, shape, mesh))


def mark(t: torch.Tensor, spec) -> torch.Tensor:
    """Record on ``t`` (a rank's slice) the spec it was cut by."""
    t._repro_spec = PartitionSpec(*spec)
    return t


def spec_of(t: torch.Tensor):
    """The spec :func:`mark` recorded on ``t``, or None (a full tensor)."""
    return getattr(t, "_repro_spec", None)


def shard_tensor(full: torch.Tensor, spec, mesh=None) -> torch.Tensor:
    """This rank's slice of ``full`` under ``spec``, a contiguous copy,
    marked with the spec."""
    return mark(full[local_part(spec, full.shape, mesh)].contiguous(), spec)


def gather_tensor(local: torch.Tensor, spec, mesh=None) -> torch.Tensor:
    """The full tensor from every rank's slice under ``spec`` (every rank
    of the mesh calls this; every rank gets the full tensor). Dims are
    gathered one mesh axis at a time, minor axis first, so the blocks
    come together in row-major order."""
    from repro_torch.distributed import collectives as C
    mesh = get_mesh() if mesh is None else mesh
    out = local
    with set_mesh(mesh):
        for dim, entry in enumerate(spec):
            out = C.all_gather(out, dim, entry_axes(entry))
    return out


def full_shape(local_shape_, spec, mesh=None) -> tuple[int, ...]:
    """The shape of the full tensor whose slices under ``spec`` have
    ``local_shape_``."""
    mesh = get_mesh() if mesh is None else mesh
    parts = tuple(spec) + (None,) * (len(local_shape_) - len(spec))
    out = []
    for n, entry in zip(local_shape_, parts):
        for ax in entry_axes(entry):
            n *= mesh_axis_size(ax, mesh)
        out.append(n)
    return tuple(out)


def gather_to_root(local: torch.Tensor, spec, mesh=None):
    """The full tensor from every rank's slice under ``spec``, on the
    host of global rank 0 (None on the other ranks): each rank sends its
    slice to rank 0 (``dist.gather``; every rank of the mesh calls this),
    which places each one at its rank's mesh position. For checkpoints:
    only the writer holds the whole leaf."""
    import numpy as np
    import torch.distributed as dist
    mesh = get_mesh() if mesh is None else mesh
    send = local.detach()
    half = send.dtype in (torch.bfloat16, torch.float16)
    if dist.get_backend() == "gloo":
        send = send.cpu().contiguous()
        if half:        # moved as bytes, which every gloo build takes
            send = send.view(torch.uint8)
    send = send.contiguous()
    rank, world = dist.get_rank(), dist.get_world_size()
    bufs = [torch.empty_like(send) for _ in range(world)] if rank == 0 \
        else None
    dist.gather(send, bufs, dst=0)
    if rank != 0:
        return None
    names = axis_names(mesh)
    grid = mesh.mesh.cpu().numpy()
    shape = full_shape(tuple(local.shape), spec, mesh)
    out = torch.empty(shape, dtype=local.dtype)
    for pos in np.ndindex(grid.shape):
        at = dict(zip(names, pos))
        part = _part_at(spec, shape, lambda ax: at.get(ax, 0),
                        lambda ax: mesh_axis_size(ax, mesh))
        got = bufs[int(grid[pos])].cpu()
        out[part] = got.view(local.dtype) if got.dtype != local.dtype \
            else got
    return out


def shard_module_(module: torch.nn.Module, specs: dict, mesh=None
                  ) -> torch.nn.Module:
    """Cut every parameter of ``module`` (full tensors) to this rank's
    slice under ``specs`` (keyed by parameter name), in place."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            spec = specs[name]
            p.data = p.data[local_part(spec, p.shape, mesh)].contiguous()
            mark(p, spec)
    return module


__all__ = ["PartitionSpec", "P", "set_mesh", "get_mesh", "axis_names",
           "dp_axes", "tp_axis", "mesh_axis_size", "axes_size",
           "axis_index", "logical",
           "entry_axes", "spec_axes", "local_part", "local_shape", "mark",
           "spec_of", "shard_tensor", "gather_tensor", "full_shape",
           "gather_to_root", "shard_module_"]
