"""Checkpoints of training state in the JAX package's on-disk layout
(port of ``repro/ckpt/checkpoint.py``'s ``save_checkpoint``,
``load_checkpoint``, ``latest_step`` and ``CheckpointManager``).

Layout of one checkpoint, byte for byte the JAX package's:

    <dir>/step_<n:08d>.tmp/      (written, then renamed on commit)
        manifest.json            step, treedef, n_leaves, shards, shapes,
                                 dtypes
        shard_<i>.npz            leaf_<j> arrays, round-robin over shards
    <dir>/step_<n:08d>/

A tree is nested dicts, lists and tuples (``None`` holds no leaf) whose
leaves are tensors or numpy arrays; leaves are numbered in
``jax.tree_util`` order, which sorts dict keys, and ``treedef`` is the
string JAX prints for the same structure. A bf16 leaf is stored as
``np.savez`` stores an ``ml_dtypes.bfloat16`` array (2-byte void items,
header ``'<V2'``) with ``bfloat16`` in the manifest, and read back
through the manifest's dtype. (The JAX package's own ``load_checkpoint``
cannot restore such a leaf: ``jnp.asarray`` refuses the void items.)

Fault tolerance, as there: a crash mid-save leaves only a ``.tmp``
directory, never a torn committed step; the step scan ignores names that
are not ``step_<digits>``; ``CheckpointManager`` drops orphaned ``.tmp``
directories when it starts, keeps the last k steps and writes in a
background thread from a host snapshot taken before ``save_async``
returns.

On a mesh, as in the JAX package, the layout on disk stays the unsharded
logical npz. ``shardings`` is a tree of the checkpoint's structure whose
leaves are ``(mesh, PartitionSpec)`` pairs (or None for a leaf that is
whole on every rank): a save gathers each leaf from the ranks' slices
(every rank calls it), rank 0 writes, and the others wait at a barrier; a
load has each rank read the files and keep its slice of each leaf. A
checkpoint saved on one mesh restores on another, or on one device.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import struct
import threading
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.device import host_array, resolve_device

_BF16 = "bfloat16"


# ----------------------------------------------------------------- trees

def tree_flatten(tree) -> tuple[list, object]:
    """(leaves in ``jax.tree_util`` order, the structure)."""
    leaves: list = []

    def walk(node):
        if isinstance(node, dict):
            return ("dict", [(k, walk(node[k])) for k in sorted(node)])
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, [walk(x) for x in node])
        if node is None:
            return ("none", None)
        leaves.append(node)
        return ("leaf", None)

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves: list):
    it = iter(leaves)

    def build(node):
        kind, kids = node
        if kind == "dict":
            return {k: build(v) for k, v in kids}
        if kind in ("list", "tuple"):
            out = [build(x) for x in kids]
            return out if kind == "list" else tuple(out)
        return None if kind == "none" else next(it)

    return build(treedef)


def treedef_str(treedef) -> str:
    """The structure as ``str(jax.tree_util.tree_structure(...))`` prints
    it, e.g. ``PyTreeDef({'a': *, 'b': [*, (*, *)], 'c': None})``."""
    def fmt(node):
        kind, kids = node
        if kind == "dict":
            return "{" + ", ".join(f"{k!r}: {fmt(v)}" for k, v in kids) + "}"
        if kind == "list":
            return "[" + ", ".join(fmt(x) for x in kids) + "]"
        if kind == "tuple":
            inner = ", ".join(fmt(x) for x in kids)
            return f"({inner},)" if len(kids) == 1 else f"({inner})"
        return "None" if kind == "none" else "*"
    return f"PyTreeDef({fmt(treedef)})"


# ------------------------------------------------------------ npz leaves

def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as (the numpy array whose bytes are stored, the manifest's
    dtype). A bf16 tensor or ``ml_dtypes`` array goes as its 2-byte
    items."""
    if isinstance(leaf, torch.Tensor):
        a = host_array(leaf.contiguous())
        return a, _BF16 if leaf.dtype == torch.bfloat16 else str(a.dtype)
    a = np.asarray(leaf, order="C")
    if a.dtype.name == _BF16:
        return a.view(np.dtype("V2")), _BF16
    return a, str(a.dtype)


def _snapshot(leaf) -> tuple[np.ndarray, str]:
    """``_host`` as a copy the caller can no longer change."""
    a, dtype = _host(leaf)
    if isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu":
        return a, dtype             # already a fresh host copy
    return a.copy(), dtype


def _savez(path: str, arrays: dict[str, tuple[np.ndarray, str]]) -> None:
    """``np.savez(path, **arrays)`` for C-contiguous arrays, except for a
    bf16 leaf's header: numpy writes ``'|V2'`` for the plain 2-byte items
    the port stores, and ``'<V2'`` for an ``ml_dtypes.bfloat16`` array,
    which is what the JAX package stores. Writing the header here gives
    the JAX package's bytes without ``ml_dtypes``, a package of JAX's
    that the port does not need."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (a, dtype) in arrays.items():
            header = np.lib.format.header_data_from_array_1_0(a)
            if dtype == _BF16:
                header["descr"] = "<V2"
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(f, header)
                f.write(a.reshape(-1).view(np.uint8).data)


def _crc32(head: bytes, a: np.ndarray) -> int:
    return zlib.crc32(a.reshape(-1).view(np.uint8), zlib.crc32(head))


def _read_npz(path: str) -> dict[str, np.ndarray]:
    """The arrays of an npz by member name (without ``.npy``). A member
    stored uncompressed, as ``np.savez`` stores it, is read straight from
    its offset in the file into its array (``np.fromfile``): at 18 GB
    zipfile's chunked copies dominate a restore. Each such member is
    then held to the zip directory as zipfile holds it: its size, and
    its CRC-32, computed in a thread pool while the next members are read
    (``zlib.crc32`` releases the GIL). A compressed member goes through
    zipfile, which checks it itself."""
    out, crcs = {}, []
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f, \
            ThreadPoolExecutor(max_workers=4) as pool:
        for info in zf.infolist():
            name = info.filename.removesuffix(".npy")
            if info.compress_type != zipfile.ZIP_STORED:
                with zf.open(info) as member:
                    out[name] = np.lib.format.read_array(member)
                continue
            f.seek(info.header_offset)
            n_name, n_extra = struct.unpack("<HH", f.read(30)[26:30])
            start = info.header_offset + 30 + n_name + n_extra
            f.seek(start)
            major, _ = np.lib.format.read_magic(f)
            read_header = (np.lib.format.read_array_header_1_0 if major == 1
                           else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_header(f)
            n_head = f.tell() - start
            a = np.fromfile(f, dtype=dtype, count=math.prod(shape))
            if n_head + a.nbytes != info.file_size:
                raise zipfile.BadZipFile(
                    f"{path}: {info.filename} holds {n_head + a.nbytes} "
                    f"bytes where the zip directory says {info.file_size}")
            f.seek(start)
            crcs.append((info, pool.submit(_crc32, f.read(n_head), a)))
            out[name] = a.reshape(shape, order="F" if fortran else "C")
        for info, crc in crcs:
            if crc.result() != info.CRC:
                raise zipfile.BadZipFile(
                    f"{path}: bad CRC-32 for {info.filename}")
    return out


def _torch_leaf(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        return torch.from_numpy(np.asarray(a, order="C").view(np.int16)) \
            .view(torch.bfloat16)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.uint16)
    return torch.from_numpy(np.asarray(a, order="C"))


def _torch_dtype(leaf) -> torch.dtype:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    name = np.dtype(leaf.dtype).name
    return torch.bfloat16 if name == _BF16 else getattr(torch, name)


# ----------------------------------------------------------- checkpoints

def _write(path: str, step: int, arrays: list[tuple[np.ndarray, str]],
           treedef, shards: int) -> str:
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    # start from a clean tmp: an orphaned .tmp from a crashed save at the
    # same step must not contribute stale shard files to the commit
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = dict(step=step, treedef=treedef_str(treedef),
                    n_leaves=len(arrays), shards=shards,
                    shapes=[list(a.shape) for a, _ in arrays],
                    dtypes=[dtype for _, dtype in arrays])
    per_shard: list[dict] = [dict() for _ in range(shards)]
    for i, a in enumerate(arrays):
        per_shard[i % shards][f"leaf_{i}"] = a
    for s, d in enumerate(per_shard):
        _savez(os.path.join(tmp, f"shard_{s}.npz"), d)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)           # atomic commit
    return final


def _sharding_leaves(shardings, n: int) -> list:
    """The ``(mesh, spec)`` pairs of ``shardings`` in leaf order (a pair
    is a leaf here), or n Nones."""
    if shardings is None:
        return [None] * n
    out: list = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, list) or (isinstance(node, tuple) and not (
                len(node) == 2 and hasattr(node[0], "mesh_dim_names"))):
            for x in node:
                walk(x)
        else:
            out.append(node)

    walk(shardings)
    if len(out) != n:
        raise ValueError(f"shardings has {len(out)} leaves, the tree {n}")
    return out


def _mesh_rank(shards: list) -> int:
    """This process's global rank (0 without a sharded leaf)."""
    if not any(s is not None for s in shards):
        return 0
    import torch.distributed as dist
    return dist.get_rank()


def _barrier(shards: list) -> None:
    if any(s is not None for s in shards):
        import torch.distributed as dist
        dist.barrier()


def _gathered(leaves: list, shards: list, snapshot) -> list:
    """Each leaf as rank 0 writes it: a sharded leaf gathered from the
    ranks' slices to rank 0's host, then snapshot there; other ranks keep
    None."""
    from repro_torch.distributed.sharding import gather_to_root
    rank = _mesh_rank(shards)
    out = []
    for leaf, sh in zip(leaves, shards):
        if sh is not None:
            mesh, spec = sh
            leaf = gather_to_root(leaf, spec, mesh)
        out.append(snapshot(leaf) if rank == 0 else None)
    return out


def save_checkpoint(path: str, step: int, tree, *, shards: int = 1,
                    shardings=None) -> str:
    """Write one checkpoint atomically; returns the committed directory.
    Leaves on the card are copied to the host first. With ``shardings``
    every rank of the mesh calls this: the leaves are gathered, rank 0
    writes, and every rank returns after the commit."""
    leaves, treedef = tree_flatten(tree)
    sh = _sharding_leaves(shardings, len(leaves))
    arrays = _gathered(leaves, sh, _host)
    final = os.path.join(path, f"step_{step:08d}")
    if _mesh_rank(sh) == 0:
        final = _write(path, step, arrays, treedef, shards)
    _barrier(sh)
    return final


def _parse_step(name: str, prefix: str = "step_") -> int | None:
    """Step number of one committed checkpoint entry, or ``None`` for
    anything else: ``.tmp``/``.old`` leftovers, foreign names
    (``step_final``, ``step_7.bak``) or the prefix alone. The scans below
    never raise on such entries."""
    if not name.startswith(prefix):
        return None
    suffix = name[len(prefix):]
    return int(suffix) if suffix.isdigit() else None


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = [s for d in os.listdir(path)
             if (s := _parse_step(d)) is not None]
    return max(steps) if steps else None


def load_checkpoint(path: str, like_tree, *, step: int | None = None,
                    device=None, shardings=None):
    """Restore the newest (or the given) committed step into the
    structure of ``like_tree`` (tensors or numpy arrays, the leaves' full
    shapes: they are checked and their dtypes taken). Returns (tree of
    tensors on ``device``, step). ``device`` follows the port's rule:
    CUDA unless the caller names another. With ``shardings`` (a tree of
    ``(mesh, spec)`` leaves, or None for a whole leaf) each rank keeps its
    slice of each leaf under its spec, marked with it (elastic restore:
    any mesh)."""
    from repro_torch.distributed.sharding import local_part, mark
    dev = resolve_device(device)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves, treedef = tree_flatten(like_tree)
    if len(leaves) != manifest["n_leaves"]:
        raise ValueError(f"leaf count mismatch: {len(leaves)} vs "
                         f"{manifest['n_leaves']}")
    sh = _sharding_leaves(shardings, len(leaves))
    arrays: dict[int, np.ndarray] = {}
    for s in range(manifest["shards"]):
        for k, a in _read_npz(os.path.join(d, f"shard_{s}.npz")).items():
            arrays[int(k.split("_")[1])] = a
    out = []
    for i, (ref, shd) in enumerate(zip(leaves, sh)):
        a = arrays.pop(i)
        if tuple(a.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: {a.shape} vs {tuple(ref.shape)}")
        t = _torch_leaf(a, manifest["dtypes"][i])
        if shd is not None:
            mesh, spec = shd
            t = t[local_part(spec, t.shape, mesh)]
        t = t.to(device=dev, dtype=_torch_dtype(ref))
        out.append(mark(t.contiguous(), shd[1]) if shd is not None else t)
        del a
    return tree_unflatten(treedef, out), step


class CheckpointManager:
    """Async save + keep-last-k retention."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._shards: list = []
        os.makedirs(path, exist_ok=True)
        self._clean_orphans()

    def _clean_orphans(self) -> None:
        """Drop half-written ``step_*.tmp`` directories left by a crash
        mid-save (a ``.tmp`` is never a valid checkpoint); runs once at
        start, before any save can race it."""
        for d in os.listdir(self.path):
            if d.startswith("step_") and d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.path, d),
                              ignore_errors=True)

    def save_async(self, step: int, tree, *, shardings=None) -> None:
        """Snapshot ``tree`` to the host now (so the caller may go on
        updating it), then write it in a background thread. With
        ``shardings`` every rank calls this: the leaves are gathered now
        and rank 0 writes; ``wait`` is a barrier of the ranks."""
        leaves, treedef = tree_flatten(tree)
        sh = _sharding_leaves(shardings, len(leaves))
        host = _gathered(leaves, sh, _snapshot)
        self.wait()
        self._shards = sh
        if _mesh_rank(sh) != 0:
            return

        def work():
            try:
                _write(self.path, step, host, treedef, 1)
                self._gc()
            except BaseException as exc:        # re-raised by wait()
                self._error = exc

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Wait for the pending save; raise its error, if it failed. On a
        mesh every rank waits until rank 0 has committed it."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        shards, self._shards = self._shards, []
        _barrier(shards)
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc

    def _gc(self) -> None:
        steps = sorted(s for d in os.listdir(self.path)
                       if (s := _parse_step(d)) is not None)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, like_tree, *, device=None, shardings=None):
        return load_checkpoint(self.path, like_tree, device=device,
                               shardings=shardings)
