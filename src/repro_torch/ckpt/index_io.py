"""Save and load an index in the JAX package's ``ckpt`` layout.

Layout: ``<path>/index_<step:08d>/index.npz`` (named arrays) plus the
``seismic_index.json`` manifest (step, dim, config, optional tuned
operating points as ``dataclasses.asdict`` of each
:class:`repro_torch.tune.TunedPolicy`, as the JAX package writes
them). Loading goes through
:func:`repro_torch.core.types.index_from_arrays`, so an index the JAX
package saved loads here, and one saved here loads in the JAX package
(except a bfloat16 forward plane: see :func:`save_index`).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np
import torch

from repro_torch.core.types import SeismicIndex, index_from_arrays
from repro_torch.tune.policy import TunedPolicy

_INDEX_MANIFEST = "seismic_index.json"


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as the array ``np.savez`` gets from the JAX package: a
    bfloat16 tensor as 2-byte void items (``|V2``, which is how
    ``np.savez`` stores an ``ml_dtypes.bfloat16`` array), a uint16 one
    through its int16 bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    if t.dtype == torch.uint16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save_index(path: str, index: SeismicIndex, *, step: int = 0) -> str:
    """Persist an index atomically (named-field npz + config JSON) and
    return the committed directory. Optional planes (compact forward
    index, superblock tier, kNN graph, mutation tail and tombstones) are
    stored only when present; tuned operating points ride the manifest.

    The JAX package's ``load_index`` cannot read back a bfloat16 forward
    plane (``jnp.asarray`` rejects the ``|V2`` items that ``np.savez``
    writes for it); this package's :func:`load_index` reads it bitwise.

    The commit is atomic: the arrays go to ``.tmp``, an existing step is
    moved aside to ``.old``, then ``.tmp`` is renamed, so a crash at any
    point leaves the old or the new step committed (the loader never
    reads ``.tmp`` or ``.old``)."""
    final = os.path.join(path, f"index_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays = dict(fwd_coords=_numpy(index.fwd.coords),
                  fwd_vals=_numpy(index.fwd.vals))
    for name, t in index._tensor_fields().items():
        if t is not None:
            arrays[name] = _numpy(t)
    np.savez(os.path.join(tmp, "index.npz"), **arrays)
    manifest = dict(step=step, dim=index.dim,
                    config=dataclasses.asdict(index.config))
    if index.tuned:
        manifest["tuned"] = [dataclasses.asdict(t) for t in index.tuned]
    with open(os.path.join(tmp, _INDEX_MANIFEST), "w") as f:
        json.dump(manifest, f)
    old = final + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(final):
        os.rename(final, old)
    os.rename(tmp, final)           # atomic commit
    shutil.rmtree(old, ignore_errors=True)
    return final


def load_index(path: str, *, step: int | None = None,
               device=None) -> SeismicIndex:
    """Restore the newest (or the given) committed index step under
    ``path``. ``.tmp``/``.old`` directories are never read. Tuned
    operating points come back as a tuple of ``TunedPolicy`` (unknown
    manifest keys are ignored, as the JAX loader does)."""
    if step is None:
        steps = [int(d.split("_")[1]) for d in os.listdir(path)
                 if d.startswith("index_") and d.split("_")[1].isdigit()]
        if not steps:
            raise FileNotFoundError(f"no committed index under {path}")
        step = max(steps)
    d = os.path.join(path, f"index_{step:08d}")
    with open(os.path.join(d, _INDEX_MANIFEST)) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "index.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    known = {f.name for f in dataclasses.fields(TunedPolicy)}
    tuned = tuple(TunedPolicy(**{k: v for k, v in t.items() if k in known})
                  for t in manifest.get("tuned", ()))
    return index_from_arrays(arrays, manifest["dim"], manifest["config"],
                             device=device, tuned=tuned)
