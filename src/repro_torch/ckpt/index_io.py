"""Read an index saved by the JAX package's ``ckpt.save_index``.

Layout: ``<path>/index_<step:08d>/index.npz`` (named arrays) plus the
``seismic_index.json`` manifest (step, dim, config, optional tuned
operating points). The arrays go through
:func:`repro_torch.core.types.index_from_arrays`.
"""
from __future__ import annotations

import json
import os

import numpy as np

from repro_torch.core.types import SeismicIndex, index_from_arrays

_INDEX_MANIFEST = "seismic_index.json"


def load_index(path: str, *, step: int | None = None,
               device=None) -> SeismicIndex:
    """Restore the newest (or the given) committed index step under
    ``path``. ``.tmp``/``.old`` directories are never read."""
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
    tuned = tuple(manifest.get("tuned", ()))
    return index_from_arrays(arrays, manifest["dim"], manifest["config"],
                             device=device, tuned=tuned)
