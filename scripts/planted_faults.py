#!/usr/bin/env python3
"""Check that chip_smoke.py's flash_attention check rejects known faults.

    python3 scripts/planted_faults.py

Run from the repository root on a machine with one CUDA device and
``nvcc``. For each fault below the script copies ``chip_smoke.py`` and
``src/`` into a temporary directory (outside the checkout), plants the
fault in the copy's bf16 TMA + wgmma kernel, builds it there and runs
``chip_smoke.flash_check`` (phase 9's check, unchanged). Each fault must
raise; the script prints the check's message (rows beyond tolerance and
the worst element's share of its tolerance) and exits non-zero if a
fault passes.

* tile-skip: key tile 16 (keys 2048-2175) is left out in every block
  with more than 32 key tiles of 128, i.e. for q rows 4096 and up at the
  8192-token prefill shape;
* denominator: the softmax denominator is taken 1.1x too large in the
  same blocks.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNEL = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FAULTS = {
    "tile-skip": ("      if (kind != kEmpty) {",
                  "      if (kind != kEmpty && "
                  "!(n_tiles > 32 && it == 16)) {"),
    "denominator": ("      den[r] = l[r] == 0.f ? 1.f : l[r];",
                    "      den[r] = (l[r] == 0.f ? 1.f : l[r]) * "
                    "(n_tiles > 32 ? 1.1f : 1.f);"),
}
CHECK = """
import sys
import torch
sys.path.insert(0, "src")
import chip_smoke
from repro_torch.kernels import runtime
runtime.build_kernels(["flash_attention"])
dev = torch.device("cuda")
try:
    chip_smoke.flash_check(torch, dev,
                           torch.Generator(device=dev).manual_seed(0))
except AssertionError as e:
    print(f"rejected: {e}")
    sys.exit(0)
print("passed the check")
sys.exit(1)
"""


def main() -> int:
    failed = []
    for name, (old, new) in FAULTS.items():
        with tempfile.TemporaryDirectory(prefix=f"fault-{name}-") as tmp:
            work = Path(tmp)
            shutil.copy(ROOT / "chip_smoke.py", work)
            shutil.copytree(ROOT / "src", work / "src",
                            ignore=shutil.ignore_patterns("__pycache__"))
            kernel = work / KERNEL
            text = kernel.read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the line to change is not in "
                                   f"{KERNEL} exactly once")
            kernel.write_text(text.replace(old, new))
            r = subprocess.run([sys.executable, "-c", CHECK], cwd=work,
                               text=True, capture_output=True, timeout=900)
        last = (r.stdout.strip().splitlines() or [r.stderr[-2000:]])[-1]
        print(f"{name}: {last}", flush=True)
        if r.returncode != 0:
            failed.append(name)
    if failed:
        print(f"faults not rejected: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
