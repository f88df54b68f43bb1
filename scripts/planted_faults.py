#!/usr/bin/env python3
"""Check that chip_smoke.py's kernel checks reject known faults.

    python3 scripts/planted_faults.py [FAULT ...]

Run from the repository root on a machine with one CUDA device and
``nvcc``. For each fault below the script copies ``chip_smoke.py`` and
``src/`` into a temporary directory (outside the checkout), plants the
fault in the copy's kernel source, builds it there and runs the smoke's
check of that kernel, unchanged: phase 9's ``chip_smoke.flash_check``
for flash_attention, phase 3 (``synthetic_phase``,
``fused_synthetic_phase`` and ``block_cand_synthetic``) for the
retrieval kernels. Each fault must raise; the script prints the check's
message (which check, and by how much: elements or positions beyond
tolerance, the worst error) and exits non-zero if a fault passes. Names
given on the command line plant only those faults.

* tile-skip: flash_attention leaves key tile 16 (keys 2048-2175) out in
  every block with more than 32 key tiles of 128, i.e. for q rows 4096
  and up at the 8192-token prefill shape;
* denominator: flash_attention takes the softmax denominator 1.1x too
  large in the same blocks;
* bitmap-last-word: summary_dot's q bitmap leaves its last partial word
  (coordinates 30496-30521 at d = 30522) unset, so those lookups read
  +0.0;
* tie-order: router_hier's top-m breaks stage-A score ties by the higher
  index (lax.top_k takes the lower);
* group-drops-last: router_flat's consumers store the scores of every
  query of a group but the last, whose rows keep whatever the output
  buffer held;
* dedupe-neighbour: refine_round's dedupe compares an id with the id two
  places to its left, not one, so some duplicate neighbours stay in the
  frontier;
* block-dedupe-neighbour: the same fault in refine_round's block route
  (more than 512 candidates a query), which marks duplicates in shared
  memory;
* block-sort-stride-2: the block route's sort skips its register steps
  of stride 2, so its ids are not sorted;
* block-scan-inclusive: the block route's compaction writes each live id
  one place to the right of its count (the ballot's prefix taken
  inclusive of the lane).

The last three are planted in ``common/csrc/block_sort.cuh``, which the
block route shares with block_cand; the block route's check, which
runs first, rejects them.

* block-cand-score-mask: block_cand masks only the blocks whose score is
  NaN, so a block scored -inf or +inf gives its ids;
* block-cand-length: block_cand gathers one slot past each block's
  length (the next block's first id, or one clipped into the list);
* block-cand-tombstone: block_cand reads the tombstone of the id one
  above each id.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = "src/repro_torch/kernels"
FLASH = f"{KERNELS}/flash_attention/csrc/flash_attention.cu"
# the block route's sort, duplicate marks and scan, shared with block_cand
BLOCK_SORT = f"{KERNELS}/common/csrc/block_sort.cuh"
BLOCK_CAND = f"{KERNELS}/block_cand/csrc/block_cand.cu"
# fault: (source, line to replace, replacement, check)
FAULTS = {
    "tile-skip": (FLASH, "      if (kind != kEmpty) {",
                  "      if (kind != kEmpty && "
                  "!(n_tiles > 32 && it == 16)) {", "flash"),
    "denominator": (FLASH, "      den[r] = l[r] == 0.f ? 1.f : l[r];",
                    "      den[r] = (l[r] == 0.f ? 1.f : l[r]) * "
                    "(n_tiles > 32 ? 1.1f : 1.f);", "flash"),
    "bitmap-last-word": (
        f"{KERNELS}/summary_dot/csrc/summary_dot.cu",
        "lane, [&](int w, uint32_t m) { bits[w] = m; });",
        "lane, [&](int w, uint32_t m) { bits[w] = (w + 1) * 32 <= d ? m "
        ": 0u; });", "phase3"),
    "tie-order": (f"{KERNELS}/router_fused/csrc/router_fused.cu",
                  "  return sa > sb || (sa == sb && ia < ib);",
                  "  return sa > sb || (sa == sb && ia > ib);", "phase3"),
    "group-drops-last": (
        f"{KERNELS}/router_fused/csrc/router_fused.cu",
        "  const bool mine = (lane & (32 / V - 1)) == 0 && gq < n;",
        "  const bool mine = (lane & (32 / V - 1)) == 0 && gq + 1 < n;",
        "phase3"),
    "dedupe-neighbour": (
        f"{KERNELS}/refine_fused/csrc/refine_fused.cu",
        "      const int prev = e ? key[e - 1] : left;",
        "      const int prev = e > 1 ? key[e - 2] : left;", "phase3"),
    "block-dedupe-neighbour": (
        BLOCK_SORT,
        "        0xffffffffu, t > 0 && t < n_cand && key[t] == key[t - 1]);",
        "        0xffffffffu, t > 1 && t < n_cand && key[t] == key[t - 2]);",
        "phase3"),
    "block-sort-stride-2": (
        BLOCK_SORT,
        "  for (int j = jtop; j > 1; j >>= 1) {",
        "  for (int j = jtop; j > 2; j >>= 1) {", "phase3"),
    "block-scan-inclusive": (
        BLOCK_SORT,
        "__popc(ballot & ((1u << lane) - 1u))",
        "__popc(ballot & ((2u << lane) - 1u))", "phase3"),
    "block-cand-score-mask": (
        BLOCK_CAND,
        "                      isfinite(scores[qi * scores_stride + b]);",
        "                      !isnan(scores[qi * scores_stride + b]);",
        "phase3"),
    "block-cand-length": (
        BLOCK_CAND, "      if (j < b_len[r]) {", "      if (j <= b_len[r]) {",
        "phase3"),
    "block-cand-tombstone": (
        BLOCK_CAND,
        "tombstone[max(0, min(v, n_tomb - 1))])",
        "tombstone[max(0, min(v + 1, n_tomb - 1))])", "phase3"),
}
CHECKS = {
    "flash": ("['flash_attention']",
              "chip_smoke.flash_check(torch, dev, gen)"),
    "phase3": ("['summary_dot', 'gather_dot', 'router_fused', "
               "'refine_fused', 'block_cand']",
               "chip_smoke.synthetic_phase(torch, dev, gen)\n"
               "    chip_smoke.fused_synthetic_phase(torch, dev, gen)\n"
               "    chip_smoke.block_cand_synthetic(torch, dev, gen)"),
}
CHECK = """
import sys
import torch
sys.path.insert(0, "src")
import chip_smoke
from repro_torch.kernels import runtime
runtime.build_kernels({build})
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
try:
    {check}
except AssertionError as e:
    print(f"rejected: {{e}}")
    sys.exit(0)
print("passed the check")
sys.exit(1)
"""


def main() -> int:
    names = sys.argv[1:] or list(FAULTS)
    unknown = sorted(set(names) - set(FAULTS))
    if unknown:
        raise SystemExit(f"unknown faults {unknown}; known: {list(FAULTS)}")
    failed = []
    for name in names:
        source, old, new, check = FAULTS[name]
        with tempfile.TemporaryDirectory(prefix=f"fault-{name}-") as tmp:
            work = Path(tmp)
            shutil.copy(ROOT / "chip_smoke.py", work)
            shutil.copytree(ROOT / "src", work / "src",
                            ignore=shutil.ignore_patterns("__pycache__"))
            kernel = work / source
            text = kernel.read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the line to change is not in "
                                   f"{source} exactly once")
            kernel.write_text(text.replace(old, new))
            build, call = CHECKS[check]
            r = subprocess.run(
                [sys.executable, "-c", CHECK.format(build=build, check=call)],
                cwd=work, text=True, capture_output=True, timeout=900)
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
