#!/usr/bin/env python3
"""chip_smoke.py's LM phases alone, on one GPU.

    python3 scripts/lm_phases.py

Run from the repository root. It builds the CUDA kernels, prints
flash_attention's ptxas report, then runs chip_smoke.py's phases 9-11
(flash_attention against its plain version and timed at llama3-8b's,
gemma3-27b's and kimi-k2's shapes; llama3-8b prefill and serving) and
16-18 (gemma3-27b, deepseek-v2-lite-16b and kimi-k2-1t-a32b prefill and
serving at full width), with TF32 off as the smoke sets it, and prints
flash_attention's records. Every check of those phases raises as it does
in the smoke. About two minutes, against the whole smoke's eight.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("lm_phases: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(Path.cwd() / "src"), str(Path.cwd())]
    import chip_smoke as cs
    from repro_torch.kernels import runtime
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs.log(f"{torch.cuda.get_device_name(0)}; nvidia-smi: "
           f"{cs.nvidia_smi_name_power()}; torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    reports = runtime.build_kernels()
    for line in reports["flash_attention"].splitlines():
        if any(w in line for w in ("registers", "smem", "spill",
                                   "Compiling")):
            cs.log(f"  flash_attention: {line.strip()}")
    cs.log(f"build {time.perf_counter() - t0:.1f} s")
    records = cs.lm_phases(torch, dev, 0, runtime)
    torch.cuda.empty_cache()
    cs.lm_family_phases(torch, dev, 0, runtime, records)
    cs.log(json.dumps({"kernels": records}))
    cs.log(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
