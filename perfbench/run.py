"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1> [--control | --fault <name>]

From the root of a checkout. Exits with 3, printing no result, without a
CUDA device or with fewer than the cell asks for; with 4 if a module of
JAX or of the JAX package is loaded once the window has closed. The last
line of standard output is the JSON result; the last lines of standard
error are the numbers the correctness check compared, each with its
limit. ``--control`` runs the program's lower-precision path (the
configuration's ``control``) and ``--fault <name>`` plants
``perfbench/faults/<name>.py`` under the timed path: the check has to
refuse both, and the benchmark's own runs pass neither.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    how = ap.add_mutually_exclusive_group()
    how.add_argument("--control", action="store_true")
    how.add_argument("--fault")
    args = ap.parse_args(argv)

    # the program's caches stay inside the checkout, at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from perfbench import devtrace, harness
    cell = harness.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s), found {n}", file=sys.stderr)
        return 3
    line = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            t_start=T_START, control=args.control,
                            fault=args.fault)
    line["notes"]["card"] = devtrace.card_state()
    line["checks"] = line.pop("checks")      # the compared numbers last
    found = forbidden_modules()
    if found:
        print(f"perfbench: loaded in this process: {found}", file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        bound = "at most" if c["rule"] == "max" else "at least"
        print(f"check {name}: {c['value']!r} (limit: {bound} "
              f"{c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
