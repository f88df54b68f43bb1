#!/usr/bin/env python3
"""chip_smoke.py's LM and model-family phases alone, on one GPU.

    python3 scripts/lm_phases.py [--attention | --train | --families |
                                  --mesh | --dryrun]

Run from the repository root. It builds the CUDA kernels, prints
flash_attention's ptxas report, then runs chip_smoke.py's phases 9-11
(flash_attention against its plain version and timed at llama3-8b's,
gemma3-27b's and kimi-k2's shapes; llama3-8b prefill and serving),
16-18 (gemma3-27b, deepseek-v2-lite-16b and kimi-k2-1t-a32b prefill and
serving at full width) and 20-21 (llama3-8b and deepseek-v2-lite-16b
training at full width, and the card against the CPU), with TF32 off as
the smoke sets it, and prints flash_attention's records. With
``--attention`` it runs phase 9 alone (flash_attention against its plain
version and timed beside SDPA at the three models' shapes), with
``--train`` phases 20-21 alone, with ``--families`` phases 22-23
alone (the recsys and GNN families at full width, and the SASRec ->
Seismic bridge, which launches summary_dot and gather_dot_cand), with
``--mesh`` phase 24 alone (the model-parallel code at full width, its
ranks gloo processes sharing the card, decode on the mesh included), with
``--dryrun`` phase 25 alone (the dry run on the fake production meshes,
and its predictions against the card; with ``--mesh``, both); with
``--profile`` it then
traces one of phase 20's train steps (llama3-8b, 4 layers, [4, 4096] in
4 microbatches, after a warm step) under ``torch.profiler`` and prints
the device time by kernel, grouped, and the device's busy share of the
step. Every check of those phases raises as it does in the smoke.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


# kernel-name fragments -> group, the first match wins
GROUPS = (("bf16 GEMM", ("bf16", "nvjet", "xmma_gemm_bf16", "s16816gemm")),
          ("float32 GEMM", ("sgemm", "gemm", "cutlass", "xmma")),
          ("softmax", ("softmax",)),
          ("reduce / norm", ("reduce", "norm")),
          ("copy / cat / index", ("copy", "cat", "index", "gather",
                                  "scatter", "embedding")),
          ("elementwise", ("elementwise", "vectorized", "unrolled")))


def profile_train_step(torch, dev, cs) -> None:
    """One phase-20 train step under ``torch.profiler``: device time by
    kernel group and the top kernels, and the device's busy share of the
    step's wall time (the kernels' summed time over it; kernels on one
    stream do not overlap)."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import llama3_8b
    from repro_torch.data.pipeline import lm_token_stream
    from repro_torch.models.transformer import lm
    from repro_torch.train import AdamWConfig, init_opt_state, make_train_step
    cfg = dataclasses.replace(llama3_8b.CONFIG, n_layers=cs.TRAIN_LAYERS)
    params = lm.init_params(cfg, seed=0, device=dev)
    opt = init_opt_state(params)
    step = make_train_step(lambda p, b: lm.loss_fn(p, b, cfg),
                           AdamWConfig(lr=cs.TRAIN_LR, warmup_steps=2),
                           microbatches=cs.TRAIN_MICRO)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(
        lm_token_stream(cfg.vocab, cs.TRAIN_BATCH, cs.TRAIN_SEQ)()).items()}
    params, opt, _ = step(params, opt, batch)            # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    groups: dict[str, float] = {}
    for e in kernels:
        name = e.key.lower()
        g = next((g for g, keys in GROUPS if any(k in name for k in keys)),
                 "other")
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
    cs.log(f"[profile] one train step, llama3-8b {cfg.n_layers} layers, "
           f"[{cs.TRAIN_BATCH}, {cs.TRAIN_SEQ}] in {cs.TRAIN_MICRO} "
           f"microbatches: wall {wall:.1f} ms, device {total:.1f} ms "
           f"(busy {total / wall:.3f}); by group: " + ", ".join(
               f"{g} {t:.1f} ms" for g, t in sorted(
                   groups.items(), key=lambda kv: -kv[1])))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        cs.log(f"  {e.self_device_time_total / 1e3:9.2f} ms  "
               f"{e.count:5d} x  {e.key[:110]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--attention", action="store_true",
                    help="phase 9 (flash_attention) alone")
    ap.add_argument("--train", action="store_true",
                    help="phases 20-21 (training) alone")
    ap.add_argument("--families", action="store_true",
                    help="phases 22-23 (recsys and GNN families) alone")
    ap.add_argument("--mesh", action="store_true",
                    help="phase 24 (model parallel on one card) alone")
    ap.add_argument("--dryrun", action="store_true",
                    help="phase 25 (the dry run) alone")
    ap.add_argument("--profile", action="store_true",
                    help="then trace one phase-20 train step")
    args = ap.parse_args()
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
    for line in reports.get("flash_attention", "").splitlines():
        if any(w in line for w in ("registers", "smem", "spill",
                                   "Compiling")):
            cs.log(f"  flash_attention: {line.strip()}")
    cs.log(f"build {time.perf_counter() - t0:.1f} s")
    smi = cs.nvidia_smi_name_power()
    if args.mesh or args.dryrun:
        if args.mesh:
            launches = cs.mesh_phase(torch, dev, argparse.Namespace(
                seed=0, n_docs=1 << 20), smi)
            cs.log("phase 24 launched "
                   f"{ {k: v for k, v in launches.items() if v} }")
            torch.cuda.empty_cache()
        if args.dryrun:
            cs.dryrun_phase(torch, dev, smi)
        cs.log(f"total {time.perf_counter() - t0:.1f} s")
        return 0
    if args.attention:
        records = cs.attention_phase(
            torch, dev, torch.Generator(device=dev).manual_seed(0))
        cs.log(json.dumps({"kernels": records}))
        cs.log(f"total {time.perf_counter() - t0:.1f} s")
        return 0
    if args.families:
        launches = cs.family_phases(torch, dev, 0, runtime, smi)
        cs.log("phases 22-23 launched "
               f"{ {k: v for k, v in launches.items() if v} }")
        cs.log(f"total {time.perf_counter() - t0:.1f} s")
        return 0
    if not args.train:
        records = cs.lm_phases(torch, dev, 0, runtime)
        torch.cuda.empty_cache()
        cs.lm_family_phases(torch, dev, 0, runtime, records)
        cs.log(json.dumps({"kernels": records}))
        torch.cuda.empty_cache()
    cs.train_phases(torch, dev, 0, smi)
    if args.profile:
        torch.cuda.empty_cache()
        profile_train_step(torch, dev, cs)
    cs.log(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
