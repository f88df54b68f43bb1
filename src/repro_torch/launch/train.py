"""Training launcher of the LM on one device (port of
``repro/launch/train.py``): the bundle's parameters drawn on the device,
AdamW through the microbatched train step, the prefetching token stream,
and checkpoints (async, keep-last-2, ``--resume``) in the JAX package's
layout, so either package resumes the other's run.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --batch 8 --seq 64 --steps 50 --reduced --device cpu

The JAX launcher's mesh (``--devices``, ``--model-parallel``) needs the
port of ``distributed/`` (ROADMAP Queue 1, item 5): those flags raise.
"""
from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join("build", "train_ckpt"),
                    help="relative to the working directory")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for tests)")
    ap.add_argument("--devices", type=int, default=0,
                    help="a mesh of N devices: not ported (raises)")
    ap.add_argument("--model-parallel", type=int, default=0,
                    help="TP width: only 1 is ported")
    return ap.parse_args(argv)


def state_tree(params, opt_state: dict, *, device=None) -> dict:
    """``dict(params=..., opt=dict(m=..., v=..., step=...))`` in the JAX
    package's layout (``lm.to_jax_layout``): what its launcher
    checkpoints. ``device`` is where the restacked leaves are built."""
    from repro_torch.models.transformer import lm
    return dict(params=lm.to_jax_layout(dict(params.named_parameters()),
                                        device=device),
                opt=dict(m=lm.to_jax_layout(opt_state["m"], device=device),
                         v=lm.to_jax_layout(opt_state["v"], device=device),
                         step=opt_state["step"]))


def load_state(tree: dict, params, opt_state: dict) -> None:
    """Copy a ``state_tree``-shaped tree (as ``load_checkpoint`` returns
    it) into the parameters and the optimizer state, in place."""
    from repro_torch.models.transformer import lm
    lm.load_jax_layout(tree["params"], dict(params.named_parameters()))
    lm.load_jax_layout(tree["opt"]["m"], opt_state["m"])
    lm.load_jax_layout(tree["opt"]["v"], opt_state["v"])
    opt_state["step"] = tree["opt"]["step"].to(opt_state["step"].device)


def main(argv=None) -> dict:
    """Run the launcher; returns the last step's metrics (floats) and
    the step it resumed from."""
    args = parse_args(argv)
    if args.devices or args.model_parallel > 1:
        raise NotImplementedError(
            "--devices / --model-parallel > 1 need the port of "
            "distributed/ and launch/mesh.py (ROADMAP Queue 1, item 5); "
            "this launcher trains on one device")
    import torch

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.data.pipeline import PrefetchLoader, lm_token_stream
    from repro_torch.device import resolve_device
    from repro_torch.models.api import get_bundle
    from repro_torch.train import AdamWConfig, init_opt_state, make_train_step

    dev = resolve_device(args.device)
    bundle = get_bundle(args.arch)
    cfg = bundle.reduced if args.reduced else bundle.config
    dims = dict(global_batch=args.batch, seq_len=args.seq)
    print(f"device={dev} arch={cfg.name}")

    params = bundle.init(0, cfg, dims, device=dev)
    opt = init_opt_state(params)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)
    step_fn = make_train_step(bundle.step(cfg, dims, "train"), opt_cfg,
                              microbatches=args.microbatches)

    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    start = 0
    if args.resume:
        try:
            # shapes and dtypes from meta tensors; the leaves land on the
            # host and go into the parameters on the device one by one
            restored, start = mgr.restore_latest(
                state_tree(params, opt, device="meta"), device="cpu")
            load_state(restored, params, opt)
            del restored
            print(f"resumed from step {start}")
        except FileNotFoundError:
            print("no checkpoint; fresh start")

    loader = PrefetchLoader(
        lm_token_stream(cfg.vocab, args.batch, args.seq, seed=start),
        prefetch=4)
    metrics: dict = {}
    t0 = time.time()
    for i, batch in enumerate(loader):
        if i >= args.steps:
            break
        step = start + i
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        params, opt, metrics = step_fn(params, opt, batch)
        if step % 10 == 0:
            print(f"step {step:5d}  loss={float(metrics['loss']):.4f}  "
                  f"{(time.time()-t0)/(i+1)*1000:.0f} ms/step")
        if step > 0 and step % args.ckpt_every == 0:
            mgr.save_async(step, state_tree(params, opt))
    loader.close()
    mgr.save_async(start + args.steps, state_tree(params, opt))
    mgr.wait()
    print("done")
    return dict({k: float(v) for k, v in metrics.items()}, start=start)


if __name__ == "__main__":
    main()
