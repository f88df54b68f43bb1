"""Training launcher of the LM (port of ``repro/launch/train.py``): the
bundle's parameters drawn on the device, AdamW through the microbatched
train step, the prefetching token stream, and checkpoints (async,
keep-last-2, ``--resume``) in the JAX package's layout, so either
package resumes the other's run.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --batch 8 --seq 64 --steps 50 --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
      --devices 4 --model-parallel 2 --device cpu
  torchrun --nproc-per-node 8 -m repro_torch.launch.train --model-parallel 8

On a mesh, as the JAX launcher: a ``(n / mp, mp)`` mesh of ("data",
"model") (``make_mesh_for``), the parameters cut by
``bundle.param_specs``, the optimizer state by ZeRO-1 over "data", the
global batch placed over "data" by the model, and a resume that re-cuts
the checkpoint for this mesh (``shardings=``). Each leaf keeps its spec
from step to step. ``--devices N`` keeps the JAX flag's meaning ("force
host device count", testing only): the launcher starts N ranks of itself
on this host, all on the ``--device`` given, over gloo (exchanges through
host memory). Under ``torchrun`` each rank takes its own card and NCCL
(``--device cpu``: gloo); fewer cards than ranks raises. The backend is
printed; the launcher never switches backends on its own.
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
                    help="force host device count (testing only): N ranks "
                         "on this host sharing --device over gloo")
    ap.add_argument("--model-parallel", type=int, default=0,
                    help="TP width; default = 1 (reduced) / 16 (full)")
    from repro_torch.launch.mesh import rank_args
    rank_args(ap)
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


def _sharded_state(cfg, params, opt, mesh) -> tuple[dict, dict]:
    """(the like tree of full shapes on the meta device, the shardings
    tree of ``(mesh, spec)`` pairs) of ``state_tree``'s layout."""
    import torch

    from repro_torch.distributed.param_sharding import (jax_layout_specs,
                                                        lm_param_specs)
    from repro_torch.distributed.sharding import PartitionSpec, spec_of
    from repro_torch.models.transformer import lm
    meta = lm.LM(cfg, torch.device("meta"))
    full = dict(meta.named_parameters())
    f32 = {k: torch.empty(p.shape, dtype=torch.float32, device="meta")
           for k, p in full.items()}
    step = torch.empty((), dtype=torch.int32, device="meta")
    like = dict(params=lm.to_jax_layout(full),
                opt=dict(m=lm.to_jax_layout(f32), v=lm.to_jax_layout(f32),
                         step=step))

    def pairs(specs):
        tree = jax_layout_specs(specs)

        def walk(node):
            return {k: walk(v) for k, v in node.items()} \
                if isinstance(node, dict) else (mesh, node)
        return walk(tree)

    pspecs = lm_param_specs(params, cfg.sharding_mode)
    shardings = dict(params=pairs(pspecs),
                     opt=dict(m=pairs({k: spec_of(t) for k, t in
                                       opt["m"].items()}),
                              v=pairs({k: spec_of(t) for k, t in
                                       opt["v"].items()}),
                              step=(mesh, PartitionSpec())))
    return like, shardings


def main(argv=None) -> dict:
    """Run the launcher; returns the last step's metrics (floats) and
    the step it resumed from (rank 0's, on a mesh)."""
    args = parse_args(argv)
    from repro_torch.launch.mesh import (join_ranks, join_torchrun,
                                         run_as_ranks, under_torchrun)
    if args.devices and args.rank is None:
        return run_as_ranks("repro_torch.launch.train",
                            list(argv if argv is not None else
                                 __import__("sys").argv[1:]), args.devices)
    import torch
    import torch.distributed as dist

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.data.pipeline import PrefetchLoader, lm_token_stream
    from repro_torch.device import resolve_device
    from repro_torch.distributed.sharding import set_mesh
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models.api import get_bundle
    from repro_torch.models.transformer import parallel
    from repro_torch.train import AdamWConfig, init_opt_state, make_train_step

    mesh = None
    if args.rank is not None:
        dev = join_ranks(args.rank, args.world, args.port, args.device)
    elif under_torchrun():
        dev = join_torchrun(args.device)
    else:
        dev = resolve_device(args.device)
        if args.model_parallel > 1:
            raise ValueError("--model-parallel > 1 needs ranks: --devices N "
                             "or torchrun")
    bundle = get_bundle(args.arch)
    cfg = bundle.reduced if args.reduced else bundle.config
    dims = dict(global_batch=args.batch, seq_len=args.seq)
    rank0 = True
    if dist.is_initialized():
        n = dist.get_world_size()
        tp = args.model_parallel or (1 if args.reduced else min(16, n))
        mesh = make_mesh_for(n, model_parallel=tp)
        rank0 = dist.get_rank() == 0
        if rank0:
            print(f"mesh={dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))} "
                  f"arch={cfg.name} backend={dist.get_backend()} "
                  f"device={dev}", flush=True)
    else:
        print(f"device={dev} arch={cfg.name}")

    with set_mesh(mesh):
        params = bundle.init(0, cfg, dims, device=dev, mesh=mesh)
        opt = init_opt_state(params, zero=mesh is not None)
        opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=10,
                              total_steps=args.steps)
        step_fn = make_train_step(
            bundle.step(cfg, dims, "train"), opt_cfg,
            microbatches=args.microbatches,
            grad_axes=parallel.batch_axes(cfg) if mesh is not None else None)
        like, shardings = (_sharded_state(cfg, params, opt, mesh)
                           if mesh is not None else (None, None))

        mgr = CheckpointManager(args.ckpt_dir, keep=2)
        start = 0
        if args.resume:
            try:
                # shapes and dtypes from meta tensors; the leaves land on
                # the host and go into the parameters on the device one by
                # one (on a mesh, each rank's slices)
                restored, start = mgr.restore_latest(
                    like if like is not None else
                    state_tree(params, opt, device="meta"), device="cpu",
                    shardings=shardings)
                load_state(restored, params, opt)
                del restored
                if rank0:
                    print(f"resumed from step {start}")
            except FileNotFoundError:
                if rank0:
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
            if step % 10 == 0 and rank0:
                print(f"step {step:5d}  loss={float(metrics['loss']):.4f}  "
                      f"{(time.time()-t0)/(i+1)*1000:.0f} ms/step")
            if step > 0 and step % args.ckpt_every == 0:
                mgr.save_async(step, state_tree(params, opt),
                               shardings=shardings)
        loader.close()
        mgr.save_async(start + args.steps, state_tree(params, opt),
                       shardings=shardings)
        mgr.wait()
    if rank0:
        print("done", flush=True)
    out = dict({k: float(v) for k, v in metrics.items()}, start=start)
    if args.result is not None and rank0:
        torch.save(out, args.result)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
