"""Multi-pod dry run (port of ``repro/launch/dryrun.py``): trace every
(architecture x input-shape x mesh) cell on the production meshes and
record its roofline inputs, without a GPU.

The JAX package lowers and compiles each cell on 256 (or 512) forced host
devices and reads XLA's memory analysis, cost analysis and HLO. The
port's SPMD program is explicit, so its analog runs rank 0's program:
a "fake" process group of 256 (or 512) ranks (torch's
``FakeProcessGroup``: this process is rank 0 of a world it does not
start) carries the production mesh, every tensor is a ``meta`` tensor
(shapes and dtypes, no memory), and ``collectives.dry_run()`` lets the
collectives run on it, shapes only. Per cell it records:

  * memory: ``argument_bytes`` (the rank's parameters, optimizer state,
    batch and cache, from the spec trees), ``output_bytes`` (the step's
    outputs, those written in place included), ``alias_bytes`` (the
    donated arguments: train donates parameters and optimizer state,
    decode the cache), ``temp_bytes`` (the tracked peak of the step's
    live storage, less its new outputs: ``hlo_analysis.StepTrace``, a
    dispatch-mode tracker of storage bytes) and ``peak_est`` = argument
    + output + temp - alias;
  * cost: the dot flops a device (counted at dispatch over the whole
    depth, ``flops_source`` "dispatch-count"; Seismic's are analytic)
    and the HBM traffic argument + output + 2 * temp, the JAX package's
    convention;
  * collective bytes from ``collectives.recording()``
    (``hlo_analysis.collective_bytes``);
  * the roofline terms (``distributed.roofline``, the H100's constants).

``probe`` is None: the JAX package's probe lowers a few layers unrolled
and extrapolates because XLA:CPU's cost analysis skips ``while`` bodies;
the port runs every layer eagerly, so its counts cover the whole depth.

The Seismic cell is not traced: its search compacts candidates to
data-dependent shapes, which ``meta`` tensors cannot run. It keeps the
JAX package's analytic flops and bytes with the per-shard ``lam`` /
``beta`` scaling, and the index planes' bytes as ``argument_bytes``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--jobs 4]

Records land in build/dryrun/<arch>__<shape>__<mesh>.json; the module
sets no XLA flag and imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import types

import torch

from repro_torch.configs.base import get_arch, list_archs
from repro_torch.distributed import collectives as C
from repro_torch.distributed.hlo_analysis import (StepTrace, collective_bytes,
                                                  dot_flops, shape_bytes)
from repro_torch.distributed.roofline import (Roofline, model_flops_infer,
                                              model_flops_train)
from repro_torch.distributed.sharding import (PartitionSpec as P, axes_size,
                                              entry_axes, set_mesh)
from repro_torch.models.api import get_bundle

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun")
META = torch.device("meta")


def fake_world(world: int) -> None:
    """Make this process rank 0 of a fake process group of ``world``
    ranks (replacing a fake group of another size). Raises if a real
    process group is up."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs its own process: a "
                               f"{dist.get_backend()} group is up")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def production_mesh(multi_pod: bool):
    """``launch.mesh.make_production_mesh`` on a fake world of its size."""
    from repro_torch.launch.mesh import make_production_mesh
    fake_world(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod)


def _mesh_shape(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.mesh.shape)))


def _dp(mesh) -> tuple:
    names = tuple(mesh.mesh_dim_names) if mesh is not None else ()
    return tuple(a for a in ("pod", "data") if a in names)


def input_specs(arch_id: str, shape_name: str):
    """The batch's ``Spec`` (shape, dtype) of every model input of a cell,
    and the cell."""
    bundle = get_bundle(arch_id)
    cell = next(c for c in bundle.shapes if c.name == shape_name)
    return bundle.batch_specs(bundle.config, cell.dims, cell.kind), cell


def _meta(specs: dict) -> dict:
    return {k: torch.empty(s.shape, dtype=s.dtype, device=META)
            for k, s in specs.items()}


def _nbytes(tensors) -> int:
    return sum(shape_bytes(t.dtype, t.shape) for t in tensors)


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return []


# ------------------------------------------------------------ traced cells

def batch_partition(bundle, specs: dict, kind: str, mesh) -> dict:
    """The JAX dry run's PartitionSpec of each batch entry: an LM's
    tokens (and labels) over the data axes (a decode batch that does not
    divide, and ``pos``, replicated); a GNN's edges over every axis;
    recsys candidates over every axis, other entries with rows over the
    data axes. Off a mesh everything is replicated."""
    if mesh is None:
        return {k: P() for k in specs}
    dp = _dp(mesh)
    if bundle.family == "lm":
        if kind == "decode":
            b = specs["tokens"].shape[0]
            split = b % axes_size(dp, mesh) == 0
            return dict(tokens=P(dp, None) if split else P(), pos=P())
        return {k: P(dp, None) for k in specs}
    every = tuple(mesh.mesh_dim_names)
    if bundle.family == "gnn":
        return {k: P(every) if k == "edges" else P() for k in specs}
    return {k: P(every) if k == "cand" else
            P(dp) if s.shape and s.shape[0] > 1 else P()
            for k, s in specs.items()}


def batch_bytes(specs: dict, parts: dict, mesh) -> int:
    """Bytes of this rank's share of the batch: each entry's dims cut
    over its spec's axes (rounded up, as an uneven shard is padded)."""
    total = 0
    for k, s in specs.items():
        shape = list(s.shape)
        for i, entry in enumerate(parts[k]):
            shape[i] = -(-shape[i] // axes_size(entry_axes(entry), mesh))
        total += shape_bytes(s.dtype, shape)
    return total


def trace_step(run, state, batch, donated, batch_nbytes: int) -> dict:
    """Run ``run()`` (a step on meta tensors: ``state`` the parameters,
    optimizer state and cache, ``batch`` its inputs) under a
    :class:`StepTrace` and ``collectives.recording``; ``donated`` are the
    arguments its outputs are written into, ``batch_nbytes`` the rank's
    share of the batch. -> dict(memory, dots, records, ops, seconds)."""
    state_t, batch_t = _leaves(state), _leaves(batch)
    t0 = time.perf_counter()
    with C.dry_run(), C.recording() as records, StepTrace() as trace:
        trace.exclude(state_t + batch_t)
        out = run()
    seconds = time.perf_counter() - t0
    known = {t.untyped_storage()._cdata for t in state_t + batch_t}
    new_out = [t for t in _leaves(out)
               if t.untyped_storage()._cdata not in known]
    alias = _nbytes(_leaves(donated))
    new_bytes = _nbytes(new_out)
    arg = _nbytes(state_t) + batch_nbytes
    output = alias + new_bytes
    temp = max(0, trace.peak_bytes - new_bytes)
    memory = dict(argument_bytes=arg, output_bytes=output, temp_bytes=temp,
                  alias_bytes=alias, peak_est=arg + output + temp - alias)
    return dict(memory=memory, dots=dot_flops(trace), records=list(records),
                ops=sum(trace.ops.values()), seconds=seconds)


def cell_step(bundle, cfg, kind: str, dims: dict, mesh, *,
              microbatches: int = 1, device=META, batch=None):
    """(run, state, batch, donated) of a cell on ``mesh`` (or one device):
    ``run()`` runs its step on ``state`` (the parameters, the rank's
    slices, with the optimizer state or cache) and ``batch``, and writes
    into ``donated``. Everything is on the meta device unless ``device``
    and a real ``batch`` (``bundle.make_batch``'s) are given: the same
    step on a card, for checks."""
    if bundle.family == "lm":
        return lm_step(bundle, cfg, kind, dims, mesh, device, batch,
                       microbatches=microbatches)
    return generic_step(bundle, cfg, kind, dims, mesh, device, batch)


def lm_step(bundle, cfg, kind: str, dims: dict, mesh, device, batch, *,
            microbatches: int = 1):
    """``cell_step`` of an LM. Train: AdamW with ZeRO-1 moments over the
    data axes and the cell's microbatches; prefill: the forward; decode:
    one step at the last position of a cache laid out by
    ``cache_specs``."""
    from repro_torch.models.transformer import lm, parallel
    from repro_torch.train import AdamWConfig, init_opt_state, make_train_step
    params = bundle.init(0, cfg, dims, device=device, mesh=mesh)
    batch = _meta(bundle.batch_specs(cfg, dims, kind)) if batch is None \
        else dict(batch)
    if kind == "train":
        opt = init_opt_state(params, zero=True)
        step = make_train_step(bundle.step(cfg, dims, "train"), AdamWConfig(),
                               microbatches=microbatches,
                               grad_axes=parallel.batch_axes(cfg))
        return (lambda: step(params, opt, batch)), (params, opt), batch, \
            (params, opt)
    if kind == "prefill":
        fwd = bundle.step(cfg, dims, "prefill")
        return (lambda: fwd(params, batch)), params, batch, ()
    batch["pos"] = dims["seq_len"] - 1
    cache = lm.init_cache(cfg, dims["global_batch"], dims["seq_len"],
                          device=device)
    if mesh is not None:
        cache = parallel.shard_cache(cache)
    dec = bundle.step(cfg, dims, "decode")
    return (lambda: dec(params, cache, batch)), (params, cache), batch, \
        cache


def generic_step(bundle, cfg, kind: str, dims: dict, mesh, device, batch):
    """``cell_step`` of a GNN or recsys cell: the global batch (the model
    code cuts it on the mesh), AdamW moments shaped as the parameters (no
    ZeRO, as the JAX dry run)."""
    from repro_torch.train import AdamWConfig, init_opt_state, make_train_step
    params = bundle.init(0, cfg, dims, device=device, mesh=mesh)
    batch = _meta(bundle.batch_specs(cfg, dims, kind)) if batch is None \
        else dict(batch)
    if kind == "train":
        opt = init_opt_state(params)
        step = make_train_step(bundle.step(cfg, dims, "train"), AdamWConfig())
        return (lambda: step(params, opt, batch)), (params, opt), batch, \
            (params, opt)
    fn = bundle.step(cfg, dims, kind)
    return (lambda: fn(params, batch)), params, batch, ()


def trace_cell(bundle, cfg, kind: str, dims: dict, mesh, *,
               microbatches: int = 1) -> dict:
    """Trace one LM, GNN or recsys step of ``cfg`` at ``dims`` on ``mesh``
    (a DeviceMesh of a fake world, or None for one device) -> dict(memory,
    cost, collectives, dots, model_flops, ops, seconds). ``bundle``'s
    family picks the step."""
    mf = model_flops(cfg, kind, dims) if bundle.family == "lm" else 0.0
    with set_mesh(mesh):
        run, state, batch, donated = cell_step(bundle, cfg, kind, dims, mesh,
                                               microbatches=microbatches)
        specs = bundle.batch_specs(cfg, dims, kind)
        nbytes = batch_bytes(specs, batch_partition(bundle, specs, kind,
                                                    mesh), mesh)
        got = trace_step(run, state, batch, donated, nbytes)
    mem = got["memory"]
    hbm = float(mem["argument_bytes"] + mem["output_bytes"]
                + 2 * mem["temp_bytes"])
    sizes = _mesh_shape(mesh) if mesh is not None else {}
    return dict(memory=mem, cost=dict(flops=got["dots"]["dot_flops"],
                                      hbm_bytes=hbm),
                collectives=collective_bytes(got["records"], sizes),
                dots=got["dots"], model_flops=mf, ops=got["ops"],
                seconds=got["seconds"])


def model_flops(cfg, kind: str, dims: dict) -> float:
    """6ND (train) or 2ND (forward) of an LM cell over its global tokens,
    N the active parameters."""
    n_tok = dims["global_batch"] * (dims["seq_len"] if kind != "decode"
                                    else 1)
    if kind == "train":
        return model_flops_train(cfg.active_param_count(), n_tok)
    return model_flops_infer(cfg.active_param_count(), n_tok)


# ------------------------------------------------------------- seismic cell

def _seismic_override(mod, overrides: dict):
    cfg = dataclasses.replace(
        mod.CONFIG, index=dataclasses.replace(mod.CONFIG.index, **overrides))
    return types.SimpleNamespace(CONFIG=cfg, SHAPES=mod.SHAPES,
                                 REDUCED=mod.REDUCED)


def seismic_cell(mod, cell, mesh_shape: dict) -> dict:
    """The doc-sharded search cell, analytic (module docstring): the
    per-shard index (``lam`` / ``beta`` scaled by the shard count, docs
    over the doc axes, queries over "data") -> dict(memory, flops,
    bytes, n_shards)."""
    cfg = mod.CONFIG
    doc_axes = ("pod", "model") if "pod" in mesh_shape else ("model",)
    n_shards = math.prod(mesh_shape[a] for a in doc_axes)
    per = -(-cfg.n_docs // n_shards)
    icfg = dataclasses.replace(cfg.index, lam=max(64, cfg.index.lam // n_shards),
                               beta=max(8, cfg.index.beta // n_shards),
                               block_cap=cfg.index.block_cap)
    d, lam, nb, s = cfg.dim, icfg.lam, icfg.n_blocks, icfg.summary_nnz
    i32, f32, u8 = torch.int32, torch.float32, torch.uint8
    if icfg.fwd_quant:
        coord_dt, val_dt = (torch.uint16 if d < 65536 else i32), u8
        planes = [(coord_dt, (per, cfg.doc_nnz)), (val_dt, (per, cfg.doc_nnz)),
                  (f32, (per,)), (f32, (per,))]
    else:
        planes = [(i32, (per, cfg.doc_nnz)),
                  (getattr(torch, icfg.fwd_dtype), (per, cfg.doc_nnz))]
    planes += [(i32, (d, lam)), (f32, (d, lam)), (i32, (d,)),
               (i32, (d, nb)), (i32, (d, nb)), (i32, (d, nb, s)),
               (u8, (d, nb, s)), (f32, (d, nb)), (f32, (d, nb))]
    dims = cell.dims
    q_loc = dims["batch"] // mesh_shape["data"]
    queries = [(i32, (q_loc, cfg.query_nnz)), (f32, (q_loc, cfg.query_nnz))]
    outputs = [(f32, (q_loc, dims["k"])), (i32, (q_loc, dims["k"]))]
    # routing: cut lists x nb blocks x S entries; scoring: budget x cap
    # candidate docs x nnz
    cut, budget = dims["cut"], dims["block_budget"]
    per_query = cut * nb * s * 2 + budget * icfg.block_cap * cfg.doc_nnz * 2
    if icfg.fwd_quant:
        entry_b = (2 if d < 65536 else 4) + 1     # u16 coord + u8 value
        doc_extra = 8                              # per-doc scale + zero
    else:
        entry_b = 4 + getattr(torch, icfg.fwd_dtype).itemsize
        doc_extra = 0
    per_query_bytes = (cut * nb * s * 5                        # summaries
                       + budget * icfg.block_cap
                       * (cfg.doc_nnz * entry_b + doc_extra)   # fwd rows
                       + cfg.dim * 4 * 3)                      # q densify
    arg = sum(shape_bytes(dt, sh) for dt, sh in planes + queries)
    out = sum(shape_bytes(dt, sh) for dt, sh in outputs)
    memory = dict(argument_bytes=arg, output_bytes=out, temp_bytes=0,
                  alias_bytes=0, peak_est=arg + out)
    return dict(memory=memory, flops=float(q_loc * per_query),
                bytes=float(q_loc * per_query_bytes), n_shards=n_shards)


# ------------------------------------------------------------ entry points

def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool,
             opt_overrides=None, tag: str = "",
             microbatches: int = 1) -> dict:
    """The record of one cell on the production mesh (a dict with the
    JAX package's keys; ``probe`` None, module docstring); a skipped
    cell's ``skipped`` reason. ``opt_overrides`` replace fields of the
    cell's config (``sharding_mode="fsdp"``, or the Seismic index's)."""
    mod = get_arch(arch_id)
    cell = next(c for c in mod.SHAPES if c.name == shape_name)
    if cell.skip:
        return dict(arch=arch_id, shape=shape_name, skipped=cell.skip)
    mesh = production_mesh(multi_pod)
    shape = _mesh_shape(mesh)
    n_chips = math.prod(shape.values())
    t0 = time.perf_counter()
    if arch_id == "seismic-msmarco":
        if opt_overrides:      # overrides apply to the SeismicConfig
            mod = _seismic_override(mod, opt_overrides)
        got = seismic_cell(mod, cell, shape)
        mem, flops, hbm, coll = got["memory"], got["flops"], got["bytes"], {}
        mf, source = 0.0, "analytic"
        extra = dict(traced=False, why=(
            "the search compacts candidates to data-dependent shapes, which "
            "meta tensors cannot run: analytic flops and bytes"),
                     n_shards=got["n_shards"])
    else:
        bundle = get_bundle(arch_id)
        cfg = bundle.config
        if opt_overrides:
            cfg = dataclasses.replace(cfg, **opt_overrides)
            bundle = dataclasses.replace(bundle, config=cfg)
        got = trace_cell(bundle, cfg, cell.kind, cell.dims, mesh,
                         microbatches=microbatches)
        mem, coll, mf = got["memory"], got["collectives"], got["model_flops"]
        flops, hbm = got["cost"]["flops"], got["cost"]["hbm_bytes"]
        source = "dispatch-count"
        extra = dict(traced=True, n_ops=got["ops"],
                     n_dots=got["dots"]["n_dots"])
    roof = Roofline(flops=flops, hbm_bytes=hbm,
                    coll_bytes=float(coll.get("total", 0)))
    return dict(
        arch=arch_id, shape=shape_name,
        mesh="x".join(str(n) for n in shape.values()),
        multi_pod=multi_pod, n_chips=n_chips, kind=cell.kind,
        compile_s=round(time.perf_counter() - t0, 1),
        memory=mem,
        cost=dict(flops=flops, hbm_bytes=hbm),
        collectives=coll,
        roofline=roof.as_dict(),
        probe=None,
        flops_source=source,
        model_flops=mf,
        model_flops_ratio=(mf / (flops * n_chips)
                           if flops > 0 and mf > 0 else None),
        tag=tag, **extra)


def save_record(rec: dict, out_dir: str = OUT_DIR) -> str:
    os.makedirs(out_dir, exist_ok=True)
    mesh_tag = "multipod" if rec.get("multi_pod") else "singlepod"
    tag = f"__{rec['tag']}" if rec.get("tag") else ""
    name = f"{rec['arch']}__{rec['shape']}__{mesh_tag}{tag}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1)
    return name


def _job(job):
    """One cell in a worker process -> (label, record or None, error
    text or None)."""
    a, s, mp, label = job
    try:
        return label, run_cell(a, s, multi_pod=mp), None
    except Exception as e:     # reported by main, as FAIL
        return label, None, (f"{type(e).__name__}: {e}\n"
                             + traceback.format_exc())


def jobs_of(archs, shape, both_meshes: bool, multi_pod: bool) -> list:
    out = []
    for a in archs:
        mod = get_arch(a)
        shapes = [c.name for c in mod.SHAPES] if shape is None else [shape]
        for s in shapes:
            for mp in ([False, True] if both_meshes else [multi_pod]):
                label = f"{a:24s} {s:14s} {'2x16x16' if mp else '16x16'}"
                out.append((a, s, mp, label))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its own")
    args = ap.parse_args(argv)
    if not args.all and args.arch is None:
        ap.error("give --arch (and --shape) or --all")
    archs = list_archs() if args.all else [args.arch]
    jobs = jobs_of(archs, None if args.all else args.shape,
                   args.both_meshes, args.multi_pod)
    if args.jobs > 1:
        import concurrent.futures
        import multiprocessing
        with concurrent.futures.ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn")
        ) as pool:
            results = list(pool.map(_job, jobs))
    else:
        results = map(_job, jobs)
    failures = []
    for label, rec, err in results:
        if err is not None:
            failures.append(label)
            print(f"FAIL {label}: {err}", flush=True)
            continue
        if "skipped" in rec:
            print(f"SKIP {label}: {rec['skipped']}", flush=True)
            save_record(dict(rec, multi_pod="2x16x16" in label, tag=""),
                        args.out)
            continue
        r = rec["roofline"]
        print(f"OK   {label}  compile={rec['compile_s']}s  "
              f"flops/dev={rec['cost']['flops']:.3e}  "
              f"coll/dev={rec['collectives'].get('total', 0):.3e}B  "
              f"bound={r['bottleneck']}", flush=True)
        print("     memory_analysis:", rec["memory"], flush=True)
        save_record(rec, args.out)
    if failures:
        print(f"{len(failures)} dry-run cells failed", flush=True)
        return 1
    print("all dry-run cells passed", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
