"""Mesh construction (port of ``repro/launch/mesh.py``) over
``torch.distributed``.

Functions, not module-level constants, so importing this module touches
no process group. The process group must be initialised first (the
launchers do it); the mesh's device type is the one its collectives
carry: "cuda" over NCCL, "cpu" over gloo (whose exchanges of CUDA
tensors go through host memory, ``distributed.collectives``). Single
pod: (16, 16) = 256 ranks, ("data", "model"). Multi-pod: (2, 16, 16) =
512 ranks, ("pod", "data", "model").
"""
from __future__ import annotations


def _device_type() -> str:
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make a mesh after torch.distributed."
                           "init_process_group")
    need = 1
    for n in shape:
        need *= n
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"a mesh of shape {shape} needs a world of {need} "
                         f"ranks; the process group has {world}")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_mesh_for(n_devices: int, model_parallel: int = 1):
    """Elastic helper: whatever ranks exist -> (data, model) mesh."""
    if n_devices % model_parallel:
        raise ValueError(f"{n_devices} ranks do not split into model "
                         f"parallel groups of {model_parallel}")
    return _mesh((n_devices // model_parallel, model_parallel),
                 ("data", "model"))


# ------------------------------------------------------ the launchers' ranks

def under_torchrun() -> bool:
    """Whether ``torchrun`` (or another elastic agent) started this
    process: RANK, WORLD_SIZE and LOCAL_RANK in the environment."""
    import os
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))


def join_torchrun(device: str):
    """Join the process group ``torchrun`` describes and return this
    rank's device: NCCL with one card per rank for a CUDA ``device``
    (raises when the host has fewer cards than local ranks), gloo for the
    CPU."""
    import os

    import torch
    import torch.distributed as dist
    local = int(os.environ["LOCAL_RANK"])
    if torch.device(device).type == "cuda":
        n_local = int(os.environ.get("LOCAL_WORLD_SIZE", local + 1))
        cards = torch.cuda.device_count()
        if cards < n_local:
            raise RuntimeError(f"torchrun started {n_local} ranks on a host "
                               f"with {cards} CUDA device(s): NCCL needs "
                               "one card per rank")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev)
        return dev
    dist.init_process_group("gloo")
    return torch.device(device)


def join_ranks(rank: int, world: int, port: int, device: str):
    """Join the gloo group of ranks that :func:`run_as_ranks` started on
    this host; every rank uses ``device`` (ranks sharing one card
    exchange through host memory)."""
    import os

    import torch
    import torch.distributed as dist
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:           # every rank on the same card
            dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    else:   # the ranks share this host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    return dev


def free_port() -> int:
    """A free TCP port on localhost, for a process group's rendezvous."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def start_ranks(commands: list[list[str]], *, env: dict | None = None,
                timeout: float | None = None,
                what: str = "a rank") -> list[str]:
    """Start one process per command on this host and wait for all (every
    one is ended before this returns) -> their outputs, stdout and stderr
    together. Raises with the ranks' output if any fails."""
    import subprocess
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for cmd in commands]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise RuntimeError(f"{what} failed:\n" + "\n".join(
            f"--- rank {r} (rc {p.returncode})\n{o[-6000:]}"
            for r, (p, o) in enumerate(zip(procs, outs))))
    return outs


def run_as_ranks(module: str, argv: list[str], n: int,
                 timeout: float | None = None):
    """Start ``n`` processes of ``python -m module argv --rank i --world n
    --port P --result F`` on this host (:func:`start_ranks`), print rank
    0's output, and return what rank 0 saved to F (``torch.save``)."""
    import os
    import sys
    import tempfile

    import torch
    port = free_port()
    import repro_torch
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    with tempfile.TemporaryDirectory() as tmp:
        result = os.path.join(tmp, "result.pt")
        outs = start_ranks(
            [[sys.executable, "-m", module, *argv, "--rank", str(r),
              "--world", str(n), "--port", str(port), "--result", result]
             for r in range(n)], env=env, timeout=timeout,
            what=f"{module}: a rank")
        print(outs[0], end="", flush=True)
        return torch.load(result, weights_only=False)


def rank_args(ap) -> None:
    """The hidden flags of a rank that :func:`run_as_ranks` started."""
    import argparse
    for flag, kind in (("--rank", int), ("--world", int), ("--port", int),
                       ("--result", str)):
        ap.add_argument(flag, type=kind, default=None, help=argparse.SUPPRESS)
