"""How each kernel call picks its implementation, and the kernel build.

* A call whose tensors all lie on the CPU takes the kernel's plain
  PyTorch version (``ref.py``). A call on CUDA tensors launches the
  hand-written kernel or raises; it never falls back.
* Kernel sources are ``kernels/<family>/csrc/<family>.cu`` with a plain C
  interface; headers they share (the row dot of the retrieval kernels)
  are ``kernels/common/csrc/*.cuh``. On first use each source is compiled
  with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
  -Xcompiler -fPIC -I kernels/common/csrc`` into ``build/kernels/`` at
  the repository root and loaded with ``ctypes``. The library's file
  name carries a hash of its source, every shared header and the flags,
  so an edited source or header is rebuilt. :func:`build_kernels`
  compiles several sources in parallel (one ``nvcc`` each) and returns
  ptxas' report.
* Every wrapper adds one to its kernel's count in ``LAUNCHES`` where it
  launches the kernel, and nowhere else; counts update under ``_lock``,
  so launches from several host threads (the replica servers' workers)
  are all counted.
* :func:`sync_stream` waits for the work queued on the calling thread's
  current stream only, so a server thread's timing never includes the
  work of another thread's stream.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
ROOT = _PKG.parents[2]
BUILD_DIR = ROOT / "build" / "kernels"
INCLUDE_DIR = _PKG / "common" / "csrc"
SOURCES = {
    name: _PKG / name / "csrc" / f"{name}.cu"
    for name in ("summary_dot", "gather_dot", "router_fused", "refine_fused",
                 "flash_attention")
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(INCLUDE_DIR))

LAUNCHES = {"summary_dot": 0, "gather_dot": 0, "gather_dot_cand": 0,
            "router_flat": 0, "router_hier": 0, "refine_round": 0,
            "flash_attention": 0,
            # router_flat's two helpers: its lists inverted into groups by
            # list, and the queries' records
            "router_flat_groups": 0, "router_flat_records": 0}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    with _lock:
        LAUNCHES[name] += 1


def sync_stream(device: torch.device) -> None:
    """Wait for the work queued on the current stream of ``device`` (the
    calling thread's), not for the whole device; nothing on the CPU."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def use_plain(*tensors: torch.Tensor | None) -> bool:
    """True when every given tensor lies on the CPU, False when every one
    lies on CUDA; anything else raises."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        devs = {t.device for t in tensors if t is not None}
        if len(devs) != 1:
            raise ValueError(f"tensors span several CUDA devices: {devs}")
        return False
    raise ValueError(f"kernel inputs must all be on the CPU or all on one "
                     f"CUDA device, got {sorted(kinds)}")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin); the CUDA kernels cannot build")


def library_path(name: str) -> Path:
    """Where source ``name`` builds to: the file name hashes the source,
    every shared header (sorted by name) and the flags."""
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(INCLUDE_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_kernels(names=None) -> dict[str, str]:
    """Compile the named kernel sources (default: all) that are not built
    yet, one ``nvcc`` process each, all started together. Returns each
    compiled source's ptxas report (registers, shared memory, spills);
    raises with the compiler's output if any build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_kernels([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """The current PyTorch stream on ``t``'s device, as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def check_launch(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


__all__ = ["LAUNCHES", "reset_launches", "count_launch", "sync_stream",
           "use_plain",
           "build_kernels", "library", "library_path", "stream_of", "ptr",
           "check_launch", "require", "SOURCES", "BUILD_DIR", "INCLUDE_DIR"]
