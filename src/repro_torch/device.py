"""Device resolution for the port's entry points, the host side of a
tensor, and the CUDA streams of the serving threads."""
from __future__ import annotations

import contextlib

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> the current CUDA device; an explicit device is taken as
    given. Never falls back to the CPU on its own: without CUDA and
    without an explicit device this raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU explicitly")
    return torch.device("cuda", torch.cuda.current_device())


def new_stream(device: torch.device):
    """A CUDA stream on ``device`` that waits for the work queued so far
    on the calling thread's current stream; None on the CPU."""
    if device.type != "cuda":
        return None
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    return stream


def on_stream(stream):
    """Make ``stream`` current in the calling thread (no-op for None)."""
    return contextlib.nullcontext() if stream is None \
        else torch.cuda.stream(stream)


def host_array(a) -> np.ndarray:
    """A tensor (on any device) or an array-like as a numpy array. numpy
    has no bfloat16: a bf16 tensor comes back as its 2-byte items
    (``V2``), the bits of an ``ml_dtypes.bfloat16`` array, and a uint16
    one through its int16 bits."""
    if not isinstance(a, torch.Tensor):
        return np.asarray(a)
    t = a.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    if t.dtype == torch.uint16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()
