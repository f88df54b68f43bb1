"""The MoE router's precision, which training differentiates through,
without global state: its logits are the float64 product rounded to
float32 (``ffn.router_logits``) on every device, so no module of the port
writes ``torch.backends.cuda.matmul.allow_tf32``; and the flash_attention
kernel refuses autograd on the card. The tests marked ``gpu`` skip
without a card (``python -m pytest -q -m gpu tests/test_torch_precision.py``
on an H100 host); this file imports no JAX, so it runs there too.
"""
import ast
import dataclasses
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import llama3_8b
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.transformer import ffn, lm

ROOT = Path(__file__).resolve().parents[1]


def test_router_logits_are_the_float64_product_rounded():
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((48, 16)).astype(np.float32))
    want = (x.double() @ w.double()).float()
    assert torch.equal(ffn.router_logits(w, x), want)
    xb = x.bfloat16()
    assert torch.equal(ffn.router_logits(w, xb),
                       (xb.double() @ w.double()).float())
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    gx, gw = torch.autograd.grad(ffn.router_logits(wg, xg).sum(), [xg, wg])
    assert gx.dtype == gw.dtype == torch.float32 and bool(gw.abs().sum() > 0)


def _assigns_allow_tf32(path: Path) -> bool:
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Attribute) and t.attr == "allow_tf32":
                return True
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "setattr" and len(node.args) >= 2 \
                and isinstance(node.args[1], ast.Constant) \
                and node.args[1].value == "allow_tf32":
            return True
    return False


@pytest.mark.parametrize(
    "path", sorted((ROOT / "src" / "repro_torch").rglob("*.py")),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_port_file_assigns_allow_tf32(path):
    """TF32 is the caller's choice: no module of the port writes the
    process-wide flag (the router runs a float64 product instead)."""
    assert not _assigns_allow_tf32(path)


def test_the_tf32_scan_sees_an_assignment():
    assert _assigns_allow_tf32(ROOT / "chip_smoke.py")


# ------------------------------------------------------------ on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on an H100 host)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_route_from_threads_keeps_tf32_and_float64_logits_on_card():
    """Four threads route at once on the card while the caller keeps TF32
    on: a watcher never sees the flag change, and every thread's logits
    are the float64 product rounded to float32 (so its experts are the
    float64 product's)."""
    dev = _cuda()
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        gen = torch.Generator(device=dev).manual_seed(0)
        w = torch.randn(2048, 64, device=dev, generator=gen) * 2048 ** -0.5
        xs = [torch.randn(4096, 2048, device=dev, generator=gen)
              for _ in range(4)]
        want = [(x.double() @ w.double()).float() for x in xs]
        torch.cuda.synchronize()
        stop, seen, errors = threading.Event(), set(), []

        def watch():
            while not stop.is_set():
                seen.add(torch.backends.cuda.matmul.allow_tf32)

        def work(i):
            try:
                for _ in range(20):
                    got = ffn.router_logits(w, xs[i])
                    idx, _, _ = ffn._route(w, xs[i], 6)
                    torch.cuda.current_stream().synchronize()
                    assert torch.equal(got, want[i])
                    ref = torch.sort(torch.softmax(want[i], -1), dim=-1,
                                     descending=True, stable=True)[1][:, :6]
                    assert torch.equal(idx, ref)
            except BaseException as exc:
                errors.append(exc)

        watcher = threading.Thread(target=watch)
        watcher.start()
        threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stop.set()
        watcher.join()
        assert not errors, errors
        assert seen == {True}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.gpu
def test_flash_attention_raises_under_autograd_on_card():
    dev = _cuda()
    q = torch.randn(1, 4, 256, 128, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.randn(1, 4, 256, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, k)
    with torch.no_grad():
        assert flash_attention(q, k, k).shape == q.shape
    cfg = dataclasses.replace(llama3_8b.REDUCED, d_head=64, d_model=256,
                              dtype="bfloat16")
    mod = lm.init_params(cfg, seed=0, device=dev)
    batch = dict(tokens=torch.zeros((1, 128), dtype=torch.int32, device=dev),
                 labels=torch.zeros((1, 128), dtype=torch.int32, device=dev))
    with pytest.raises(RuntimeError, match="no backward"):
        lm.loss_fn(mod, batch, cfg, use_kernel=True)
