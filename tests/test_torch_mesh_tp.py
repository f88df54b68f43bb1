"""Port parity on a mesh: tensor-parallel (and expert-parallel) LM forward
and ZeRO-1 training of ``repro_torch`` over gloo ranks against the JAX
package on the same mesh of forced host devices.

Tolerances:
* TP forward on (2, 2) and (1, 4), REDUCED llama3 / gemma3 / deepseek /
  kimi in float32 at each config's own ``capacity_factor``: the gathered
  logits ``allclose(rtol=1e-5, atol=1e-5)`` to JAX's on the same mesh.
  For the MoE archs the first MoE layer's routing on every shard (the
  shard's tokens, as JAX's ``shard_map`` cuts them) and the assignments
  its per-shard capacity drops equal JAX's, and some are dropped (the
  per-shard capacity is what makes the mesh's answer differ from the
  unsharded one).
* ``seq_parallel`` on (2, 2) gives the logits of the all-reduce form
  (``allclose(rtol=1e-6, atol=1e-6)``).
* Three AdamW steps with ZeRO-1 over "data" on (2, 2), llama3 and kimi
  REDUCED, against the JAX launcher's jitted step with ``out_shardings``
  (the step the JAX launcher means; its own launcher refuses a second
  step on a mesh): each step's loss ``rtol=1e-5`` and the parameters
  after three steps ``allclose(rtol=1e-4, atol=1e-4)``. The sums of the
  tensor-parallel partial products, the vocab-parallel cross entropy and
  the global norm run in another order than XLA's, and AdamW's first
  steps scale a gradient element by about 1 / |g|: rounding in a tiny
  gradient element moves its parameter by a fraction of the step's lr
  (the three steps' lr sum to 1.8e-3 under the 10-step warmup).

The ranks are separate processes on a free local port (4 ranks; both
meshes in one spawn); every wait has a timeout.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from helpers import REPO, run_with_devices

ARCHS = ("llama3-8b", "gemma3-27b", "deepseek-v2-lite-16b",
         "kimi-k2-1t-a32b")
MOE = ("deepseek-v2-lite-16b", "kimi-k2-1t-a32b")
TRAIN_ARCHS = ("llama3-8b", "kimi-k2-1t-a32b")
MESHES = ((2, 2), (1, 4))
B, S = 4, 16
STEPS, LR = 3, 3e-3

JAX_CODE = r"""
import sys, dataclasses, math
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.models.api import get_bundle
from repro.models.common import rms_norm
from repro.models.transformer import lm, attention, ffn
from repro.distributed.param_sharding import opt_state_specs
from repro.data.pipeline import lm_token_stream
from repro.train import AdamWConfig, init_opt_state, make_train_step
ARCHS, MOE, TRAIN = {archs}, {moe}, {train}
B, S, STEPS, LR = {b}, {s}, {steps}, {lr}
out = {{}}
tokens = np.random.default_rng(0).integers(0, 256, (B, S)).astype(np.int32)
out["tokens"] = tokens

def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = prefix + "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                                for p in path)
        out[key] = np.asarray(leaf, np.float32)

for arch in ARCHS:
    bundle = get_bundle(arch)
    cfg = bundle.reduced
    params = bundle.init(jax.random.PRNGKey(0), cfg, {{}})
    flat(params, arch + "|p|")
    for shape in {meshes}:
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        with jax.set_mesh(mesh):
            specs = bundle.param_specs(params)
            psh = jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                               is_leaf=lambda x: isinstance(x, P))
            p_sh = jax.tree.map(jax.device_put, params, psh)
            logits, _ = jax.jit(lambda p, t: lm.forward(p, t, cfg))(
                p_sh, jnp.asarray(tokens))
        out[f"{{arch}}|logits|{{shape}}"] = np.asarray(logits, np.float32)
        if arch in MOE:
            # the first MoE layer's input, unsharded, then JAX's router on
            # each shard's tokens (batch over data, sequence over model)
            x = jnp.take(params["embed"], jnp.asarray(tokens), axis=0)
            pos = jnp.broadcast_to(jnp.arange(S), (B, S))
            x, _ = lm._block(params["dense0"], x, pos, 0, cfg, False)
            l0 = jax.tree.map(lambda a: a[0], params["layers"])
            h = rms_norm(x, l0["attn_norm"], cfg.norm_eps)
            a = (attention.mla_forward(l0["attn"], h, pos, cfg) if cfg.mla
                 else attention.gqa_forward(l0["attn"], h, pos, cfg))
            h = rms_norm(x + a, l0["ffn_norm"], cfg.norm_eps)
            d, m = shape
            for i in range(d):
                for j in range(m):
                    xl = h[i * B // d:(i + 1) * B // d,
                           j * S // m:(j + 1) * S // m].reshape(-1, cfg.d_model)
                    idx, _, _ = ffn._route(l0["ffn"]["router"], xl,
                                           cfg.moe_top_k)
                    out[f"{{arch}}|idx|{{shape}}|{{i}}|{{j}}"] = np.asarray(idx)

# the JAX launcher's step on (2, 2) with out_shardings (its own launcher
# refuses a second step on a mesh)
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
for arch in TRAIN:
    bundle = get_bundle(arch)
    cfg = bundle.reduced
    dims = dict(global_batch=B, seq_len=S)
    with jax.set_mesh(mesh):
        params = bundle.init(jax.random.PRNGKey(0), cfg, dims)
        pspecs = bundle.param_specs(params)
        psh = jax.tree.map(lambda s: NamedSharding(mesh, s), pspecs,
                           is_leaf=lambda x: isinstance(x, P))
        params = jax.tree.map(jax.device_put, params, psh)
        opt = init_opt_state(params)
        ospecs = opt_state_specs(pspecs, params, zero=True, dp=("data",),
                                 dp_size=2)
        osh = jax.tree.map(lambda s: NamedSharding(mesh, s), ospecs,
                           is_leaf=lambda x: isinstance(x, P))
        opt = jax.tree.map(jax.device_put, opt, osh)
        bsh = dict(tokens=NamedSharding(mesh, P(("data",), None)),
                   labels=NamedSharding(mesh, P(("data",), None)))
        step_fn = jax.jit(make_train_step(
            bundle.step(cfg, dims, "train"),
            AdamWConfig(lr=LR, warmup_steps=10, total_steps=STEPS)),
            in_shardings=(psh, osh, bsh), out_shardings=(psh, osh, None))
        stream = lm_token_stream(cfg.vocab, B, S, seed=0)()
        for i in range(STEPS):
            batch = {{k: jax.device_put(jnp.asarray(v), bsh[k])
                     for k, v in next(stream).items()}}
            params, opt, metrics = step_fn(params, opt, batch)
            out[f"{{arch}}|loss|{{i}}"] = np.float32(metrics["loss"])
    flat(params, arch + "|trained|")
np.savez(sys.argv[1], **out)
print("OK jax")
"""

RANK_CODE = r"""
import sys, dataclasses, json
import numpy as np, torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.data.pipeline import lm_token_stream
from repro_torch.distributed.sharding import gather_tensor, set_mesh, shard_module_, spec_of
from repro_torch.models.api import get_bundle
from repro_torch.models.transformer import ffn, lm, parallel
from repro_torch.train import AdamWConfig, init_opt_state, make_train_step
rank, world, port, src, dst = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4], sys.argv[5])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{{port}}",
                        world_size=world, rank=rank)
ARCHS, MOE, TRAIN = {archs}, {moe}, {train}
B, S, STEPS, LR = {b}, {s}, {steps}, {lr}
a = np.load(src)
tokens = torch.from_numpy(a["tokens"])
out = {{}}
meshes = {{shape: init_device_mesh("cpu", shape,
                                  mesh_dim_names=("data", "model"))
          for shape in {meshes}}}

def jax_tree(arch, kind):
    tree = {{}}
    pre = f"{{arch}}|{{kind}}|"
    for k in a.files:
        if k.startswith(pre):
            node = tree
            parts = k[len(pre):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {{}})
            node[parts[-1]] = a[k]
    return tree

def sharded_params(bundle, cfg, arch, mesh):
    params = lm.params_from_jax(jax_tree(arch, "p"), cfg, "cpu")
    return shard_module_(params, bundle.param_specs(params), mesh)

routes = []
real_route = ffn._route
def spy(router, x, top_k):
    got = real_route(router, x, top_k)
    routes.append(got[0].numpy().copy())
    return got
ffn._route = spy

for arch in ARCHS:
    bundle = get_bundle(arch)
    for shape, mesh in meshes.items():
        for sp in (False, True) if shape == (2, 2) else (False,):
            cfg = dataclasses.replace(bundle.reduced, seq_parallel=sp)
            with set_mesh(mesh):
                params = sharded_params(bundle, cfg, arch, mesh)
                routes.clear()
                logits, _ = lm.forward(params, tokens, cfg)
                full = parallel.gather_logits(logits, cfg,
                                              parallel.batch_split(B, cfg))
            out[f"{{arch}}|logits|{{shape}}|{{sp}}"] = full.numpy()
            if arch in MOE and not sp:
                out[f"{{arch}}|idx|{{shape}}|{{mesh.get_local_rank('data')}}|"
                    f"{{mesh.get_local_rank('model')}}"] = routes[0]
                # every shard's first MoE routing, gathered to rank 0
                parts = [None] * world
                dist.all_gather_object(parts, {{k: v for k, v in out.items()
                                               if "|idx|" in k}})
                for p in parts:
                    out.update(p)

mesh = meshes[(2, 2)]
for arch in TRAIN:
    bundle = get_bundle(arch)
    cfg = bundle.reduced
    dims = dict(global_batch=B, seq_len=S)
    with set_mesh(mesh):
        params = sharded_params(bundle, cfg, arch, mesh)
        opt = init_opt_state(params, zero=True)
        assert any(m.shape != p.shape for m, p in
                   zip(opt["m"].values(), params.parameters())), "no ZeRO"
        step = make_train_step(bundle.step(cfg, dims, "train"),
                               AdamWConfig(lr=LR, warmup_steps=10,
                                           total_steps=STEPS),
                               grad_axes=parallel.batch_axes(cfg))
        stream = lm_token_stream(cfg.vocab, B, S, seed=0)()
        for i in range(STEPS):
            batch = {{k: torch.from_numpy(v) for k, v in next(stream).items()}}
            params, opt, metrics = step(params, opt, batch)
            out[f"{{arch}}|loss|{{i}}"] = float(metrics["loss"])
        full = {{n: gather_tensor(p.detach(), spec_of(p), mesh)
                for n, p in params.named_parameters()}}
    tree = lm.to_jax_layout(full)
    def walk(node, pre):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, pre + k + "/")
            else:
                out[f"{{arch}}|trained|{{pre}}{{k}}"] = v.numpy()
    walk(tree, "")
if rank == 0:
    np.savez(dst, **out)
dist.barrier()
dist.destroy_process_group()
"""


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(code: str, world: int, *args, timeout: float = 600.0):
    """``world`` processes of ``code`` (rank, world, port, *args) that meet
    on a free local port; raises with their output if any fails."""
    port = str(free_port())
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r),
                               str(world), port, *args], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
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
        raise AssertionError("a rank failed:\n" + "\n".join(
            f"--- rank {r} (rc {p.returncode})\n{o[-3000:]}"
            for r, (p, o) in enumerate(zip(procs, outs))))


def dropped(idx: np.ndarray, n_experts: int, cap: int) -> np.ndarray:
    """The (token, k) assignments past the capacity, by the JAX rule: a
    stable sort by expert, rank within the expert >= cap."""
    flat = idx.reshape(-1)
    order = np.argsort(flat, kind="stable")
    se = flat[order]
    start = np.searchsorted(se, np.arange(n_experts + 1))
    rank = np.arange(flat.size) - start[se]
    out = np.zeros(flat.size, bool)
    out[order] = rank >= cap
    return out.reshape(idx.shape)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_tp")
    jout, pout = str(tmp / "jax.npz"), str(tmp / "port.npz")
    fmt = dict(archs=ARCHS, moe=MOE, train=TRAIN_ARCHS, b=B, s=S,
               steps=STEPS, lr=LR, meshes=MESHES)
    code = JAX_CODE.format(**fmt).replace("sys.argv[1]", repr(jout))
    assert "OK jax" in run_with_devices(code, n_devices=4, timeout=600)
    run_ranks(RANK_CODE.format(**fmt), 4, jout, pout)
    return np.load(jout), np.load(pout)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_forward_matches_jax_on_the_same_mesh(runs, arch, shape):
    j, p = runs
    want = j[f"{arch}|logits|{shape}"]
    got = p[f"{arch}|logits|{shape}|False"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if shape == (2, 2):
        np.testing.assert_allclose(p[f"{arch}|logits|{shape}|True"], got,
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", MOE)
def test_moe_drops_per_shard_as_jax(runs, arch, shape):
    """Each shard routes its own tokens and drops past its own capacity:
    the routing and the dropped assignments equal JAX's shard by shard."""
    import math
    from repro_torch.models.api import get_bundle
    cfg = get_bundle(arch).reduced
    j, p = runs
    d, m = shape
    t_loc = (B // d) * (S // m)
    cap = max(1, math.ceil(t_loc * cfg.moe_top_k / cfg.n_experts
                           * cfg.capacity_factor))
    n_drop = 0
    for i in range(d):
        for k in range(m):
            key = f"{arch}|idx|{shape}|{i}|{k}"
            np.testing.assert_array_equal(p[key], j[key])
            mine = dropped(p[key], cfg.n_experts, cap)
            np.testing.assert_array_equal(
                mine, dropped(j[key], cfg.n_experts, cap))
            n_drop += int(mine.sum())
    assert n_drop > 0


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_zero1_training_matches_jax(runs, arch):
    j, p = runs
    for i in range(STEPS):
        np.testing.assert_allclose(p[f"{arch}|loss|{i}"],
                                   j[f"{arch}|loss|{i}"], rtol=1e-5)
    keys = [k for k in j.files if k.startswith(f"{arch}|trained|")]
    assert keys and sorted(keys) == sorted(
        k for k in p.files if k.startswith(f"{arch}|trained|"))
    for k in keys:
        np.testing.assert_allclose(p[k], j[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
