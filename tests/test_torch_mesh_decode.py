"""Port parity on a mesh: ``decode_step`` with the cache as ``cache_specs``
lays it out, and FSDP with MoE layers, over gloo ranks against the JAX
package on the same mesh of forced host devices.

* Decode: REDUCED llama3 / gemma3 / deepseek / kimi (float32) on (2, 2)
  and (1, 4) at batch 4 (its rows split over "data", the cache length
  over "model"), and on (2, 2) at batch 1 (the length over ("data",
  "model")), plus llama3 and kimi in "fsdp" mode on (2, 2). The JAX step is
  ``decode_step`` jitted with the JAX dry-run's shardings (parameters by
  ``lm_param_specs``, the cache by ``cache_specs``, tokens ``P(dp,
  None)`` or ``P()``), the port's the ranks' ``decode_step`` on their
  slices. Both start from one seeded cache and decode three steps at
  positions whose slots lie on different ranks (gemma3's past its
  16-slot ring). Each step's logits ``allclose(rtol=1e-5, atol=1e-5)``;
  the cache after the steps gathered ``allclose`` to JAX's at the same
  tolerance, and every slot no step wrote bitwise the start cache.
* FSDP with MoE layers: REDUCED deepseek and kimi, ``sharding_mode=
  "fsdp"`` on (2, 2), forward logits and ``loss_fn`` of a batch of 4 at
  S 16 (the all-to-all path: S divides over "model") and S 15 (the
  token-poor path), and kimi's forward of a batch of 2 and of 1 (no
  split over every axis: the batch replicated, cut as JAX's ``x_spec``
  cuts it), ``allclose(rtol=1e-5, atol=1e-5)`` to JAX's on the same
  mesh.
* Heads that do not split over "model" (phi3-medium-14b's 40 over the
  production mesh's 16): REDUCED llama3 with 6 heads on (1, 4), each
  rank 1.5 heads' columns; its TP forward logits and its decode (a cell
  above) ``allclose(rtol=1e-5, atol=1e-5)`` to JAX's on the same mesh,
  which GSPMD pads to 2 heads a rank.

The ranks are separate processes on a free local port; every wait has a
timeout.
"""
import numpy as np
import pytest

from helpers import run_with_devices
from test_torch_mesh_tp import run_ranks

ARCHS = ("llama3-8b", "gemma3-27b", "deepseek-v2-lite-16b",
         "kimi-k2-1t-a32b")
MESHES = ((2, 2), (1, 4))
BATCHES = (4, 1)
T = 32
POSITIONS = (7, 20, 30)
FSDP_DECODE = ("llama3-8b", "kimi-k2-1t-a32b")
# (arch, batch, sequence) of the FSDP forwards on (2, 2): a batch of 4
# splits over every axis, 2 over "data" only, 1 over none
FSDP_MOE = (("deepseek-v2-lite-16b", 4, 16), ("deepseek-v2-lite-16b", 4, 15),
            ("kimi-k2-1t-a32b", 4, 16), ("kimi-k2-1t-a32b", 4, 15),
            ("kimi-k2-1t-a32b", 2, 16), ("kimi-k2-1t-a32b", 1, 16))


def cells():
    """(arch, mode, mesh, batch) of every decode run ("uneven": REDUCED
    llama3 with 6 heads)."""
    out = [(a, "tp", m, b) for a in ARCHS for m in MESHES for b in BATCHES
           if m[0] > 1 or b > 1]   # batch 1 splits over a data axis of 1
    return out + [(a, "fsdp", (2, 2), 4) for a in FSDP_DECODE] \
        + [("uneven", "tp", (1, 4), 4)]


# REDUCED's config of an arch in the runs below (both packages)
REDUCED = """
def reduced(arch):
    if arch == "uneven":
        return dataclasses.replace(get_bundle("llama3-8b").reduced,
                                   n_heads=6)
    return get_bundle(arch).reduced
"""


def key(arch, mode, mesh, b):
    return f"{arch}|{mode}|{mesh[0]}x{mesh[1]}|b{b}"


JAX_CODE = r"""
import sys, dataclasses
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.models.api import get_bundle
from repro.models.transformer import lm
from repro.distributed.param_sharding import cache_specs, lm_param_specs
CELLS, T, POSITIONS = {cells}, {t}, {positions}
FSDP_MOE = {fsdp_moe}
out = {{}}
{reduced}
def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        k = prefix + "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                              for p in path)
        out[k] = np.asarray(leaf, np.float32)

def tree(mesh, specs):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                        is_leaf=lambda x: isinstance(x, P))

params_of = {{}}
for arch, mode, shape, b in CELLS:
    name = f"{{arch}}|{{mode}}|{{shape[0]}}x{{shape[1]}}|b{{b}}"
    cfg = dataclasses.replace(reduced(arch), sharding_mode=mode)
    if arch not in params_of:
        params_of[arch] = get_bundle("llama3-8b").init(
            jax.random.PRNGKey(0), reduced(arch), {{}})
        flat(params_of[arch], arch + "|p|")
    params = params_of[arch]
    rng = np.random.default_rng(len(out))
    cache = {{k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in lm.init_cache(cfg, b, T).items()}}
    for k, v in cache.items():
        out[f"{{name}}|cache0|{{k}}"] = v
    toks = rng.integers(0, cfg.vocab, (len(POSITIONS), b, 1)).astype(np.int32)
    out[f"{{name}}|tokens"] = toks
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with jax.set_mesh(mesh):
        psh = tree(mesh, lm_param_specs(params, mode=mode))
        csh = tree(mesh, cache_specs(cache, ("data",), dp_size=shape[0],
                                     tp_size=shape[1]))
        tsh = NamedSharding(mesh, P(("data",), None) if b % shape[0] == 0
                            else P())
        step = jax.jit(lambda p, c, t, pos: lm.decode_step(p, c, t, pos, cfg),
                       in_shardings=(psh, csh, tsh, NamedSharding(mesh, P())))
        p_sh = jax.tree.map(jax.device_put, params, psh)
        c = jax.tree.map(jax.device_put, {{k: jnp.asarray(v) for k, v in
                                          cache.items()}}, csh)
        for i, pos in enumerate(POSITIONS):
            logits, c = step(p_sh, c, jnp.asarray(toks[i]), jnp.int32(pos))
            out[f"{{name}}|logits|{{i}}"] = np.asarray(logits, np.float32)
    for k, v in c.items():
        out[f"{{name}}|cache|{{k}}"] = np.asarray(v, np.float32)

mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
for arch, b, s in FSDP_MOE:
    cfg = dataclasses.replace(reduced(arch), sharding_mode="fsdp")
    params = params_of[arch]
    run = f"{{arch}}|fsdp|{{b}}x{{s}}"
    rng = np.random.default_rng(s)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = rng.integers(-1, cfg.vocab, (b, s)).astype(np.int32)
    out[run + "|tokens"], out[run + "|labels"] = toks, labels
    with jax.set_mesh(mesh):
        psh = tree(mesh, lm_param_specs(params, mode="fsdp"))
        p_sh = jax.tree.map(jax.device_put, params, psh)
        logits, _ = jax.jit(lambda p, t: lm.forward(p, t, cfg))(
            p_sh, jnp.asarray(toks))
        loss = jax.jit(lambda p, bt: lm.loss_fn(p, bt, cfg))(
            p_sh, dict(tokens=jnp.asarray(toks), labels=jnp.asarray(labels)))
    out[run + "|logits"] = np.asarray(logits, np.float32)
    out[run + "|loss"] = np.float32(loss)
# heads that do not split over "model": the TP forward on (1, 4)
mesh = jax.make_mesh((1, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
cfg = reduced("uneven")
toks = np.random.default_rng(6).integers(0, cfg.vocab, (4, 16)).astype(np.int32)
out["uneven|tokens"] = toks
with jax.set_mesh(mesh):
    psh = tree(mesh, lm_param_specs(params_of["uneven"]))
    p_sh = jax.tree.map(jax.device_put, params_of["uneven"], psh)
    logits, _ = jax.jit(lambda p, t: lm.forward(p, t, cfg))(
        p_sh, jnp.asarray(toks))
out["uneven|logits"] = np.asarray(logits, np.float32)
np.savez(sys.argv[1], **out)
print("OK jax")
"""

RANK_CODE = r"""
import sys, dataclasses
import numpy as np, torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.distributed.param_sharding import lm_param_specs
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (axes_size, set_mesh,
                                              shard_module_)
from repro_torch.models.api import get_bundle
from repro_torch.models.transformer import lm, parallel
rank, world, port, src, dst = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4], sys.argv[5])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{{port}}",
                        world_size=world, rank=rank)
CELLS, T, POSITIONS = {cells}, {t}, {positions}
FSDP_MOE = {fsdp_moe}
a = np.load(src)
out = {{}}
{reduced}
meshes = {{shape: init_device_mesh("cpu", shape,
                                  mesh_dim_names=("data", "model"))
          for shape in set(c[2] for c in CELLS)}}

def jax_tree(arch):
    tree = {{}}
    pre = f"{{arch}}|p|"
    for k in a.files:
        if k.startswith(pre):
            node = tree
            parts = k[len(pre):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {{}})
            node[parts[-1]] = a[k]
    return tree

def sharded(arch, cfg, mesh):
    params = lm.params_from_jax(jax_tree(arch), cfg, "cpu")
    return shard_module_(params, lm_param_specs(params, cfg.sharding_mode),
                         mesh)

for arch, mode, shape, b in CELLS:
    name = f"{{arch}}|{{mode}}|{{shape[0]}}x{{shape[1]}}|b{{b}}"
    cfg = dataclasses.replace(reduced(arch), sharding_mode=mode)
    mesh = meshes[shape]
    with set_mesh(mesh):
        params = sharded(arch, cfg, mesh)
        full = {{k[len(name) + 8:]: torch.from_numpy(a[k]) for k in a.files
                if k.startswith(name + "|cache0|")}}
        cache = parallel.shard_cache(full)
        toks = torch.from_numpy(a[f"{{name}}|tokens"])
        for i, pos in enumerate(POSITIONS):
            logits, cache = lm.decode_step(params, cache, toks[i], pos, cfg)
            split = b % shape[0] == 0
            got = parallel.gather_decode_logits(logits, cfg, split)
            out[f"{{name}}|logits|{{i}}"] = got.numpy()
        for k, v in parallel.gather_cache(cache).items():
            out[f"{{name}}|cache|{{k}}"] = v.numpy()

mesh = meshes[(2, 2)]
for arch, b, s in FSDP_MOE:
    cfg = dataclasses.replace(reduced(arch), sharding_mode="fsdp")
    run = f"{{arch}}|fsdp|{{b}}x{{s}}"
    toks = torch.from_numpy(a[run + "|tokens"])
    labels = torch.from_numpy(a[run + "|labels"])
    with set_mesh(mesh):
        params = sharded(arch, cfg, mesh)
        split = parallel.batch_split(b, cfg)
        logits, _ = lm.forward(params, toks, cfg)
        out[run + "|logits"] = parallel.gather_logits(logits, cfg,
                                                      split).numpy()
        with torch.no_grad():
            loss = lm.loss_fn(params, dict(tokens=toks, labels=labels), cfg)
        # each rank's share of the mean, as the train step takes it
        axes = parallel.batch_axes(cfg) if split else ()
        out[run + "|loss"] = float(C.all_reduce(loss, axes)
                                   / axes_size(axes))
cfg = reduced("uneven")
with set_mesh(meshes[(1, 4)]):
    params = sharded("uneven", cfg, meshes[(1, 4)])
    logits, _ = lm.forward(params, torch.from_numpy(a["uneven|tokens"]), cfg)
    out["uneven|logits"] = parallel.gather_logits(logits, cfg, True).numpy()
if rank == 0:
    np.savez(dst, **out)
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_decode")
    jout, pout = str(tmp / "jax.npz"), str(tmp / "port.npz")
    fmt = dict(cells=cells(), t=T, positions=POSITIONS, fsdp_moe=FSDP_MOE,
               reduced=REDUCED)
    code = JAX_CODE.format(**fmt).replace("sys.argv[1]", repr(jout))
    assert "OK jax" in run_with_devices(code, n_devices=4, timeout=600)
    run_ranks(RANK_CODE.format(**fmt), 4, jout, pout)
    return np.load(jout), np.load(pout)


@pytest.mark.parametrize("cell", cells(), ids=lambda c: key(*c))
def test_decode_on_a_mesh_matches_jax(runs, cell):
    j, p = runs
    name = key(*cell)
    for i in range(len(POSITIONS)):
        np.testing.assert_allclose(p[f"{name}|logits|{i}"],
                                   j[f"{name}|logits|{i}"], rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {i}")
    keys = [k for k in j.files if k.startswith(name + "|cache|")]
    assert keys and sorted(keys) == sorted(
        k for k in p.files if k.startswith(name + "|cache|"))
    for k in keys:
        start = j[k.replace("|cache|", "|cache0|")]
        np.testing.assert_allclose(p[k], j[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
        # the slots no step wrote (along T: dim 1 of a layer-0 entry,
        # else dim 2) are the start cache, bitwise
        dim = 1 if k.endswith("0") else 2
        others = tuple(d for d in range(start.ndim) if d != dim)
        kept = np.all(j[k] == start, axis=others)
        assert 0 < kept.sum() < kept.size, k
        np.testing.assert_array_equal(np.compress(kept, p[k], axis=dim),
                                      np.compress(kept, start, axis=dim),
                                      err_msg=k)


@pytest.mark.parametrize("run", FSDP_MOE, ids=lambda r: f"{r[0]}|{r[1]}x{r[2]}")
def test_fsdp_with_moe_matches_jax(runs, run):
    j, p = runs
    key = f"{run[0]}|fsdp|{run[1]}x{run[2]}"
    np.testing.assert_allclose(p[key + "|logits"], j[key + "|logits"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p[key + "|loss"], j[key + "|loss"],
                               rtol=1e-5, atol=1e-5)


def test_heads_that_do_not_split_match_jax(runs):
    j, p = runs
    np.testing.assert_allclose(p["uneven|logits"], j["uneven|logits"],
                               rtol=1e-5, atol=1e-5)
