"""Port parity on an 8-rank mesh: the token-poor expert-parallel path,
FSDP, the int8 compressed all-reduce, the model-sharded embedding lookup
and GIN's edge-sharded (psum) and node-sharded (shard) layers of
``repro_torch`` over gloo ranks, against the JAX package on 8 forced host
devices.

Tolerances:
* kimi-k2 REDUCED with a batch of 3 on (2, 4): the batch does not split
  over "data", so both packages take the token-poor path (the 48 tokens
  split over "data", routing repeated on every model rank); logits
  ``allclose(rtol=1e-5, atol=1e-5)``.
* FSDP forward on (2, 4) (``tests/test_perf_variants.py``'s config):
  logits ``allclose(rtol=1e-5, atol=1e-5)``.
* ``compressed_psum`` on 8 ranks against JAX's 8-device ``shard_map``:
  the synced gradients and the new error equal bitwise (the same float32
  operations in the same order, and an exact int32 sum); the all-reduced
  payload is int32 (and the scale's a float32 scalar); JAX's error bound
  (under 3 scales) holds.
* ``lookup`` with a row-sharded table on (2, 4), the ids split over
  "data" (8 rows) or replicated (3 rows), and a whole table: bitwise.
* GIN, psum and shard modes on (2, 4): ``allclose(rtol=1e-4,
  atol=1e-4)`` to JAX's (its own test's tolerance).
* One wide-deep AdamW step on (2, 4) against the port on one device.
"""
import numpy as np
import pytest

from helpers import run_with_devices
from test_torch_mesh_tp import run_ranks

JAX_CODE = r"""
import sys, dataclasses
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import GNNConfig
from repro.distributed.param_sharding import lm_param_specs
from repro.models.api import get_bundle
from repro.models.gnn import gin
from repro.models.recsys.embedding import lookup
from repro.models.transformer import lm
from repro.train.compression import compressed_psum
out = {}
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)

def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = prefix + "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                                for p in path)
        out[key] = np.asarray(leaf, np.float32)

def put(params, specs):
    psh = jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                       is_leaf=lambda x: isinstance(x, P))
    return jax.tree.map(jax.device_put, params, psh)

# token-poor MoE: a batch of 3 does not split over data
bundle = get_bundle("kimi-k2-1t-a32b")
cfg = bundle.reduced
params = bundle.init(jax.random.PRNGKey(0), cfg, {})
flat(params, "kimi|p|")
tok3 = np.random.default_rng(0).integers(0, cfg.vocab, (3, 16)).astype(np.int32)
out["tok3"] = tok3
with jax.set_mesh(mesh):
    p_sh = put(params, bundle.param_specs(params))
    logits, _ = jax.jit(lambda p, t: lm.forward(p, t, cfg))(
        p_sh, jnp.asarray(tok3))
out["kimi|logits"] = np.asarray(logits)

# FSDP (tests/test_perf_variants.py)
bundle = get_bundle("llama3-8b")
cfg = dataclasses.replace(bundle.reduced, sharding_mode="fsdp",
                          d_model=64, d_ff=128, vocab=256)
params = bundle.init(jax.random.PRNGKey(0), cfg, {})
flat(params, "fsdp|p|")
tok8 = np.random.default_rng(0).integers(0, cfg.vocab, (8, 16)).astype(np.int32)
out["tok8"] = tok8
with jax.set_mesh(mesh):
    p_sh = put(params, lm_param_specs(params, mode="fsdp"))
    logits, _ = jax.jit(lambda p, t: lm.forward(p, t, cfg))(
        p_sh, jnp.asarray(tok8))
out["fsdp|logits"] = np.asarray(logits)

# compressed_psum on 8 devices
mesh8 = jax.make_mesh((8,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
rng = np.random.default_rng(0)
g_local = rng.standard_normal((8, 64, 32)).astype(np.float32)
e_local = (rng.standard_normal((8, 64, 32)) * 0.01).astype(np.float32)
out["g_local"], out["e_local"] = g_local, e_local
def body(g, e):
    synced, new_e = compressed_psum(dict(w=g[0]), dict(w=e[0]), ("data",))
    return synced["w"][None], new_e["w"][None]
with jax.set_mesh(mesh8):
    fn = jax.shard_map(body, mesh=mesh8, in_specs=(P("data"), P("data")),
                       out_specs=(P("data"), P("data")), check_vma=False)
    synced, e1 = jax.jit(fn)(jnp.asarray(g_local)[:, None],
                             jnp.asarray(e_local)[:, None])
out["synced"], out["e1"] = np.asarray(synced)[:, 0], np.asarray(e1)[:, 0]

# the model-sharded lookup
table = rng.standard_normal((512, 8)).astype(np.float32)
ids8 = rng.integers(0, 512, (8, 3)).astype(np.int64)
ids3 = rng.integers(0, 512, (3, 3)).astype(np.int64)
out["table"], out["ids8"], out["ids3"] = table, ids8, ids3
with jax.set_mesh(mesh):
    tsh = jax.device_put(jnp.asarray(table), NamedSharding(mesh, P("model", None)))
    for name, ids in (("ids8", ids8), ("ids3", ids3)):
        out["lookup|" + name] = np.asarray(
            jax.jit(lookup)(tsh, jnp.asarray(ids)))

# GIN psum and shard modes (tests/test_perf_variants.py)
n, e, f = 512, 2048, 8
feats = rng.standard_normal((n, f)).astype(np.float32)
edges = rng.integers(0, n, (e, 2)).astype(np.int32)
out["feats"], out["edges"] = feats, edges
cfg_ps = GNNConfig(name="t", n_layers=3, d_hidden=16, n_classes=4)
cfg_sh = dataclasses.replace(cfg_ps, aggregate_mode="shard")
gp = gin.init_params(jax.random.PRNGKey(0), cfg_ps, f, 4)
flat(gp, "gin|p|")
with jax.set_mesh(mesh):
    for name, c in (("psum", cfg_ps), ("shard", cfg_sh)):
        out["gin|" + name] = np.asarray(jax.jit(
            lambda p: gin.forward(p, jnp.asarray(feats), jnp.asarray(edges),
                                  c))(gp))
np.savez(sys.argv[1], **out)
print("OK jax")
"""

RANK_CODE = r"""
import sys, dataclasses
import numpy as np, torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs.base import GNNConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed.param_sharding import lm_param_specs
from repro_torch.distributed.sharding import (P, set_mesh, shard_module_,
                                              shard_tensor)
from repro_torch.models.api import get_bundle
from repro_torch.models.gnn import gin
from repro_torch.models.recsys.embedding import lookup
from repro_torch.models.transformer import lm, parallel
from repro_torch.train.compression import compressed_psum
rank, world, port, src, dst = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4], sys.argv[5])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=world, rank=rank)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
mesh8 = init_device_mesh("cpu", (8,), mesh_dim_names=("data",))
a = np.load(src)
out = {}

def jax_tree(pre):
    tree = {}
    for k in a.files:
        if k.startswith(pre):
            node = tree
            parts = k[len(pre):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = a[k]
    return tree

def as_lists(node):
    # JAX's GIN layers are a list: keys 0, 1, ... back to a list
    if isinstance(node, dict):
        if node and all(k.isdigit() for k in node):
            return [as_lists(node[str(i)]) for i in range(len(node))]
        return {k: as_lists(v) for k, v in node.items()}
    return node

with set_mesh(mesh):
    bundle = get_bundle("kimi-k2-1t-a32b")
    cfg = bundle.reduced
    params = lm.params_from_jax(jax_tree("kimi|p|"), cfg, "cpu")
    shard_module_(params, bundle.param_specs(params), mesh)
    logits, _ = lm.forward(params, torch.from_numpy(a["tok3"]), cfg)
    assert not parallel.batch_split(3, cfg)
    out["kimi|logits"] = parallel.gather_logits(logits, cfg, False).numpy()

    cfg = dataclasses.replace(get_bundle("llama3-8b").reduced,
                              sharding_mode="fsdp", d_model=64, d_ff=128,
                              vocab=256)
    params = lm.params_from_jax(jax_tree("fsdp|p|"), cfg, "cpu")
    shard_module_(params, lm_param_specs(params, "fsdp"), mesh)
    logits, _ = lm.forward(params, torch.from_numpy(a["tok8"]), cfg)
    out["fsdp|logits"] = parallel.gather_logits(logits, cfg, True).numpy()

    table = torch.from_numpy(a["table"])
    local = shard_tensor(table, P("model", None), mesh)
    for name in ("ids8", "ids3"):
        ids = torch.from_numpy(a[name])
        out["lookup|" + name] = lookup(local, ids).numpy()
        out["lookup_whole|" + name] = lookup(table, ids).numpy()

    gp = gin.params_from_jax(as_lists(jax_tree("gin|p|")),
                             GNNConfig(name="t", n_layers=3, d_hidden=16,
                                       n_classes=4), device="cpu")
    feats, edges = torch.from_numpy(a["feats"]), torch.from_numpy(a["edges"])
    for mode in ("psum", "shard"):
        c = GNNConfig(name="t", n_layers=3, d_hidden=16, n_classes=4,
                      aggregate_mode=mode)
        with torch.no_grad():
            out["gin|" + mode] = gin.forward(gp, feats, edges, c).numpy()

# one wide-deep step with its tables row-sharded and the ids split over
# "data" (a train step on the global batch, as on one device)
from repro_torch.distributed.sharding import gather_tensor, spec_of
from repro_torch.train import AdamWConfig, init_opt_state, make_train_step
wd = get_bundle("wide-deep")
dims = dict(batch=64)
with set_mesh(mesh):
    params = wd.init(0, wd.reduced, dims, device="cpu", mesh=mesh)
    batch = wd.make_batch(np.random.default_rng(0), wd.reduced, dims,
                          "train", device="cpu")
    step = make_train_step(wd.step(wd.reduced, dims, "train"),
                           AdamWConfig(lr=1e-2, warmup_steps=1))
    params, _, m = step(params, init_opt_state(params), batch)
    for n, t in params.named_parameters():
        out["wd|" + n] = gather_tensor(t.detach(), spec_of(t), mesh).numpy()
    out["wd|loss"] = float(m["loss"])

with set_mesh(mesh8), C.recording() as wire:
    g = torch.from_numpy(a["g_local"][rank])
    e = torch.from_numpy(a["e_local"][rank])
    synced, new_e = compressed_psum(dict(w=g), dict(w=e), ("data",))
kinds = [(k, str(d), s) for k, _, d, s in wire]
assert kinds == [("all_reduce", "torch.float32", ()),
                 ("all_reduce", "torch.int32", (64, 32))], kinds
parts = [None] * world
dist.all_gather_object(parts, (synced["w"].numpy(), new_e["w"].numpy()))
out["synced"] = np.stack([p[0] for p in parts])
out["e1"] = np.stack([p[1] for p in parts])
if rank == 0:
    np.savez(dst, **out)
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_parts")
    jout, pout = str(tmp / "jax.npz"), str(tmp / "port.npz")
    code = JAX_CODE.replace("sys.argv[1]", repr(jout))
    assert "OK jax" in run_with_devices(code, n_devices=8, timeout=600)
    run_ranks(RANK_CODE, 8, jout, pout)
    return np.load(jout), np.load(pout)


@pytest.mark.parametrize("what", ["kimi|logits", "fsdp|logits"])
def test_token_poor_moe_and_fsdp_match_jax(runs, what):
    j, p = runs
    np.testing.assert_allclose(p[what], j[what], rtol=1e-5, atol=1e-5)


def test_compressed_psum_is_jax_bitwise(runs):
    j, p = runs
    np.testing.assert_array_equal(p["synced"], j["synced"])
    np.testing.assert_array_equal(p["e1"], j["e1"])
    g_hat = j["g_local"] + j["e_local"]
    scale = np.abs(g_hat).max() / 127.0
    assert np.abs(p["synced"][0] - g_hat.mean(0)).max() < 3 * scale


@pytest.mark.parametrize("ids", ["ids8", "ids3"])
def test_sharded_lookup_is_jax_bitwise(runs, ids):
    j, p = runs
    np.testing.assert_array_equal(p["lookup|" + ids], j["lookup|" + ids])
    np.testing.assert_array_equal(p["lookup_whole|" + ids],
                                  j["lookup|" + ids])


@pytest.mark.parametrize("mode", ["psum", "shard"])
def test_gin_modes_match_jax(runs, mode):
    j, p = runs
    np.testing.assert_allclose(p["gin|" + mode], j["gin|" + mode],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(p["gin|" + mode], j["gin|psum"],
                               rtol=1e-4, atol=1e-4)


def test_wide_deep_step_on_a_mesh_equals_one_device(runs):
    """Tables row-sharded over "model", the 64 ids split over "data":
    the lookup's gradient is summed over the data ranks, so one step
    gives one device's parameters (``allclose(rtol=1e-6, atol=1e-7)``:
    the global norm's sums run in another order)."""
    import torch
    from repro_torch.models.api import get_bundle
    from repro_torch.train import AdamWConfig, init_opt_state, make_train_step
    _, p = runs
    wd = get_bundle("wide-deep")
    dims = dict(batch=64)
    params = wd.init(0, wd.reduced, dims, device="cpu")
    batch = wd.make_batch(np.random.default_rng(0), wd.reduced, dims,
                          "train", device="cpu")
    step = make_train_step(wd.step(wd.reduced, dims, "train"),
                           AdamWConfig(lr=1e-2, warmup_steps=1))
    params, _, m = step(params, init_opt_state(params), batch)
    np.testing.assert_allclose(p["wd|loss"], float(m["loss"]), rtol=1e-6)
    for n, t in params.named_parameters():
        np.testing.assert_allclose(p["wd|" + n], t.detach().numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=n)


def test_every_axis_runs_the_collectives_on_a_world_of_one():
    """A world of one (gloo, this process, mesh (1, 1)): the collectives
    skip axes of size 1, and under ``every_axis`` they run over them,
    each the identity, plain and through autograd; gloo reduces a bf16
    payload in float32, and its reduce-scatter is an all-reduce."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import set_mesh
    from repro_torch.launch.mesh import free_port, make_mesh_for
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh_for(1, 1)
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (8, 16, 32), dtype=np.float32))
        xb = x.to(torch.bfloat16)
        axes = ("data", "model")
        with set_mesh(mesh), C.recording() as skipped:
            assert torch.equal(C.all_reduce(x, axes), x)
        assert skipped == []
        with set_mesh(mesh), C.every_axis(), C.recording() as wire:
            got = [C.all_reduce(xb, axes), C.all_reduce(x, "model", "max"),
                   C.all_gather(xb, 1, axes), C.reduce_scatter(x, 0, axes),
                   C.all_to_all(xb, 0, 2, "model")]
            leaf = x.clone().requires_grad_()
            y = C.gather_sum(C.all_to_all_(C.reduce_from(leaf, axes), 1, 0,
                                           "model"), 0, axes)
            y.square().sum().backward()
        for t in got + [leaf.grad / 2]:
            assert torch.equal(t, xb if t.dtype == torch.bfloat16 else x)
        assert {k for k, *_ in wire} == {"all_reduce", "all_gather",
                                         "all_to_all"}
        assert {str(dt) for k, _, dt, _ in wire if k == "all_reduce"} == {
            "torch.float32"}
    finally:
        dist.destroy_process_group()
