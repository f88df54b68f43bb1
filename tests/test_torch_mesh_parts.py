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
  "data" (8 rows: each rank returns its block of 4, gathered) or
  replicated (3 rows), and a whole table: bitwise.
* GIN, psum and shard modes on (2, 4): ``allclose(rtol=1e-4,
  atol=1e-4)`` to JAX's (its own test's tolerance).
* One wide-deep AdamW step on (2, 4) against the port on one device:
  the gradients within twice JAX's own gap between its (2, 4) and its
  one-device gradient on the same inputs, the update of those gradients
  ``allclose(rtol=1e-6, atol=1e-7)`` (the test's docstring).
* fm, wide-deep, sasrec and bst REDUCED serving (8 rows) and retrieval
  (64 candidates) on (2, 4), the rows split over "data" and the scores
  gathered back, against one device: ``allclose(rtol=1e-5, atol=1e-6)``.
* The same step (the port's parameter draws, carried to JAX) against
  JAX's step jitted on the (2, 4) host mesh
  with the rows split over "data" as GSPMD splits them: the loss
  ``rtol=1e-5`` and the parameters 99.9 % within ``5e-3 * lr`` and all
  within ``lr / 4``, the one-step bounds of ``tests/test_torch_recsys.py``
  (AdamW's first step is about ``lr`` times the gradient's sign).
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

# one wide-deep AdamW step, on one device and on the (2, 4) mesh with the
# rows split over "data" (the dry run's batch specs)
from repro.train import (AdamWConfig as JAdamW, init_opt_state as j_opt,
                         make_train_step as j_step)
wd = get_bundle("wide-deep")
wdims = dict(batch=64)
wp = {}                            # the port's draws (the test's inputs)
for k, v in np.load(WD_PARAMS).items():
    node = wp
    parts = k.split("/")
    for q in parts[:-1]:
        node = node.setdefault(q, {})
    node[parts[-1]] = jnp.asarray(v)
wb = wd.make_batch(np.random.default_rng(0), wd.reduced, wdims, "train")
wstep = jax.jit(j_step(wd.step(wd.reduced, wdims, "train"),
                       JAdamW(lr=1e-2, warmup_steps=1)))
wgrad = jax.jit(jax.grad(wd.step(wd.reduced, wdims, "train")))
flat(wgrad(wp, wb), "wdj|g1|")
p1, _, m1 = wstep(wp, j_opt(wp), wb)
flat(p1, "wdj|one|")
out["wdj|one|loss"] = float(m1["loss"])
with jax.set_mesh(mesh):
    p_sh = put(wp, wd.param_specs(wp))
    b_sh = {k: jax.device_put(v, NamedSharding(
        mesh, P("data") if v.shape[0] > 1 else P())) for k, v in wb.items()}
    flat(wgrad(p_sh, b_sh), "wdj|g8|")
    p8, _, m8 = wstep(p_sh, j_opt(p_sh), b_sh)
flat(p8, "wdj|mesh|")
out["wdj|mesh|loss"] = float(m8["loss"])
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
from repro_torch.models.recsys.embedding import gather_rows, lookup
from repro_torch.models.transformer import lm, parallel
from repro_torch.train.compression import compressed_psum
RECSYS = ("fm", "wide-deep", "sasrec", "bst")
SERVING = dict(serve=dict(batch=8), retrieval=dict(n_candidates=64))
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
        n = ids.shape[0]
        for key, tbl in (("lookup|", local), ("lookup_whole|", table)):
            got = lookup(tbl, ids)
            assert got.shape[0] == (n // 2 if n % 2 == 0 else n), got.shape
            out[key + name] = gather_rows(got, n).numpy()

    gp = gin.params_from_jax(as_lists(jax_tree("gin|p|")),
                             GNNConfig(name="t", n_layers=3, d_hidden=16,
                                       n_classes=4), device="cpu")
    feats, edges = torch.from_numpy(a["feats"]), torch.from_numpy(a["edges"])
    for mode in ("psum", "shard"):
        c = GNNConfig(name="t", n_layers=3, d_hidden=16, n_classes=4,
                      aggregate_mode=mode)
        with torch.no_grad():
            out["gin|" + mode] = gin.forward(gp, feats, edges, c).numpy()

# one wide-deep step with its tables row-sharded and the rows split over
# "data" (a train step on the global batch), and the gradients it takes:
# each rank's, reduced over "data" as the step reduces them
from repro_torch.distributed.sharding import dp_axes, gather_tensor, spec_of
from repro_torch.train import AdamWConfig, init_opt_state, make_train_step
from repro_torch.train.optimizer import reduce_grads
wd = get_bundle("wide-deep")
dims = dict(batch=64)
with set_mesh(mesh):
    params = wd.init(0, wd.reduced, dims, device="cpu", mesh=mesh)
    batch = wd.make_batch(np.random.default_rng(0), wd.reduced, dims,
                          "train", device="cpu")
    loss = wd.step(wd.reduced, dims, "train")
    named = dict(params.named_parameters())
    grads = reduce_grads(dict(zip(named, torch.autograd.grad(
        loss(params, batch), list(named.values())))), params, dp_axes())
    for n, g in grads.items():
        out["wd|g|" + n] = gather_tensor(g, spec_of(named[n]), mesh).numpy()
    step = make_train_step(loss, AdamWConfig(lr=1e-2, warmup_steps=1))
    params, _, m = step(params, init_opt_state(params), batch)
    for n, t in params.named_parameters():
        out["wd|" + n] = gather_tensor(t.detach(), spec_of(t), mesh).numpy()
    out["wd|loss"] = float(m["loss"])

# the recsys serving and retrieval steps: rows split over "data", the
# scores gathered back
for arch in RECSYS:
    b = get_bundle(arch)
    for kind, dims in SERVING.items():
        with set_mesh(mesh):
            params = b.init(0, b.reduced, dims, device="cpu", mesh=mesh)
            batch = b.make_batch(np.random.default_rng(1), b.reduced, dims,
                                 kind, device="cpu")
            out[f"rs|{arch}|{kind}"] = b.step(b.reduced, dims, kind)(
                params, batch).numpy()

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
    from repro_torch.models.api import get_bundle
    tmp = tmp_path_factory.mktemp("mesh_parts")
    jout, pout = str(tmp / "jax.npz"), str(tmp / "port.npz")
    wd_params = str(tmp / "wd_params.npz")
    wd = get_bundle("wide-deep")
    np.savez(wd_params, **{
        n.replace(".", "/"): t.detach().numpy() for n, t in
        wd.init(0, wd.reduced, dict(batch=64), device="cpu"
                ).named_parameters()})
    code = JAX_CODE.replace("sys.argv[1]", repr(jout)).replace(
        "WD_PARAMS", repr(wd_params))
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
    """Tables row-sharded over "model", the 64 rows split over "data"
    (each rank's dense layers on its 32): one AdamW step against one
    device's, in its two parts.

    * The gradients, each summed over the data ranks once: within twice
      JAX's own gap, measured in the same run on the same inputs (JAX's
      gradient jitted on the (2, 4) host mesh with the rows split over
      "data", against its one-device gradient). On this tree: JAX's gap
      9.31e-9, the bound 1.86e-8, the port's gap 1.49e-8.
    * The update: the parameters after the mesh's step against one
      device's ``adamw_update`` of the mesh's gradients,
      ``allclose(rtol=1e-6, atol=1e-7)`` (the global norm's sums run in
      another order; bitwise on this tree).
    * The loss ``rtol=1e-6``.

    The split sums a dense gradient's 64 rows as two sums of 32, in JAX
    as in the port. AdamW's first step moves an element by ``lr * g /
    (|g| + eps)``, so at deep.w0's element 569 (``|g| = 0.25 eps``) it
    multiplies that rounding 6.4e7-fold: the parameters after the step
    differ from one device's by 8.23e-7 there (JAX's own step on the mesh
    by 3.48e-7, at the same element), which is why the bound is held on
    the gradients, where the split acts."""
    import torch
    from repro_torch.models.api import get_bundle
    from repro_torch.train import AdamWConfig, init_opt_state
    from repro_torch.train.optimizer import adamw_update
    j, p = runs
    wd = get_bundle("wide-deep")
    dims = dict(batch=64)
    params = wd.init(0, wd.reduced, dims, device="cpu")
    batch = wd.make_batch(np.random.default_rng(0), wd.reduced, dims,
                          "train", device="cpu")
    named = dict(params.named_parameters())
    loss = wd.step(wd.reduced, dims, "train")(params, batch)
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    np.testing.assert_allclose(p["wd|loss"], float(loss), rtol=1e-6)
    jax_gap = max(float(np.abs(j["wdj|g8|" + n.replace(".", "/")]
                               - j["wdj|g1|" + n.replace(".", "/")]).max())
                  for n in named)
    assert 0 < jax_gap < 1e-7
    for n, g in grads.items():
        gap = float(np.abs(p["wd|g|" + n] - g.numpy()).max())
        assert gap <= 2 * jax_gap, (n, gap, jax_gap)
    with torch.no_grad():
        params, _, _ = adamw_update(
            {n: torch.from_numpy(p["wd|g|" + n]) for n in named},
            init_opt_state(params), params,
            AdamWConfig(lr=1e-2, warmup_steps=1))
    for n, t in params.named_parameters():
        np.testing.assert_allclose(p["wd|" + n], t.detach().numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=n)


@pytest.mark.parametrize("kind", ["serve", "retrieval"])
@pytest.mark.parametrize("arch", ["fm", "wide-deep", "sasrec", "bst"])
def test_recsys_serving_steps_on_a_mesh_equal_one_device(runs, arch, kind):
    """A serving batch of 8 rows and a retrieval over 64 candidates on
    (2, 4): each data rank scores its rows (candidates), and the step
    gathers every score back, as one device scores them
    (``allclose(rtol=1e-5, atol=1e-6)``: a matmul over fewer rows may
    take another kernel)."""
    from repro_torch.models.api import get_bundle
    _, p = runs
    b = get_bundle(arch)
    dims = dict(serve=dict(batch=8), retrieval=dict(n_candidates=64))[kind]
    params = b.init(0, b.reduced, dims, device="cpu")
    batch = b.make_batch(np.random.default_rng(1), b.reduced, dims, kind,
                         device="cpu")
    want = b.step(b.reduced, dims, kind)(params, batch).numpy()
    got = p[f"rs|{arch}|{kind}"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


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


def test_wide_deep_step_on_a_mesh_matches_jax_on_the_mesh(runs):
    """The port's wide-deep step on (2, 4), its rows split over "data",
    against JAX's step jitted on the same mesh from the same parameters
    (the port's draws) and batch (the module docstring's bounds)."""
    j, p = runs
    lr = 1e-2
    np.testing.assert_allclose(p["wd|loss"], j["wdj|mesh|loss"], rtol=1e-5)
    names = [k[len("wdj|mesh|"):] for k in j.files
             if k.startswith("wdj|mesh|") and k != "wdj|mesh|loss"]
    assert len(names) == 10
    for n in names:
        d = np.abs(p["wd|" + n.replace("/", ".")] - j["wdj|mesh|" + n])
        assert d.max() <= lr / 4, (n, d.max())
        assert np.mean(d > 5e-3 * lr) <= 1e-3, (n, d.max())
