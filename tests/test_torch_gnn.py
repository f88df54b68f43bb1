"""Port parity: the GNN family (``configs.gin_tu``, ``models.gnn.gin``
and ``sampler``, ``data.pipeline.random_graph`` and ``models.api``'s GNN
bundle) against the JAX package on the REDUCED config in float32, JAX's
``init_params`` weights carried across by ``gin.params_from_jax``.

The port sums each node's messages in order over edges sorted by
destination (``gin.Aggregate``), where JAX scatter-adds them, so the sums
run in another order. Tolerances, float32:
* ``_aggregate`` and ``segment_sum`` ``allclose(rtol=1e-5, atol=1e-5)``
  (the hand-built graph: equal);
* forward ``allclose(rtol=1e-4, atol=1e-4)`` (5 layers of sums of about
  8 neighbours through an MLP each);
* losses ``rtol=1e-5``; gradients per leaf ``|g - g_jax| <= 2e-5 *
  max|g_jax|``, the bound of ``tests/test_torch_train.py``;
* 3 train steps: losses ``rtol=1e-4``; every parameter within ``lr * n /
  4``, and within ``5e-3 * lr * n`` unless its gradient was float32
  noise at some step (below ``1e-7`` of its leaf's largest: AdamW
  normalises such a gradient to a step of up to ``lr``, in either
  package, from its last bits);
* the chunked aggregate against one chunk, ``make_batch``,
  ``random_graph``, ``CSRGraph``, ``sample_subgraph`` and the
  ``params_to_jax`` round trip: bitwise.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import gin_tu as j_gin_tu
from repro.data.pipeline import random_graph as j_random_graph
from repro.models.api import get_bundle as j_get_bundle
from repro.models.gnn import gin as j_gin
from repro.models.gnn import sampler as j_sampler
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import init_opt_state as j_init_opt_state
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import gin_tu
from repro_torch.data.pipeline import random_graph
from repro_torch.models.api import get_bundle
from repro_torch.models.gnn import gin, sampler
from repro_torch.train import AdamWConfig, init_opt_state, make_train_step

GRAD_ATOL = 2e-5          # of the leaf's largest element
STEP_ATOL = 5e-3          # of lr, per step taken (99.9 % of elements)
STEP_MAX = 0.25           # of lr, per step taken (every element)
NOISE = 1e-7              # a gradient below this share of its leaf's largest
# the four GNN_SHAPES cells at CPU sizes (the published cells' keys)
CELLS = {
    "full_graph_sm": dict(n_nodes=120, n_edges=600, d_feat=24, n_classes=7),
    "minibatch_lg": dict(n_nodes=400, n_edges=4000, batch_nodes=8,
                         fanout=(4, 3), d_feat=20, n_classes=5),
    "ogb_products": dict(n_nodes=700, n_edges=5000, d_feat=12,
                         n_classes=6),
    "molecule": dict(n_nodes=10, n_edges=24, batch=6, d_feat=8,
                     n_classes=2),
}


def _named(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = np.asarray(leaf)
    return out


def _batches(cell, seed=0):
    dims = CELLS[cell]
    mine = get_bundle("gin-tu").make_batch(np.random.default_rng(seed),
                                           gin_tu.REDUCED, dims, "train",
                                           device="cpu")
    theirs = j_get_bundle("gin-tu").make_batch(np.random.default_rng(seed),
                                               j_gin_tu.REDUCED, dims,
                                               "train")
    return mine, theirs


def _models(cell, seed=1):
    dims = CELLS[cell]
    jparams = jax.jit(j_gin.init_params, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(seed), j_gin_tu.REDUCED, dims["d_feat"],
        dims["n_classes"])
    params = gin.params_from_jax(jax.tree.map(np.asarray, jparams),
                                 gin_tu.REDUCED, device="cpu")
    return jparams, params


def test_config_matches_jax():
    for name in ("CONFIG", "REDUCED"):
        mine, theirs = getattr(gin_tu, name), getattr(j_gin_tu, name)
        assert type(mine).__name__ == type(theirs).__name__ == "GNNConfig"
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.family == theirs.family == "gnn"
    assert [(c.name, c.kind, c.dims, c.skip) for c in gin_tu.SHAPES] \
        == [(c.name, c.kind, c.dims, c.skip) for c in j_gin_tu.SHAPES]


# ------------------------------------------------------------ aggregate

def test_aggregate_on_the_hand_built_graph():
    """JAX's own case (tests/test_arch_smoke.py): sum_{j in N(i)} h_j."""
    h = torch.tensor([[1.0], [2.0], [4.0], [0.0]], requires_grad=True)
    edges = torch.tensor([[0, 1], [1, 0], [2, 1], [3, 3]], dtype=torch.int32)
    agg = gin._aggregate(h, edges, 4)
    want = j_gin._aggregate(jnp.asarray(h.detach().numpy()),
                            jnp.asarray(edges.numpy()), 4)
    np.testing.assert_array_equal(agg[:, 0].detach().numpy(),
                                  [2.0, 5.0, 0.0, 0.0])
    np.testing.assert_array_equal(agg.detach().numpy(), np.asarray(want))
    # the backward sums over the sources: d sum(w * agg) / d h_j = sum of
    # w over j's destinations
    w = torch.tensor([[1.0], [10.0], [100.0], [1000.0]])
    (g,) = torch.autograd.grad((w * agg).sum(), h)
    np.testing.assert_array_equal(g[:, 0].numpy(), [10.0, 1.0, 10.0, 1000.0])


@pytest.mark.parametrize("chunk", [7, 64, 1 << 23])
def test_aggregate_matches_jax_and_chunks_are_exact(chunk):
    rng = np.random.default_rng(2)
    n, e, d = 50, 400, 6
    h = rng.standard_normal((n, d)).astype(np.float32)
    edges = rng.integers(0, n, (e, 2)).astype(np.int32)
    edges[:20, 1] = 3                          # a node of high degree
    want = np.asarray(j_gin._aggregate(jnp.asarray(h), jnp.asarray(edges), n))
    ht = torch.from_numpy(h).requires_grad_(True)
    et = torch.from_numpy(edges)
    got = gin._aggregate(ht, et, n, gin.edge_plan(et, n, chunk))
    one = gin._aggregate(ht, et, n, gin.edge_plan(et, n, 1 << 30))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got, one)
    # backward: A^T g, against a dense float64 incidence
    g = torch.from_numpy(rng.standard_normal((n, d)))
    (gh,) = torch.autograd.grad(got, ht, g.float())
    a = np.zeros((n, n))
    np.add.at(a, (edges[:, 1], edges[:, 0]), 1.0)
    np.testing.assert_allclose(gh.numpy(), a.T @ g.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_segment_sum_matches_jax():
    rng = np.random.default_rng(3)
    data = rng.standard_normal((40, 5)).astype(np.float32)
    ids = rng.integers(0, 7, 40).astype(np.int32)       # unsorted, gaps
    ids[ids == 4] = 5                                   # an empty segment
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(data),
                                          jnp.asarray(ids), 7))
    got = gin.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="segment id"):
        gin.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 5)


# --------------------------------------------------- forward and losses

@pytest.mark.parametrize("cell", list(CELLS))
def test_forward_loss_and_grads_match_jax(cell):
    jparams, params = _models(cell)
    mine, theirs = _batches(cell, seed=4)
    cfg, jcfg = gin_tu.REDUCED, j_gin_tu.REDUCED
    with torch.no_grad():
        h = gin.forward(params, mine["feats"], mine["edges"], cfg)
    jh = jax.jit(j_gin.forward, static_argnums=3)(
        jparams, theirs["feats"], theirs["edges"], jcfg)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-4)
    jloss, jgrads = jax.jit(jax.value_and_grad(j_get_bundle("gin-tu").step(
        jcfg, CELLS[cell], "train")))(jparams, theirs)
    loss = get_bundle("gin-tu").step(cfg, CELLS[cell], "train")(params, mine)
    named = dict(params.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = _named(jgrads)
    assert set(grads) == set(want)
    for name, g in grads.items():
        tol = GRAD_ATOL * max(float(np.abs(want[name]).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), want[name], rtol=0, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("cell", ["full_graph_sm", "molecule"])
def test_three_train_steps_match_jax(cell):
    """3 steps against JAX's jitted step. An element whose gradient is
    float32 cancellation noise (below ``NOISE`` of its leaf's largest, in
    JAX's gradient at some step) takes an AdamW step of up to ``lr`` on
    that noise in either package, so it is held only to ``lr * n / 4``;
    every other element to ``5e-3 * lr * n``. (molecule's readout sums
    cancel: 3 of layer 1's 256 weights, with gradients of 7e-8 where the
    largest is 4.2, moved 0.011 lr in 3 steps.)"""
    jparams, params = _models(cell, seed=5)
    ocfg = dict(lr=3e-3, warmup_steps=1, total_steps=20)
    jloss_fn = j_get_bundle("gin-tu").step(j_gin_tu.REDUCED, CELLS[cell],
                                           "train")
    jgrad = jax.jit(jax.grad(jloss_fn))
    jstep = jax.jit(j_make_train_step(jloss_fn, JAdamWConfig(**ocfg)))
    step = make_train_step(get_bundle("gin-tu").step(
        gin_tu.REDUCED, CELLS[cell], "train"), AdamWConfig(**ocfg))
    jo, o = j_init_opt_state(jparams), init_opt_state(params)
    noise = {}
    for i in range(3):
        mine, theirs = _batches(cell, seed=20 + i)
        for name, g in _named(jgrad(jparams, theirs)).items():
            tiny = np.abs(g) <= NOISE * np.abs(g).max()
            noise[name] = noise.get(name, False) | tiny
        jparams, jo, jm = jstep(jparams, jo, theirs)
        params, o, m = step(params, o, mine)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
    want = _named(jparams)
    lr3 = ocfg["lr"] * 3
    for name, p in params.named_parameters():
        d = np.abs(p.detach().numpy() - want[name])
        assert d.max() <= STEP_MAX * lr3, (name, d.max())
        assert (d[~noise[name]] <= STEP_ATOL * lr3).all(), (name, d.max())


def test_a_train_step_repeats_bitwise():
    """Two runs of a step from one seed give the same parameters."""
    out = []
    for _ in range(2):
        bundle = get_bundle("gin-tu")
        dims = CELLS["ogb_products"]
        params = bundle.init(0, gin_tu.REDUCED, dims, device="cpu")
        step = make_train_step(bundle.step(gin_tu.REDUCED, dims, "train"),
                               AdamWConfig(lr=1e-2, warmup_steps=1))
        batch = bundle.make_batch(np.random.default_rng(0), gin_tu.REDUCED,
                                  dims, "train", device="cpu")
        params, _, _ = step(params, init_opt_state(params), batch)
        out.append([p.detach().clone() for p in params.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*out))


# ---------------------------------------------------- data and weights

@pytest.mark.parametrize("cell", list(CELLS))
def test_make_batch_matches_jax(cell):
    mine, theirs = _batches(cell, seed=6)
    specs = get_bundle("gin-tu").batch_specs(gin_tu.REDUCED, CELLS[cell],
                                             "train")
    assert list(mine) == list(theirs) == list(specs)
    for k, v in mine.items():
        assert v.dtype == specs[k].dtype and tuple(v.shape) == specs[k].shape
        np.testing.assert_array_equal(v.numpy(), np.asarray(theirs[k]),
                                      err_msg=k)


def test_full_size_specs_match_jax():
    """The published cells' padded shapes (no arrays drawn)."""
    for cell in gin_tu.SHAPES:
        mine = get_bundle("gin-tu").batch_specs(gin_tu.CONFIG, cell.dims,
                                                cell.kind)
        theirs = j_get_bundle("gin-tu").batch_specs(j_gin_tu.CONFIG,
                                                    cell.dims, cell.kind)
        assert {k: s.shape for k, s in mine.items()} \
            == {k: s.shape for k, s in theirs.items()}
    ogb = get_bundle("gin-tu").batch_specs(
        gin_tu.CONFIG, gin_tu.SHAPES[2].dims, "train")
    assert ogb["feats"].shape[0] == 2_449_408
    assert ogb["edges"].shape[0] == 61_859_328


def test_random_graph_is_jax_bit_for_bit():
    mine = random_graph(300, 2000, 9, 5, seed=3)
    theirs = j_random_graph(300, 2000, 9, 5, seed=3)
    assert list(mine) == list(theirs)
    for k in mine:
        assert mine[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    small = random_graph(50, 80, 3, 6, seed=1)      # d_feat < n_classes
    np.testing.assert_array_equal(small["feats"],
                                  j_random_graph(50, 80, 3, 6, seed=1)["feats"])


def test_csr_graph_and_sampler_are_jax_bit_for_bit():
    g = random_graph(400, 4000, 10, 4, seed=2)
    n = g["feats"].shape[0]
    mine, theirs = sampler.CSRGraph(n, g["edges"]), \
        j_sampler.CSRGraph(n, g["edges"])
    np.testing.assert_array_equal(mine.nbr, theirs.nbr)
    np.testing.assert_array_equal(mine.offsets, theirs.offsets)
    assert sampler.subgraph_shapes(8, (4, 3)) \
        == j_sampler.subgraph_shapes(8, (4, 3))
    seeds = np.random.default_rng(0).choice(400, 8, replace=False)
    a = sampler.sample_subgraph(np.random.default_rng(5), mine, seeds, (4, 3),
                                g["feats"], g["labels"])
    b = j_sampler.sample_subgraph(np.random.default_rng(5), theirs, seeds,
                                  (4, 3), g["feats"], g["labels"])
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the sampled batch trains through the bundle's node loss
    params = get_bundle("gin-tu").init(0, gin_tu.REDUCED, dict(
        d_feat=10, n_classes=4), device="cpu")
    loss = gin.node_loss(params, {k: torch.from_numpy(v)
                                  for k, v in a.items()}, gin_tu.REDUCED)
    assert torch.isfinite(loss)


def test_params_to_jax_inverts_params_from_jax():
    jparams, params = _models("minibatch_lg")
    back = gin.params_to_jax(params, gin_tu.REDUCED)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jparams))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    mine = gin.params_to_jax(get_bundle("gin-tu").init(
        0, gin_tu.REDUCED, CELLS["minibatch_lg"], device="cpu"),
        gin_tu.REDUCED)
    assert jax.tree.structure(mine) == jax.tree.structure(back)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(back)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
