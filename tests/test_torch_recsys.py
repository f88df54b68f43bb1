"""Port parity: the recsys family (``configs`` fm / wide-deep / sasrec /
bst, ``models.common``'s layer_norm, MLP and BCE, ``models.recsys``,
``data.pipeline.recsys_log_stream`` and ``models.api``'s recsys bundles)
against the JAX package on the REDUCED configs in float32, JAX's
``init_params`` weights carried across by each module's
``params_from_jax``.

Tolerances, float32 (the same sums in another order in XLA and PyTorch):
* forward, serving and retrieval scores ``allclose(rtol=2e-5,
  atol=2e-5)``;
* losses ``rtol=1e-5``; gradients per leaf ``|g - g_jax| <= 2e-5 *
  max|g_jax|``, the bound of ``tests/test_torch_train.py``;
* 3 train steps: losses ``rtol=1e-4``; the parameters 99.9 % within
  ``5e-3 * lr * n`` and all within ``lr * n / 4`` of JAX's, the bounds
  of ``tests/test_torch_train.py`` (AdamW normalises each step to about
  ``lr``, so a last-bit difference in a near-zero gradient can flip an
  element's step);
* ``make_batch``, ``recsys_log_stream`` and ``params_to_jax`` of
  ``params_from_jax``: bitwise; retrieval shortcuts against the full
  forward of the same candidates and bst's chunked retrieval against
  the unchunked one ``allclose(rtol=2e-5, atol=2e-5)``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as j_get_arch
from repro.data.pipeline import recsys_log_stream as j_log_stream
from repro.models.api import get_bundle as j_get_bundle
from repro.models.common import layer_norm as j_layer_norm
from repro.models.recsys import bst as j_bst
from repro.models.recsys import embedding as j_embedding
from repro.models.recsys import fm as j_fm
from repro.models.recsys import sasrec as j_sasrec
from repro.models.recsys import wide_deep as j_wide_deep
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import init_opt_state as j_init_opt_state
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import recsys_log_stream
from repro_torch.models.api import get_bundle
from repro_torch.models.common import layer_norm
from repro_torch.models.recsys import bst, embedding, fm, sasrec, wide_deep
from repro_torch.train import AdamWConfig, init_opt_state, make_train_step

RTOL = ATOL = 2e-5
GRAD_ATOL = 2e-5          # of the leaf's largest element
STEP_ATOL = 5e-3          # of lr, per step taken (99.9 % of elements)
STEP_MAX = 0.25           # of lr, per step taken (every element)
ARCHS = {"fm": (fm, j_fm), "wide-deep": (wide_deep, j_wide_deep),
         "sasrec": (sasrec, j_sasrec), "bst": (bst, j_bst)}
KINDS = {"train": dict(batch=16), "serve": dict(batch=8),
         "retrieval": dict(batch=1, n_candidates=700)}   # 700 -> 1,024


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _named(tree) -> dict:
    """A JAX pytree's leaves by dotted path (list indices as numbers),
    the names ``named_parameters`` gives the port's ``ParamTree``."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = np.asarray(leaf)
    return out


def _batches(arch, kind, seed=0):
    """The port's and JAX's ``make_batch`` from one seed."""
    mine, theirs = get_bundle(arch), j_get_bundle(arch)
    dims = KINDS[kind]
    return (mine.make_batch(np.random.default_rng(seed), mine.reduced, dims,
                            kind, device="cpu"),
            theirs.make_batch(np.random.default_rng(seed), theirs.reduced,
                              dims, kind))


@pytest.fixture(scope="module", params=list(ARCHS))
def model(request):
    """(arch, port config, JAX config, JAX params, the port's params)."""
    arch = request.param
    mod, jmod = ARCHS[arch]
    jcfg = j_get_arch(arch).REDUCED
    cfg = get_arch(arch).REDUCED
    jparams = jax.jit(jmod.init_params, static_argnums=1)(
        jax.random.PRNGKey(1), jcfg)
    params = mod.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                 device="cpu")
    return arch, cfg, jcfg, jparams, params


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", list(ARCHS))
def test_configs_match_jax(arch):
    port, ref = get_arch(arch), j_get_arch(arch)
    for name in ("CONFIG", "REDUCED"):
        mine, theirs = getattr(port, name), getattr(ref, name)
        assert type(mine).__name__ == type(theirs).__name__
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.family == theirs.family == "recsys"
        assert mine.total_rows() == theirs.total_rows()
    assert [(c.name, c.kind, c.dims, c.skip) for c in port.SHAPES] \
        == [(c.name, c.kind, c.dims, c.skip) for c in ref.SHAPES]


# -------------------------------------------------------------- layers

def test_layer_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32) * 3 + 1
    s = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    want = np.asarray(j_layer_norm(jnp.asarray(x), jnp.asarray(s),
                                   jnp.asarray(b)))
    got = layer_norm(*map(torch.from_numpy, (x, s, b))).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_jax(mode):
    rng = np.random.default_rng(1)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, (6, 5)).astype(np.int32)
    mask = rng.random((6, 5)) < 0.6
    mask[0] = False                                  # an empty bag
    want = np.asarray(j_embedding.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(mask), mode))
    got = embedding.embedding_bag(torch.from_numpy(table),
                                  torch.from_numpy(ids),
                                  torch.from_numpy(mask), mode).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert not got[0].any()


def test_field_offsets_and_padded_rows_match_jax():
    rows = get_arch("fm").CONFIG.table_rows
    np.testing.assert_array_equal(embedding.field_offsets(rows),
                                  j_embedding.field_offsets(rows))
    for n in (1, 512, 513, 9_660_000, 1_000_001):
        assert embedding.padded_rows(n) == j_embedding.padded_rows(n)
    assert embedding.padded_rows(sum(rows)) == 9_660_416


def test_fm_pairwise_identity():
    """The sum-square identity against the explicit sum over pairs i < j
    of <v_i x_i, v_j x_j>, in float64."""
    cfg = get_arch("fm").REDUCED
    params = fm.init_params(cfg, seed=3, device="cpu")
    with torch.no_grad():
        params["w_lin"].zero_()
        params["v_dense"].mul_(50)
        params["v"].mul_(50)
    mine, _ = _batches("fm", "serve", seed=4)
    with torch.no_grad():
        got = fm.forward(params, mine["ids"], mine["dense"], cfg).double()
    offs = torch.from_numpy(embedding.field_offsets(cfg.table_rows))
    v = params["v"].detach().double()[mine["ids"].long() + offs]
    vd = params["v_dense"].detach().double()[None] \
        * mine["dense"].double()[..., None]
    vx = torch.cat([v, vd], 1)
    f = vx.shape[1]
    pair = sum((vx[:, i] * vx[:, j]).sum(-1)
               for i in range(f) for j in range(i + 1, f))
    np.testing.assert_allclose(got.numpy(), pair.numpy(), rtol=1e-4,
                               atol=1e-5)


# ------------------------------------------------- forward and serving

def test_forward_and_serve_match_jax(model):
    arch, cfg, jcfg, jparams, params = model
    mine, theirs = _batches(arch, "serve", seed=2)
    got = get_bundle(arch).step(cfg, {}, "serve")(params, _t(mine))
    want = jax.jit(j_get_bundle(arch).step(jcfg, {}, "serve"))(jparams,
                                                               theirs)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    if arch == "sasrec":     # the states of every position too
        with torch.no_grad():
            h = sasrec.forward(params, mine["seq"], cfg)
        jh = jax.jit(j_sasrec.forward, static_argnums=2)(
            jparams, theirs["seq"], jcfg)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=RTOL,
                                   atol=ATOL)


def test_retrieval_matches_jax(model):
    arch, cfg, jcfg, jparams, params = model
    mine, theirs = _batches(arch, "retrieval", seed=3)
    assert mine["cand"].shape == (1024,)
    got = get_bundle(arch).step(cfg, {}, "retrieval")(params, mine)
    want = jax.jit(j_get_bundle(arch).step(jcfg, {}, "retrieval"))(
        jparams, theirs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_retrieval_shortcuts_equal_the_full_scoring(model):
    """fm's ``[C, D] @ [D]`` shortcut against ``forward`` with each
    candidate in field 0; sasrec's against ``serve_step`` of the same
    candidates; bst's chunked retrieval against one unchunked forward."""
    arch, cfg, _, _, params = model
    mine, _ = _batches(arch, "retrieval", seed=5)
    got = get_bundle(arch).step(cfg, {}, "retrieval")(params, mine)
    c = mine["cand"].shape[0]
    with torch.no_grad():
        if arch in ("fm", "wide-deep"):
            ids = torch.cat([mine["cand"][:, None],
                             mine["ids"].expand(c, -1)], 1)
            mod = fm if arch == "fm" else wide_deep
            want = mod.forward(params, ids, mine["dense"].expand(c, -1), cfg)
        elif arch == "sasrec":
            want = sasrec.serve_step(params, dict(
                seq=mine["seq"], cand=mine["cand"][None]), cfg)[0]
        else:
            want = bst.forward(params, mine["seq"].expand(c, -1),
                               mine["cand"], cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_bst_retrieval_chunks_are_exact(monkeypatch):
    cfg = get_arch("bst").REDUCED
    params = bst.init_params(cfg, seed=1, device="cpu")
    mine, _ = _batches("bst", "retrieval", seed=6)
    whole = bst.retrieval_step(params, mine, cfg)
    monkeypatch.setattr(bst, "RETRIEVAL_CHUNK", 300)     # 4 chunks, ragged
    chunked = bst.retrieval_step(params, mine, cfg)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=RTOL,
                               atol=ATOL)


# ------------------------------------------------------------ training

def test_loss_and_grads_match_jax(model):
    arch, cfg, jcfg, jparams, params = model
    mine, theirs = _batches(arch, "train", seed=7)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        j_get_bundle(arch).step(jcfg, {}, "train")))(jparams, theirs)
    loss = get_bundle(arch).step(cfg, {}, "train")(params, mine)
    named = dict(params.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    want = _named(jgrads)
    assert set(grads) == set(want)
    for name, g in grads.items():
        tol = GRAD_ATOL * max(float(np.abs(want[name]).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), want[name], rtol=0, atol=tol,
                                   err_msg=name)


def test_three_train_steps_match_jax(model):
    arch, cfg, jcfg, jparams, _ = model
    mod, _ = ARCHS[arch]
    params = mod.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                 device="cpu")
    ocfg = dict(lr=3e-3, warmup_steps=1, total_steps=20)
    jstep = jax.jit(j_make_train_step(j_get_bundle(arch).step(
        jcfg, {}, "train"), JAdamWConfig(**ocfg), microbatches=2))
    step = make_train_step(get_bundle(arch).step(cfg, {}, "train"),
                           AdamWConfig(**ocfg), microbatches=2)
    jo, o = j_init_opt_state(jparams), init_opt_state(params)
    for i in range(3):
        mine, theirs = _batches(arch, "train", seed=10 + i)
        jparams, jo, jm = jstep(jparams, jo, theirs)
        params, o, m = step(params, o, mine)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
    want = _named(jparams)
    for name, p in params.named_parameters():
        d = np.abs(p.detach().numpy() - want[name])
        lr3 = ocfg["lr"] * 3
        assert d.max() <= STEP_MAX * lr3, (name, d.max())
        assert np.mean(d > STEP_ATOL * lr3) <= 1e-3, (name, d.max())
    assert int(o["step"]) == int(jo["step"]) == 3


# ---------------------------------------------------- data and weights

@pytest.mark.parametrize("kind", ["train", "serve", "retrieval"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_make_batch_matches_jax(arch, kind):
    mine, theirs = _batches(arch, kind, seed=11)
    assert list(mine) == list(theirs)
    specs = get_bundle(arch).batch_specs(get_arch(arch).REDUCED,
                                         KINDS[kind], kind)
    for k, v in mine.items():
        want = np.asarray(theirs[k])
        assert v.dtype == specs[k].dtype and tuple(v.shape) == specs[k].shape
        assert v.numpy().dtype == want.dtype, k
        np.testing.assert_array_equal(v.numpy(), want, err_msg=k)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_recsys_log_stream_is_jax_bit_for_bit(arch):
    cfg = get_arch(arch).REDUCED
    mine = recsys_log_stream(cfg, 32, seed=3, shard_id=1)()
    theirs = j_log_stream(j_get_arch(arch).REDUCED, 32, seed=3, shard_id=1)()
    for _ in range(3):
        a, b = next(mine), next(theirs)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_params_to_jax_inverts_params_from_jax(model):
    arch, cfg, _, jparams, params = model
    mod, _ = ARCHS[arch]
    back = mod.params_to_jax(params, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jparams))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    bad = jax.tree.map(np.asarray, jparams)
    bad.pop(next(iter(bad)))
    with pytest.raises(ValueError, match="paths differ"):
        mod.params_from_jax(bad, cfg, device="cpu")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_matches_the_jax_tree(arch):
    """The port's draws have the JAX tree's paths, shapes and dtypes."""
    mod, jmod = ARCHS[arch]
    cfg = get_arch(arch).REDUCED
    mine = mod.params_to_jax(mod.init_params(cfg, seed=0, device="cpu"), cfg)
    theirs = jax.eval_shape(lambda: jmod.init_params(
        jax.random.PRNGKey(0), j_get_arch(arch).REDUCED))
    assert jax.tree.structure(mine) == jax.tree.structure(theirs)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bundle = get_bundle("sasrec")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bundle.init(0, bundle.reduced, {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bundle.make_batch(np.random.default_rng(0), bundle.reduced,
                          dict(batch=2), "train")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sasrec.params_from_jax({}, bundle.reduced)
