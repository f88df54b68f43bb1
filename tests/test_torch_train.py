"""Port parity: LM training (``models.common.cross_entropy``,
``lm.loss_fn`` and ``forward_train`` with remat, ``train.optimizer``,
``train.train_step``, ``data.pipeline``) against the JAX package on the
REDUCED configs in float32, JAX's ``init_params`` weights carried across
by ``params_from_jax`` and the gradients compared leaf by leaf in the JAX
layout (``lm.to_jax_layout``).

Tolerances, float32:
* losses ``rtol=1e-5``; gradients per leaf ``|g - g_jax| <= 2e-5 *
  max|g_jax|`` (the same sums in another order in XLA and PyTorch; the
  worst leaf measured 3.2e-6 of its largest element, gemma3);
* ``schedule``, ``global_norm`` and the moments ``rtol=1e-6``: XLA's and
  PyTorch's ``cosf``/``powf`` and the order of a norm's sums may differ
  in the last bit;
* one ``adamw_update`` on a bf16 tree: every parameter equal or one bf16
  ulp apart, since each is rounded once from a float32 value that may
  differ in its last bits;
* train steps and the 5-step trajectory: losses ``rtol=1e-4``; the
  parameters after n steps 99.9 % within ``5e-3 * lr * n`` and all
  within ``lr * n / 4``: AdamW normalises each step to about ``lr``, so a
  last-bit difference in a near-zero gradient can flip an element's step
  (one of 16,384 elements of llama3's embedding moved 0.044 lr in 5
  steps at 2 microbatches);
* remat modes give bitwise equal losses and gradients (the same
  products, recomputed).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import deepseek_v2_lite_16b as j_deepseek
from repro.configs import gemma3_27b as j_gemma
from repro.configs import kimi_k2_1t_a32b as j_kimi
from repro.configs import llama3_8b as j_llama
from repro.data.pipeline import PrefetchLoader as JPrefetchLoader
from repro.data.pipeline import lm_token_stream as j_token_stream
from repro.models.common import cross_entropy as j_cross_entropy
from repro.models.transformer import lm as jlm
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import adamw_update as j_adamw_update
from repro.train import init_opt_state as j_init_opt_state
from repro.train import make_train_step as j_make_train_step
from repro.train.optimizer import global_norm as j_global_norm
from repro.train.optimizer import schedule as j_schedule
from repro_torch.configs import (deepseek_v2_lite_16b, gemma3_27b,
                                 kimi_k2_1t_a32b, llama3_8b)
from repro_torch.data.pipeline import PrefetchLoader, lm_token_stream
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import cross_entropy
from repro_torch.models.transformer import lm
from repro_torch.train import (AdamWConfig, adamw_update, init_opt_state,
                               make_train_step)
from repro_torch.train.optimizer import global_norm, schedule

ARCHS = {"llama3-8b": (llama3_8b, j_llama, 16),
         "gemma3-27b": (gemma3_27b, j_gemma, 40),        # windows of 16
         "deepseek-v2-lite-16b": (deepseek_v2_lite_16b, j_deepseek, 12),
         "kimi-k2-1t-a32b": (kimi_k2_1t_a32b, j_kimi, 12)}
GRAD_ATOL = 2e-5          # of the leaf's largest element
STEP_ATOL = 5e-3          # of lr, per step taken (99.9 % of elements)
STEP_MAX = 0.25           # of lr, per step taken (every element)


def _np(a) -> np.ndarray:
    """A JAX array as float32 numpy (bf16 widens exactly)."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _jax_model(arch, seed=3):
    port, ref, _ = ARCHS[arch]
    params = jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(seed), ref.REDUCED)
    mod = lm.params_from_jax(jax.tree.map(_np, params), port.REDUCED, "cpu")
    return port.REDUCED, ref.REDUCED, params, mod


def _batch(vocab, b, s, seed=0, pad=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels[0, s - pad:] = -1                     # padding
    return dict(tokens=toks, labels=labels)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grads(mod, loss):
    named = dict(mod.named_parameters())
    gs = torch.autograd.grad(loss, list(named.values()))
    return dict(zip(named, gs))


def _assert_tree_close(tree, jtree, atol_of_max=GRAD_ATOL):
    """Port tree (JAX layout, tensors) against a JAX pytree, leaf by leaf
    in ``jax.tree_util`` order, each within ``atol_of_max`` of its
    largest element."""
    mine = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.detach().float().numpy(), tree))[0]
    theirs = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert [p for p, _ in mine] == [p for p, _ in theirs]
    for (path, a), (_, b) in zip(mine, theirs):
        b = _np(b)
        tol = atol_of_max * max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a, b, rtol=0, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------------------------ loss

@pytest.mark.parametrize("shape", [(2, 7, 33), (5, 11)])
def test_cross_entropy_matches_jax_with_padding(shape):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal(shape) * 3).astype(np.float32)
    labels = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    labels.reshape(-1)[::3] = -1
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    want = j_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    all_pad = np.full(shape[:-1], -1, np.int32)
    assert float(cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(all_pad))) == 0.0


def test_cross_entropy_of_bf16_logits_runs_in_float32():
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal((4, 50)).astype(
        np.float32)).bfloat16()
    labels = torch.from_numpy(rng.integers(0, 50, 4))
    want = j_cross_entropy(jnp.asarray(logits.float().numpy(),
                                       jnp.bfloat16), jnp.asarray(labels))
    np.testing.assert_allclose(float(cross_entropy(logits, labels)),
                               float(want), rtol=1e-6)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_and_grads_match_jax(arch):
    """``loss_fn`` and its gradient against ``jax.value_and_grad`` of the
    JAX ``loss_fn`` (plain attention, the REDUCED configs' remat
    "dots"): gemma3's local and global windows, deepseek's MLA and MoE
    (with the aux loss), kimi's MoE at D 16."""
    cfg, jcfg, jparams, mod = _jax_model(arch)
    batch = _batch(cfg.vocab, 2, ARCHS[arch][2])
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, b, jcfg)))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss = lm.loss_fn(mod, _torch_batch(batch), cfg)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    _assert_tree_close(lm.to_jax_layout(_grads(mod, loss)), jgrads)


def test_moe_aux_loss_reaches_the_router():
    cfg, _, _, mod = _jax_model("deepseek-v2-lite-16b")
    tokens = torch.from_numpy(_batch(cfg.vocab, 2, 12)["tokens"])
    _, aux = lm.forward_train(mod, tokens, cfg)
    (g,) = torch.autograd.grad(aux, [mod.layers[0].ffn.router])
    assert float(aux) > 0 and bool(g.abs().sum() > 0)


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v2-lite-16b"])
def test_remat_modes_give_equal_losses_and_grads(arch):
    cfg, _, _, mod = _jax_model(arch)
    batch = _torch_batch(_batch(cfg.vocab, 2, ARCHS[arch][2]))
    out = {}
    for remat in ("none", "full", "dots"):
        c = dataclasses.replace(cfg, remat=remat)
        loss = lm.loss_fn(mod, batch, c)
        out[remat] = (loss.detach(), _grads(mod, loss))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        for name, g in out["none"][1].items():
            assert torch.equal(out[remat][1][name], g), (remat, name)
    with pytest.raises(ValueError, match="remat"):
        lm.loss_fn(mod, batch, dataclasses.replace(cfg, remat="some"))


def test_forward_is_forward_train_without_autograd():
    cfg, _, _, mod = _jax_model("llama3-8b")
    tokens = torch.from_numpy(_batch(cfg.vocab, 2, 16)["tokens"])
    logits, _ = lm.forward(mod, tokens, cfg)
    train_logits, _ = lm.forward_train(mod, tokens, cfg)
    assert not logits.requires_grad and train_logits.requires_grad
    assert torch.equal(logits, train_logits.detach())


def test_loss_with_the_kernel_raises_under_autograd():
    """The flash_attention kernel has no backward (nor has the JAX one):
    under autograd it raises on every device instead of returning an
    output detached from q, k and v; without autograd it runs."""
    cfg, _, _, mod = _jax_model("llama3-8b")
    batch = _torch_batch(_batch(cfg.vocab, 2, 16))
    with pytest.raises(RuntimeError, match="no backward"):
        lm.loss_fn(mod, batch, cfg, use_kernel=True)
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    k, v = torch.randn(1, 2, 8, 16), torch.randn(1, 2, 8, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, v)
    with torch.no_grad():
        assert flash_attention(q, k, v).shape == q.shape
        lm.forward(mod, batch["tokens"], cfg, use_kernel=True)
    assert flash_attention(q.detach(), k, v).shape == q.shape


def test_params_to_jax_inverts_params_from_jax():
    cfg, jcfg, jparams, mod = _jax_model("deepseek-v2-lite-16b")
    tree = lm.params_to_jax(mod, cfg)
    theirs = jax.tree_util.tree_flatten_with_path(jparams)[0]
    mine = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [p for p, _ in mine] == [p for p, _ in theirs]
    for (_, a), (_, b) in zip(mine, theirs):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    bf = dataclasses.replace(llama3_8b.REDUCED, dtype="bfloat16")
    jbf = dataclasses.replace(j_llama.REDUCED, dtype="bfloat16")
    jp = jlm.init_params(jax.random.PRNGKey(4), jbf)
    back = lm.params_to_jax(lm.params_from_jax(jax.tree.map(_np, jp), bf,
                                               "cpu"), bf)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(_np(a), _np(b))


# ------------------------------------------------------------- optimizer

def test_schedule_matches_jax():
    cfg = dict(lr=3e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    steps = np.arange(0, 101, dtype=np.int32)
    got = schedule(AdamWConfig(**cfg), torch.from_numpy(steps))
    want = j_schedule(JAdamWConfig(**cfg), jnp.asarray(steps))
    assert got.dtype == torch.float32 and float(got[0]) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_global_norm_matches_jax():
    rng = np.random.default_rng(0)
    tree = {f"l{i}": rng.standard_normal((7, 3 + i)).astype(np.float32)
            for i in range(4)}
    got = global_norm({k: torch.from_numpy(v) for k, v in tree.items()})
    np.testing.assert_allclose(
        float(got), float(j_global_norm({k: jnp.asarray(v)
                                         for k, v in tree.items()})),
        rtol=1e-6)
    assert float(global_norm({"a": torch.tensor([3.0]),
                              "b": torch.tensor([4.0])})) == 5.0


def _ulps_bf16(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in bf16 ulps (the bit patterns of same-sign
    values count the representable numbers between them)."""
    ia = a.view(np.uint16).astype(np.int64)
    ib = b.view(np.uint16).astype(np.int64)
    assert np.array_equal(ia >> 15, ib >> 15) or np.all(
        (ia & 0x7fff) + (ib & 0x7fff) <= 1)
    return int(np.abs(ia - ib).max())


def test_adamw_update_on_a_bf16_tree_matches_jax():
    """One update from a non-zero state (step 3, clipping active), bf16
    parameters and gradients, float32 moments."""
    import ml_dtypes
    rng = np.random.default_rng(3)
    shapes = {"w": (16, 8), "b": (8,), "norm": (16,)}
    p = {k: rng.standard_normal(s).astype(ml_dtypes.bfloat16)
         for k, s in shapes.items()}
    g = {k: (rng.standard_normal(s) * 4).astype(ml_dtypes.bfloat16)
         for k, s in shapes.items()}
    m = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
         for k, s in shapes.items()}
    v = {k: (rng.random(s) * 0.01).astype(np.float32)
         for k, s in shapes.items()}
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=20, clip_norm=1.0)
    jp, jo, jm = j_adamw_update(
        {k: jnp.asarray(x) for k, x in g.items()},
        dict(m={k: jnp.asarray(x) for k, x in m.items()},
             v={k: jnp.asarray(x) for k, x in v.items()},
             step=jnp.asarray(3, jnp.int32)),
        {k: jnp.asarray(x) for k, x in p.items()}, JAdamWConfig(**cfg))

    def bf(x):
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)

    tp = {k: bf(x) for k, x in p.items()}
    tp, to, tm = adamw_update(
        {k: bf(x) for k, x in g.items()},
        dict(m={k: torch.from_numpy(x.copy()) for k, x in m.items()},
             v={k: torch.from_numpy(x.copy()) for k, x in v.items()},
             step=torch.tensor(3, dtype=torch.int32)),
        tp, AdamWConfig(**cfg))
    assert int(to["step"]) == 4 and to["step"].dtype == torch.int32
    for k in shapes:
        assert tp[k].dtype == torch.bfloat16
        mine = tp[k].view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        assert _ulps_bf16(mine, np.asarray(jp[k])) <= 1, k
        np.testing.assert_allclose(to["m"][k].numpy(), np.asarray(jo["m"][k]),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(to["v"][k].numpy(), np.asarray(jo["v"][k]),
                                   rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)


def test_init_opt_state_mirrors_the_parameters():
    cfg = dataclasses.replace(llama3_8b.REDUCED, dtype="bfloat16")
    mod = lm.init_params(cfg, seed=0, device="cpu")
    opt = init_opt_state(mod)
    named = dict(mod.named_parameters())
    assert list(opt["m"]) == list(named) == list(opt["v"])
    for k, p in named.items():
        for t in (opt["m"][k], opt["v"][k]):
            assert t.shape == p.shape and t.dtype == torch.float32
            assert not t.any()
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 0


# ------------------------------------------------------------ train step

def _quad_loss(params, batch):
    return torch.sum((params["w"] - batch["target"]) ** 2)


def test_adamw_converges_quadratic():
    params = dict(w=torch.full((8,), 5.0, requires_grad=True))
    opt = init_opt_state(params)
    cfg = AdamWConfig(lr=0.2, weight_decay=0.0, warmup_steps=0,
                      total_steps=200, clip_norm=100.0)
    step = make_train_step(_quad_loss, cfg)
    batch = dict(target=torch.zeros(8))
    for _ in range(150):
        params, opt, _ = step(params, opt, batch)
    assert float(params["w"].abs().max()) < 0.1


def test_clipping_bounds_update():
    params = dict(w=torch.zeros(4))
    opt = init_opt_state(params)
    cfg = AdamWConfig(lr=1.0, clip_norm=1e-3, warmup_steps=0, total_steps=10)
    p2, _, m = adamw_update(dict(w=torch.ones(4) * 1e6), opt, params, cfg)
    assert float(m["grad_norm"]) > 1e5
    assert float(p2["w"].abs().max()) < 2.0


def _linear():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((6, 3)).astype(np.float32),
            dict(x=rng.standard_normal((8, 6)).astype(np.float32),
                 y=rng.standard_normal((8, 3)).astype(np.float32)))


def _j_linear_loss(params, batch):
    return jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)


def _linear_loss(params, batch):
    return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)


@pytest.mark.parametrize("microbatches", [1, 4])
def test_make_train_step_matches_jax(microbatches):
    """The JAX package's substrate test model: 3 steps at 1 and 4
    microbatches against JAX's jitted step."""
    w, batch = _linear()
    cfg = dict(lr=1e-2, warmup_steps=0, total_steps=10)
    jstep = jax.jit(j_make_train_step(_j_linear_loss, JAdamWConfig(**cfg),
                                      microbatches=microbatches))
    step = make_train_step(_linear_loss, AdamWConfig(**cfg),
                           microbatches=microbatches)
    jp = dict(w=jnp.asarray(w))
    jo = j_init_opt_state(jp)
    p = dict(w=torch.from_numpy(w.copy()).requires_grad_())
    o = init_opt_state(p)
    for _ in range(3):
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        p, o, m = step(p, o, _torch_batch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert_steps_close(dict(w=p["w"]), dict(w=jp["w"]), cfg["lr"], 3)


def test_microbatched_grad_accum_matches_full():
    w, batch = _linear()
    cfg = AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10)
    out = []
    for mb in (1, 4):
        p = dict(w=torch.from_numpy(w.copy()).requires_grad_())
        p, _, m = make_train_step(_linear_loss, cfg, microbatches=mb)(
            p, init_opt_state(p), _torch_batch(batch))
        out.append((p["w"].detach(), float(m["loss"])))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-5, atol=1e-6)
    assert out[0][1] == pytest.approx(out[1][1], rel=1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(_linear_loss, cfg, microbatches=3)(
            p, init_opt_state(p), _torch_batch(batch))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_llama_trajectory_matches_jax(microbatches):
    """Five steps of llama3-8b REDUCED on ``lm_token_stream`` batches,
    against JAX's jitted step from the same weights."""
    cfg, jcfg, jparams, mod = _jax_model("llama3-8b", seed=0)
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=20)
    jstep = jax.jit(j_make_train_step(
        lambda p, b: jlm.loss_fn(p, b, jcfg), JAdamWConfig(**ocfg),
        microbatches=microbatches))
    step = make_train_step(lambda p, b: lm.loss_fn(p, b, cfg),
                           AdamWConfig(**ocfg), microbatches=microbatches)
    jo, o = j_init_opt_state(jparams), init_opt_state(mod)
    gen = lm_token_stream(cfg.vocab, 4, 24, seed=5)()
    for i in range(5):
        batch = next(gen)
        jparams, jo, jm = jstep(jparams, jo, {k: jnp.asarray(v)
                                              for k, v in batch.items()})
        mod, o, m = step(mod, o, _torch_batch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
    assert_steps_close(lm.to_jax_layout(dict(mod.named_parameters())),
                       jparams, ocfg["lr"], 5)
    assert int(o["step"]) == int(jo["step"]) == 5


def assert_steps_close(tree, jtree, lr, steps):
    """Parameters after ``steps`` AdamW steps against JAX's: per leaf,
    99.9 % of the elements within ``STEP_ATOL * lr * steps`` and every
    one within ``STEP_MAX * lr * steps``."""
    mine = jax.tree.leaves(jax.tree.map(
        lambda t: t.detach().float().numpy(), tree))
    theirs = jax.tree.leaves(jtree)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        d = np.abs(a - _np(b))
        assert d.max() <= STEP_MAX * lr * steps, d.max()
        assert np.mean(d > STEP_ATOL * lr * steps) <= 1e-3, d.max()


def test_lm_loss_descends_on_structured_stream():
    """End to end: tiny llama on the synthetic n-gram stream beats its
    initial loss within a few dozen steps (the JAX package's test)."""
    from repro_torch.models.api import get_bundle
    bundle = get_bundle("llama3-8b")
    cfg = bundle.reduced
    dims = dict(global_batch=8, seq_len=32)
    params = bundle.init(0, cfg, dims, device="cpu")
    step = make_train_step(bundle.step(cfg, dims, "train"), AdamWConfig(
        lr=3e-3, warmup_steps=5, total_steps=100))
    opt = init_opt_state(params)
    loader = PrefetchLoader(lm_token_stream(cfg.vocab, 8, 32), prefetch=2)
    losses = []
    for i, batch in enumerate(loader):
        params, opt, m = step(params, opt, _torch_batch(batch))
        losses.append(float(m["loss"]))
        if i >= 40:
            break
    loader.close()
    assert np.mean(losses[-5:]) < np.mean(losses[:3]) - 0.3, \
        losses[:3] + losses[-5:]


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("seed,shard", [(0, 0), (3, 1)])
def test_lm_token_stream_is_jax_bit_for_bit(seed, shard):
    mine = lm_token_stream(300, 3, 17, seed=seed, shard_id=shard)()
    theirs = j_token_stream(300, 3, 17, seed=seed, shard_id=shard)()
    for _ in range(3):
        a, b = next(mine), next(theirs)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


def test_prefetch_loader_order_and_close():
    assert list(PrefetchLoader(lambda: iter(range(10)), prefetch=3)) \
        == list(JPrefetchLoader(lambda: iter(range(10)), prefetch=3)) \
        == list(range(10))
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    loader = PrefetchLoader(endless, prefetch=2)
    first = []
    for x in loader:
        first.append(x)
        if len(first) == 3:
            break
    loader.close()                 # the producer ends, not blocked on put
    assert first == [0, 1, 2] and not loader._thread.is_alive()
    assert len(produced) <= 3 + 2 + 2
