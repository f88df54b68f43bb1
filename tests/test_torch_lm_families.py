"""Port parity: the LM archs beyond the dense GQA family against the JAX
package, on their REDUCED configs in float32 with the JAX
``init_params`` weights carried across by ``params_from_jax``:
gemma3-27b (Gemma-3's local:global windows, window 16, 6 layers: five
local, one global), deepseek-v2-lite-16b (MLA, MoE with 2 shared
experts, a dense first layer) and kimi-k2-1t-a32b (GQA, MoE with one
shared expert, a dense first layer).

Tolerances, float32: ``allclose(rtol=2e-5, atol=2e-5)`` for logits,
aux losses, layer outputs and caches (sums run in another order in XLA
and PyTorch, over at most 160 terms per dot); expert ids, capacity drops
and greedy tokens equal. The port's decode against its own forward:
``allclose(rtol=2e-3, atol=2e-3)``, the JAX package's own check
(tests/test_arch_smoke.py).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import deepseek_v2_lite_16b as j_deepseek
from repro.configs import gemma3_27b as j_gemma
from repro.configs import kimi_k2_1t_a32b as j_kimi
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models.transformer import lm as jlm
from repro.models.transformer.attention import init_mla as j_init_mla
from repro.models.transformer.attention import mla_decode as j_mla_decode
from repro.models.transformer.attention import mla_forward as j_mla_forward
from repro.models.transformer.ffn import _route as j_route
from repro.models.transformer.ffn import init_moe as j_init_moe
from repro.models.transformer.ffn import moe_local as j_moe_local
from repro.serve.engine import LMDecoder as JLMDecoder
from repro_torch.configs import (deepseek_v2_lite_16b, gemma3_27b,
                                 kimi_k2_1t_a32b)
from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import common
from repro_torch.models.transformer import ffn, lm
from repro_torch.models.transformer.attention import (MLA, mla_decode,
                                                      mla_forward)
from repro_torch.serve import LMDecoder

RTOL, ATOL = 2e-5, 2e-5
ARCHS = {"gemma3-27b": (gemma3_27b, j_gemma),
         "deepseek-v2-lite-16b": (deepseek_v2_lite_16b, j_deepseek),
         "kimi-k2-1t-a32b": (kimi_k2_1t_a32b, j_kimi)}
# gemma: 40 tokens against a window of 16, 24 decode steps (the ring of
# 16 slots wraps); the MoE stacks: 12 tokens, 8 steps
SEQ = {"gemma3-27b": 40, "deepseek-v2-lite-16b": 12, "kimi-k2-1t-a32b": 12}
STEPS = {"gemma3-27b": 24, "deepseek-v2-lite-16b": 8, "kimi-k2-1t-a32b": 8}



@pytest.fixture(autouse=True)
def _inference():
    """These tests hold the inference path, which runs without autograd
    (``forward`` and ``decode_step`` are no-grad entry points): the
    parameters carry gradients, so a layer called directly runs under
    ``torch.no_grad`` here too."""
    with torch.no_grad():
        yield

def _np(a) -> np.ndarray:
    """A JAX array as float32 numpy (bf16 widens exactly)."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(_np(a)))


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(port config, JAX config, JAX params, the port's module)."""
    port, ref = ARCHS[arch]
    params = jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(7), ref.REDUCED)
    mod = lm.params_from_jax(jax.tree.map(_np, params), port.REDUCED, "cpu")
    return port.REDUCED, ref.REDUCED, params, mod


@functools.lru_cache(maxsize=None)
def _jax_forward(arch, mode):
    """JAX's logits and aux over 2 x SEQ tokens: ``scan`` (the scanned
    stack; gemma's ``_block_windowed`` with ``_sdpa_dyn``) or ``unroll``
    (``unroll_layers`` with the Pallas kernel in interpret mode)."""
    cfg, jcfg, params, _ = _model(arch)
    if mode == "unroll":
        jcfg = dataclasses.replace(jcfg, unroll_layers=True)
    toks = _tokens(cfg, 2, SEQ[arch], seed=1)
    logits, aux = jax.jit(jlm.forward, static_argnums=2,
                          static_argnames="use_pallas")(
        params, jnp.asarray(toks), jcfg, use_pallas=mode == "unroll")
    return toks, _np(logits), float(aux)


# ------------------------------------------------------------ structure

def test_layer_windows_match_jax():
    for arch, (port, ref) in ARCHS.items():
        for name in ("CONFIG", "REDUCED"):
            np.testing.assert_array_equal(
                lm.layer_windows(getattr(port, name)),
                jlm.layer_windows(getattr(ref, name)))
    wins = lm.layer_windows(gemma3_27b.CONFIG)
    assert len(wins) == 62 and int((wins == 0).sum()) == 10
    assert set(np.flatnonzero(wins == 0) + 1) == set(range(6, 63, 6))
    assert int((wins == 1024).sum()) == 52


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_cache_layout_matches_jax(arch):
    cfg, jcfg, _, _ = _model(arch)
    want = jlm.init_cache(jcfg, 3, 20)
    got = lm.init_cache(cfg, 3, 20, device="cpu")
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape, name
        assert t.dtype == torch.float32 and not bool(t.any())


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_params_counts_like_the_config(arch):
    """Every leaf of the JAX tree has its parameter (shapes transposed
    for the ``nn.Linear`` projections), and the count is the config's
    ``param_count`` plus MLA's ``kv_norm`` gains, which it does not
    count (nor does the JAX package's)."""
    cfg, _, params, mod = _model(arch)
    n_jax = sum(np.size(x) for x in jax.tree.leaves(params))
    n = sum(p.numel() for p in mod.parameters())
    assert n == n_jax
    extra = cfg.n_layers * cfg.kv_lora_rank if cfg.mla else 0
    assert n == cfg.param_count() + extra
    drawn = lm.init_params(cfg, seed=3, device="cpu")
    assert sum(p.numel() for p in drawn.parameters()) == n
    assert (drawn.dense0 is not None) == cfg.moe
    if cfg.moe:
        moe = drawn.layers[0].ffn
        assert moe.router.dtype == torch.float32
        assert moe.w1.shape == (cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
        assert moe.w2.shape == (cfg.n_experts, cfg.moe_d_ff, cfg.d_model)
        # f32 normal times d ** -0.5
        assert abs(float(moe.w1.std()) - cfg.d_model ** -0.5) < 0.01


def test_large_draws_are_chunked_and_seeded(monkeypatch):
    """A draw beyond ``_DRAW_ELEMS`` float32 values goes in chunks along
    its first axis; the same seed gives the same values. (``draw`` lives
    in ``models.common``, which every family draws with; ``ffn`` imports
    it.)"""
    monkeypatch.setattr(common, "_DRAW_ELEMS", 64)
    gen = torch.Generator().manual_seed(0)
    a = ffn.draw((5, 4, 8), 0.5, torch.float32, torch.device("cpu"), gen)
    gen = torch.Generator().manual_seed(0)
    b = torch.randn((10, 4, 8), generator=gen)[:5] * 0.5
    assert a.shape == (5, 4, 8) and a.requires_grad      # trainable
    torch.testing.assert_close(a.data, b, rtol=0, atol=0)


# -------------------------------------------------------- whole models

@pytest.mark.parametrize("mode", ["scan", "unroll"])
@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_matches_jax(arch, use_kernel, mode):
    cfg, _, _, mod = _model(arch)
    toks, want, want_aux = _jax_forward(arch, mode)
    runtime.reset_launches()
    got, aux = lm.forward(mod, torch.from_numpy(toks), cfg,
                          use_kernel=use_kernel)
    assert runtime.LAUNCHES["flash_attention"] == 0     # plain on the CPU
    assert got.shape == (2, SEQ[arch], cfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), want_aux, rtol=RTOL, atol=ATOL)
    assert (want_aux > 0) == cfg.moe


def test_gemma_windows_reach_the_kernel_path(monkeypatch):
    """With ``use_kernel``, gemma's local layers call flash_attention
    with their window and the global layer with none."""
    from repro_torch.models.transformer import attention
    cfg, _, _, mod = _model("gemma3-27b")
    seen = []
    kernel = attention.flash_attention

    def spy(q, k, v, **kw):
        seen.append(kw["window"])
        return kernel(q, k, v, **kw)

    monkeypatch.setattr(attention, "flash_attention", spy)
    lm.forward(mod, torch.from_numpy(_tokens(cfg, 1, 20)), cfg,
               use_kernel=True)
    assert seen == [16] * 5 + [None]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_steps_match_jax(arch):
    """decode_step against JAX's jitted one, step by step, then the
    caches; gemma's ring of 16 slots wraps at step 16."""
    cfg, jcfg, params, mod = _model(arch)
    steps = STEPS[arch]
    toks = _tokens(cfg, 2, steps, seed=2)
    jcache = jlm.init_cache(jcfg, 2, 32)
    cache = lm.init_cache(cfg, 2, 32, device="cpu")
    jstep = jax.jit(lambda p, c, t, pos: jlm.decode_step(p, c, t, pos, jcfg))
    for i in range(steps):
        want, jcache = jstep(params, jcache, jnp.asarray(toks[:, i:i + 1]),
                             jnp.asarray(i, jnp.int32))
        got, cache = lm.decode_step(mod, cache,
                                    torch.from_numpy(toks[:, i:i + 1]), i,
                                    cfg)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {i}")
    for name in cache:
        np.testing.assert_allclose(cache[name].numpy(), _np(jcache[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_lm_decoder_greedy_tokens_equal_jax(arch):
    """Greedy generation through every cache layout; gemma generates past
    its window (5 + 20 tokens against 16 slots)."""
    cfg, jcfg, params, mod = _model(arch)
    prompts = _tokens(cfg, 3, 5, seed=4)
    n = 20 if cfg.local_per_global else 6
    want = JLMDecoder(params, jcfg, batch=3, max_seq=32).generate(prompts, n)
    got = LMDecoder(mod, cfg, batch=3, max_seq=32).generate(prompts, n)
    assert got.dtype == torch.int32 and got.shape == (3, 5 + n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_matches_forward(arch):
    """The port's decode (the ring and the dual cache, MLA's absorbed
    form) against its own forward at every position. The MoE stacks run
    at ``capacity_factor`` 64, as the JAX package's own test: drops
    differ between a 2 x 12-token forward and 2-token steps."""
    cfg, _, _, mod = _model(arch)
    if cfg.moe:
        cfg = dataclasses.replace(cfg, capacity_factor=64.0)
    s = STEPS[arch] + 4
    toks = torch.from_numpy(_tokens(cfg, 2, s, seed=3))
    full, _ = lm.forward(mod, toks, cfg, use_kernel=True)
    cache = lm.init_cache(cfg, 2, s, device="cpu")
    steps = [lm.decode_step(mod, cache, toks[:, i:i + 1], i, cfg)[0]
             for i in range(s)]
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)


# ----------------------------------------------------------------- MoE

def _moe_cfg(**kw):
    """``tests/test_integration_extras.py``'s MoE config."""
    from repro_torch.configs.base import TransformerConfig
    base = dict(name="t", n_layers=1, d_model=16, n_heads=2, n_kv_heads=1,
                d_head=8, d_ff=32, vocab=64, moe=True, n_experts=4,
                moe_top_k=2, moe_d_ff=8, capacity_factor=0.25,
                dtype="float32")
    base.update(kw)
    return TransformerConfig(**base)


def _moe_from_jax(p, cfg):
    mod = ffn.MoE(cfg, torch.float32, torch.device("cpu"))
    with torch.no_grad():
        for name in ("router", "w1", "w3", "w2"):
            getattr(mod, name).copy_(_t(p[name]))
        if "shared" in p:
            for name in ("w1", "w2", "w3"):
                getattr(mod.shared, name).weight.copy_(_t(p["shared"][name]).T)
    return mod


def test_route_matches_jax_with_ties():
    """Expert ids equal, weights and aux allclose; two experts with equal
    router columns tie exactly in both packages, and the lower id comes
    first (``lax.top_k``)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((64, 16)).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    w[:, 5] = w[:, 2]
    for k in (1, 2, 3):
        j_idx, j_w, j_aux = jax.jit(j_route, static_argnums=2)(
            jnp.asarray(w), jnp.asarray(x), k)
        idx, wt, aux = ffn._route(torch.from_numpy(w), torch.from_numpy(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
        np.testing.assert_allclose(wt.numpy(), _np(j_w), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(float(aux), float(j_aux), rtol=RTOL)
    both = (idx == 2).any(1) & (idx == 5).any(1)
    assert bool(both.any())
    pos = idx.tolist()
    assert all(r.index(2) < r.index(5) for r, b in zip(pos, both) if b)


@pytest.mark.parametrize("cf", [0.25, 64.0])
@pytest.mark.parametrize("shared", [0, 1])
def test_moe_local_drops_match_jax(cf, shared):
    """``moe_local`` at ``capacity_factor`` 0.25 (capacity 8 of 32
    assignments an expert on average: most drop) and 64 (none does)."""
    cfg = _moe_cfg(capacity_factor=cf, n_shared_experts=shared)
    p = jax.jit(j_init_moe, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), _moe_cfg(n_shared_experts=shared),
        jnp.float32)
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (64, 16)))
    want, want_aux = jax.jit(j_moe_local, static_argnums=2)(
        p, jnp.asarray(x), cfg)
    got, aux = ffn.moe_local(_moe_from_jax(p, cfg), torch.from_numpy(x),
                             cfg)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=RTOL)
    cap = max(1, int(np.ceil(64 * 2 / 4 * cf)))
    idx, _, _ = ffn._route(_t(p["router"]),
                           torch.from_numpy(x), 2)
    kept = int(torch.bincount(idx.reshape(-1), minlength=4)
               .clamp(max=cap).sum())
    assert (kept < 128) == (cf < 1)


def test_moe_dispatch_drops_the_later_tokens_and_foreign_ids():
    """Within an expert the earlier tokens keep their slots; an id at or
    past the local expert count is dropped (the EP path's sentinel)."""
    d = 4
    x = torch.arange(1, 5, dtype=torch.float32)[:, None].expand(4, d) \
        .contiguous()
    idx = torch.tensor([[0], [0], [1], [2]])
    w = torch.ones(4, 1)
    eye = torch.eye(d).expand(2, d, d).contiguous()
    # silu(x) * x passes through w2 = I: token 1 (expert 0, rank 1) and
    # token 3 (foreign expert 2) drop at capacity 1
    out = ffn._dispatch_compute(x, idx, w, eye, eye, eye, capacity=1)
    want = torch.nn.functional.silu(x) * x
    want[1] = 0
    want[3] = 0
    torch.testing.assert_close(out, want)


def test_moe_combine_adds_each_tokens_outputs_in_expert_order():
    """bf16: a token's k outputs are summed one after another in
    ascending expert order, each sum rounded to bf16, as JAX's
    scatter-add adds the sorted assignments: experts 0 and 1 give 1 and
    expert 2 gives 256, so 1 + 1 + 256 = 258, where the top-k order
    (256 first) would round each 1 away and give 256."""
    d = 2
    x = torch.ones(1, d, dtype=torch.bfloat16)
    w1 = torch.full((3, d, d), 8.0, dtype=torch.bfloat16)  # h = g = 16
    w2 = torch.stack([torch.eye(d) * v for v in (2 ** -8, 2 ** -8, 1.0)]) \
        .bfloat16()                                       # silu(16) 16 = 256
    idx = torch.tensor([[2, 0, 1]])                       # top-k order
    out = ffn._dispatch_compute(x, idx, torch.ones(1, 3), w1, w1, w2,
                                capacity=1)
    assert out.dtype == torch.bfloat16
    assert out.float().tolist() == [[258.0, 258.0]]


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b"])
def test_moe_layer_of_the_model_matches_jax_on_3d_input(arch):
    """``moe_forward`` reshapes [B, S, d] to [B * S, d] (capacity over
    every token of the call), as ``moe_ep`` does off a mesh."""
    from repro.models.transformer.ffn import moe_forward as j_moe_forward
    cfg, jcfg, params, mod = _model(arch)
    x = np.random.default_rng(6).standard_normal(
        (3, 7, cfg.d_model)).astype(np.float32)
    pj = jax.tree.map(lambda a: a[0], params["layers"]["ffn"])
    want, want_aux = jax.jit(j_moe_forward, static_argnums=2)(
        pj, jnp.asarray(x), jcfg)
    got, aux = ffn.moe_forward(mod.layers[0].ffn, torch.from_numpy(x), cfg)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=RTOL)


# ----------------------------------------------------------------- MLA

def _mla(jcfg, cfg, seed=8):
    pj = jax.jit(j_init_mla, static_argnums=(1, 2))(
        jax.random.PRNGKey(seed), jcfg, jnp.float32)
    mod = MLA(cfg, torch.float32, torch.device("cpu"))
    with torch.no_grad():
        for name, src in pj.items():
            dst = getattr(mod, name)
            if isinstance(dst, torch.nn.Linear):
                dst.weight.copy_(_t(src).T)
            else:
                dst.copy_(_t(src))
    return pj, mod


def test_mla_forward_and_decode_match_jax():
    cfg, jcfg = deepseek_v2_lite_16b.REDUCED, j_deepseek.REDUCED
    pj, mod = _mla(jcfg, cfg)
    b, s = 2, 9
    rng = np.random.default_rng(9)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    want = jax.jit(j_mla_forward, static_argnums=3)(
        pj, jnp.asarray(x), jnp.asarray(pos), jcfg)
    got = mla_forward(mod, torch.from_numpy(x), torch.from_numpy(pos), cfg)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)
    jc = (jnp.zeros((b, s, cfg.kv_lora_rank)),
          jnp.zeros((b, s, cfg.qk_rope_dim)))
    ckv = torch.zeros(b, s, cfg.kv_lora_rank)
    kr = torch.zeros(b, s, cfg.qk_rope_dim)
    jstep = jax.jit(j_mla_decode, static_argnums=5)
    for i in range(s):
        w_i, *jc = jstep(pj, jnp.asarray(x[:, i:i + 1]),
                         jnp.asarray(i, jnp.int32), *jc, jcfg)
        g_i, ckv, kr = mla_decode(mod, torch.from_numpy(x[:, i:i + 1]), i,
                                  ckv, kr, cfg)
        np.testing.assert_allclose(g_i.numpy(), _np(w_i), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(ckv.numpy(), _np(jc[0]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(kr.numpy(), _np(jc[1]), rtol=RTOL, atol=ATOL)


def test_mla_decode_matches_mla_forward():
    """The absorbed decode (``w_uk`` folded into q, ``w_uv`` into the
    output, the rotary key shared by the heads) gives the full forward's
    rows, position by position."""
    cfg, jcfg = deepseek_v2_lite_16b.REDUCED, j_deepseek.REDUCED
    _, mod = _mla(jcfg, cfg, seed=10)
    b, s = 2, 11
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32))
    full = mla_forward(mod, x, torch.arange(s).expand(b, s), cfg)
    ckv = torch.zeros(b, s + 3, cfg.kv_lora_rank)
    kr = torch.zeros(b, s + 3, cfg.qk_rope_dim)
    rows = [mla_decode(mod, x[:, i:i + 1], i, ckv, kr, cfg)[0]
            for i in range(s)]
    np.testing.assert_allclose(torch.cat(rows, 1).numpy(), full.numpy(),
                               rtol=RTOL, atol=ATOL)


# ------------------------------------------------------ flash_attention

@pytest.mark.parametrize("causal,window,hkv", [(True, None, 2),
                                               (True, 64, 2),
                                               (False, None, 8)])
def test_flash_attention_plain_matches_pallas_d112(causal, window, hkv):
    """kimi-k2's head dim 112: the plain version against the Pallas
    kernel in interpret mode, which takes any head dim whole."""
    rng = np.random.default_rng(12)
    q = rng.standard_normal((1, 8, 200, 112)).astype(np.float32)
    k, v = (rng.standard_normal((1, hkv, 200, 112)).astype(np.float32)
            for _ in range(2))
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, window=window)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
