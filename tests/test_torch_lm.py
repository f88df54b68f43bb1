"""Port parity: the LM inference path of the dense GQA family
(``repro_torch.configs``, ``models.common``, ``models.transformer``,
``serve.engine.LMDecoder``) against the JAX package, on the reduced
llama3-8b and phi3-medium-14b configs (2 layers, d_model 64, float32)
with the JAX ``init_params`` weights carried across by
``params_from_jax``.

Tolerances, float32 (sums run in another order in XLA and PyTorch, over
at most 128 terms per dot): layer outputs ``allclose(rtol=2e-5,
atol=2e-5)``; logits of the whole model and of decode steps
``allclose(rtol=2e-5, atol=2e-5)``; greedy tokens equal. bf16:
``rms_norm`` and ``apply_rope`` round once per operation at the same
places in both packages, so within one bf16 ulp (``rtol=2**-7``).
The port's decode against its own forward: ``allclose(rtol=2e-3,
atol=2e-3)``, the JAX package's own check (tests/test_arch_smoke.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import deepseek_v2_lite_16b as j_deepseek
from repro.configs import gemma3_27b as j_gemma
from repro.configs import get_arch as j_get_arch
from repro.configs import kimi_k2_1t_a32b as j_kimi
from repro.configs import llama3_8b as j_llama
from repro.configs import phi3_medium_14b as j_phi3
from repro.models.common import rms_norm as j_rms_norm
from repro.models.transformer import lm as jlm
from repro.models.transformer.attention import gqa_forward as j_gqa_forward
from repro.models.transformer.attention import init_gqa as j_init_gqa
from repro.models.transformer.ffn import init_swiglu as j_init_swiglu
from repro.models.transformer.ffn import swiglu as j_swiglu
from repro.models.transformer.rope import apply_rope as j_apply_rope
from repro.serve.engine import LMDecoder as JLMDecoder
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs import (deepseek_v2_lite_16b, gemma3_27b,
                                 kimi_k2_1t_a32b, llama3_8b, phi3_medium_14b)
from repro_torch.kernels import runtime
from repro_torch.models.common import rms_norm
from repro_torch.models.transformer import lm
from repro_torch.models.transformer.attention import GQA, gqa_forward
from repro_torch.models.transformer.ffn import SwiGLU, swiglu
from repro_torch.models.transformer.rope import apply_rope
from repro_torch.serve import LMDecoder

RTOL, ATOL = 2e-5, 2e-5
ARCHS = {"llama3-8b": (llama3_8b, j_llama),
         "phi3-medium-14b": (phi3_medium_14b, j_phi3)}
# every LM arch of the JAX package (the fixture below runs the dense two;
# tests/test_torch_lm_families.py the other three)
ALL_ARCHS = {**ARCHS, "gemma3-27b": (gemma3_27b, j_gemma),
             "deepseek-v2-lite-16b": (deepseek_v2_lite_16b, j_deepseek),
             "kimi-k2-1t-a32b": (kimi_k2_1t_a32b, j_kimi)}
UNPORTED_IDS = ("gin-tu", "sasrec", "bst", "fm", "wide-deep")



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
    return a.astype(np.float32) if a.dtype.kind == "V" or \
        a.dtype.name == "bfloat16" else a


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(_np(a)))


@pytest.fixture(scope="module", params=list(ARCHS))
def reduced(request):
    """(port config, JAX config, JAX params, the port's module)."""
    port, ref = ARCHS[request.param]
    params = jlm.init_params(jax.random.PRNGKey(1), ref.REDUCED)
    tree = jax.tree.map(_np, params)
    return (port.REDUCED, ref.REDUCED, params,
            lm.params_from_jax(tree, port.REDUCED, "cpu"))


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", list(ALL_ARCHS))
def test_configs_match_jax(arch):
    port, ref = ALL_ARCHS[arch]
    for name in ("CONFIG", "REDUCED"):
        mine, theirs = getattr(port, name), getattr(ref, name)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.param_count() == theirs.param_count()
        assert mine.active_param_count() == theirs.active_param_count()
    assert [(c.name, c.kind, c.dims, c.skip is None) for c in port.SHAPES] \
        == [(c.name, c.kind, c.dims, c.skip is None) for c in ref.SHAPES]
    assert get_arch(arch) is port


def test_llama3_8b_size_and_unported_arch_ids():
    """The port registers the JAX package's five LM ids; the GNN and
    recsys ids (registered there) raise here, naming the five."""
    assert llama3_8b.CONFIG.param_count() == 8_030_261_248
    assert list_archs() == sorted(ALL_ARCHS)
    assert {j_get_arch(a).CONFIG.family for a in ALL_ARCHS} == {"lm"}
    with pytest.raises(KeyError, match="deepseek.*gemma3.*kimi.*llama3.*phi3"):
        get_arch("gin-tu")


@pytest.mark.parametrize("arch", UNPORTED_IDS)
def test_unported_configs_raise(arch):
    assert j_get_arch(arch).CONFIG.family in ("gnn", "recsys")
    with pytest.raises(KeyError, match="not ported"):
        get_arch(arch)


# -------------------------------------------------------------- layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((3, 5, 64)) * 3, dtype)
    scale = jnp.asarray(rng.standard_normal(64) * 0.1, jnp.float32)
    want = j_rms_norm(x, scale, 1e-6)
    got = rms_norm(_t(x).to(getattr(torch, dtype)), _t(scale), 1e-6)
    assert got.dtype == getattr(torch, dtype)
    rtol = RTOL if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=rtol,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((2, 7, 3, 16)), dtype)
    pos = np.stack([np.arange(7), np.arange(7) + 100]).astype(np.int32)
    want = j_apply_rope(x, jnp.asarray(pos), 500000.0)
    got = apply_rope(_t(x).to(getattr(torch, dtype)), torch.from_numpy(pos),
                     500000.0)
    assert got.dtype == getattr(torch, dtype)
    rtol = RTOL if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=rtol,
                               atol=1e-6)


def _swiglu_from_jax(pj, d, ff):
    mod = SwiGLU(d, ff, torch.float32, torch.device("cpu"))
    with torch.no_grad():
        for name in ("w1", "w2", "w3"):
            getattr(mod, name).weight.copy_(_t(pj[name]).T)
    return mod


def test_swiglu_matches_jax():
    pj = j_init_swiglu(jax.random.PRNGKey(2), 64, 128, jnp.float32)
    x = np.random.default_rng(2).standard_normal((2, 9, 64)).astype(
        np.float32)
    want = j_swiglu(pj, jnp.asarray(x))
    got = swiglu(_swiglu_from_jax(pj, 64, 128), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("use_kernel,use_pallas",
                         [(True, True), (True, False), (False, True),
                          (False, False)])
def test_gqa_forward_matches_jax(use_kernel, use_pallas, window):
    cfg = llama3_8b.REDUCED
    pj = j_init_gqa(jax.random.PRNGKey(3), cfg, jnp.float32)
    mod = GQA(cfg, torch.float32, torch.device("cpu"))
    with torch.no_grad():
        for name in ("wq", "wk", "wv", "wo"):
            getattr(mod, name).weight.copy_(_t(pj[name]).T)
    b, s = 2, 40
    x = np.random.default_rng(3).standard_normal((b, s, cfg.d_model)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    want = j_gqa_forward(pj, jnp.asarray(x), jnp.asarray(pos), cfg,
                         window=window, use_pallas=use_pallas)
    runtime.reset_launches()
    got = gqa_forward(mod, torch.from_numpy(x), torch.from_numpy(pos.copy()),
                      cfg, window=window, use_kernel=use_kernel)
    assert runtime.LAUNCHES["flash_attention"] == 0     # plain on the CPU
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)


# --------------------------------------------------------- whole model

@pytest.mark.parametrize("use_kernel", [True, False])
def test_lm_forward_matches_jax(reduced, use_kernel):
    cfg, jcfg, params, mod = reduced
    toks = _tokens(cfg, 2, 40)
    want, _ = jlm.forward(params, jnp.asarray(toks), jcfg,
                          use_pallas=use_kernel)
    got, aux = lm.forward(mod, torch.from_numpy(toks), cfg,
                          use_kernel=use_kernel)
    assert got.shape == (2, 40, cfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)


def test_decode_step_matches_jax(reduced):
    cfg, jcfg, params, mod = reduced
    toks = _tokens(cfg, 2, 8, seed=1)
    jcache = jlm.init_cache(jcfg, 2, 16)
    cache = lm.init_cache(cfg, 2, 16, device="cpu")
    for i in range(8):
        want, jcache = jlm.decode_step(params, jcache,
                                       jnp.asarray(toks[:, i:i + 1]),
                                       jnp.asarray(i, jnp.int32), jcfg)
        got, cache = lm.decode_step(mod, cache,
                                    torch.from_numpy(toks[:, i:i + 1]), i, cfg)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL,
                                   atol=ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), _np(jcache[name]),
                                   rtol=RTOL, atol=ATOL)


def test_lm_decoder_greedy_tokens_equal_jax(reduced):
    cfg, jcfg, params, mod = reduced
    prompts = _tokens(cfg, 3, 5, seed=2)
    want = JLMDecoder(params, jcfg, batch=3, max_seq=16).generate(prompts, 8)
    got = LMDecoder(mod, cfg, batch=3, max_seq=16).generate(prompts, 8)
    assert got.dtype == torch.int32 and got.shape == (3, 13)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lm_decoder_sampling_picks_jax_tokens(reduced, monkeypatch):
    """``generate(greedy=False)`` walks JAX's key chain (split, then
    categorical over the logits). The two packages' logits agree only
    within RTOL, so both samplers are fed the same logits: the port's
    decoder steps through the JAX decoder's own jitted ``decode_step``
    on the JAX parameters and cache, and must pick JAX's tokens."""
    cfg, jcfg, params, mod = reduced
    prompts = _tokens(cfg, 3, 4, seed=5)
    for seed in (0, 11):
        jdec = JLMDecoder(params, jcfg, batch=3, max_seq=16)
        want = jdec.generate(prompts, 10, greedy=False, seed=seed)
        jdec.cache = jlm.init_cache(jcfg, 3, 16)

        def jax_step(_params, cache, toks, pos, _cfg):
            logits, jdec.cache = jdec._step(
                params, jdec.cache, jnp.asarray(toks.numpy(), jnp.int32),
                jnp.asarray(pos, jnp.int32))
            return torch.from_numpy(np.array(logits)), cache

        monkeypatch.setattr(lm, "decode_step", jax_step)
        got = LMDecoder(mod, cfg, batch=3, max_seq=16).generate(
            prompts, 10, greedy=False, seed=seed)
        monkeypatch.undo()
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        greedy = JLMDecoder(params, jcfg, batch=3, max_seq=16).generate(
            prompts, 10)
        assert not np.array_equal(np.asarray(want), np.asarray(greedy))


def test_decode_matches_forward(reduced):
    """Decode logits (prefill by stepping) equal the full forward's at
    every position: caches, RoPE offsets and masks agree."""
    cfg, _, _, mod = reduced
    toks = torch.from_numpy(_tokens(cfg, 2, 12, seed=3))
    full, _ = lm.forward(mod, toks, cfg, use_kernel=True)
    cache = lm.init_cache(cfg, 2, 16, device="cpu")
    steps = []
    for i in range(12):
        logits, cache = lm.decode_step(mod, cache, toks[:, i:i + 1], i, cfg)
        steps.append(logits)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_params_from_jax_bf16_is_exact():
    """bf16 JAX weights widened to float32 come back as the same bf16
    values; the norm gains stay float32."""
    cfg = dataclasses.replace(llama3_8b.REDUCED, dtype="bfloat16")
    jcfg = dataclasses.replace(j_llama.REDUCED, dtype="bfloat16")
    params = jlm.init_params(jax.random.PRNGKey(4), jcfg)
    mod = lm.params_from_jax(jax.tree.map(_np, params), cfg, "cpu")
    assert mod.embed.dtype == torch.bfloat16
    assert mod.final_norm.dtype == torch.float32
    np.testing.assert_array_equal(mod.embed.float().numpy(),
                                  _np(params["embed"]))
    np.testing.assert_array_equal(
        mod.layers[1].attn.wq.weight.float().numpy(),
        _np(params["layers"]["attn"]["wq"][1]).T)
    np.testing.assert_array_equal(
        mod.layers[0].ffn.w2.weight.float().numpy(),
        _np(params["layers"]["ffn"]["w2"][0]).T)
    with pytest.raises(ValueError, match="shape"):
        lm.params_from_jax(jax.tree.map(_np, params), dataclasses.replace(
            cfg, d_ff=64), "cpu")


# --------------------------------------------------------- port itself

def test_init_params_is_seeded_and_counts_like_the_config():
    cfg = phi3_medium_14b.REDUCED
    a = lm.init_params(cfg, seed=5, device="cpu")
    b = lm.init_params(cfg, seed=5, device="cpu")
    c = lm.init_params(cfg, seed=6, device="cpu")
    assert sum(p.numel() for p in a.parameters()) == cfg.param_count()
    assert all(p.requires_grad for p in a.parameters())   # trainable
    assert torch.equal(a.layers[1].ffn.w3.weight, b.layers[1].ffn.w3.weight)
    assert not torch.equal(a.embed, c.embed)
    assert torch.count_nonzero(a.layers[0].attn_norm) == 0
    # f32 normal times d ** -0.5: the embedding's std is near 1 / 8
    assert abs(float(a.embed.std()) - 64 ** -0.5) < 0.01
    assert a.layers[0].attn.wk.weight.shape == (16, 64)     # [kv*dh, d]


def test_entry_points_need_cuda_or_an_explicit_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.init_params(llama3_8b.REDUCED)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.init_cache(llama3_8b.REDUCED, 1, 4)


def test_lm_decoder_sampling_is_seeded_and_bounded():
    cfg = llama3_8b.REDUCED
    mod = lm.init_params(cfg, seed=0, device="cpu")
    prompts = _tokens(cfg, 2, 3)
    dec = LMDecoder(mod, cfg, batch=2, max_seq=12)
    a = dec.generate(prompts, 6, greedy=False, seed=7)
    b = dec.generate(prompts, 6, greedy=False, seed=7)
    assert torch.equal(a, b)
    assert torch.equal(a[:, :3], torch.from_numpy(prompts))
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab
    with pytest.raises(ValueError, match="max_seq"):
        dec.generate(prompts, 10)
    with pytest.raises(ValueError, match="batch 2"):
        dec.generate(prompts[:1], 2)

