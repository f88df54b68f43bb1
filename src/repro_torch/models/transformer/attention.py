"""Attention layers: GQA (optionally sliding-window) and MLA (port of
``repro/models/transformer/attention.py``).

Two execution paths per layer:
  * prefill: full-sequence attention. GQA with ``use_kernel=True`` runs
    the flash_attention kernel (the JAX package's ``use_pallas``), with a
    static window on Gemma's local layers; ``use_kernel=False`` is the
    plain q-chunked path (``_sdpa_chunked``: exact float32 softmax one
    query tile at a time). MLA has no kernel in either package: its full
    ``[B, h, S, S]`` float32 scores are computed as the JAX package
    computes them.
  * decode: one token against a cache, plain tensor ops as in the JAX
    package. The JAX one-hot cache update (``x * 1 + y * 0``) becomes an
    index write into the cache in place; for finite values both give the
    same cache. GQA decode takes Gemma's ring buffers (slot ``pos % T``);
    MLA decode is the absorbed form over the latent cache.

Decode on a mesh holds the cache as ``cache_specs`` lays it out: the
batch over the data axes and the cache length over "model" (over every
axis for a batch that does not split), while the weights split the
heads over "model" (Megatron). A rank so holds a slice of positions of
every kv head (or of the latent) but the queries of its own heads only:
it all-gathers the step's queries and kv columns over "model", writes
the step's key and value only where it owns slot ``pos`` (``pos % T``
for a ring), attends every head over its positions, and the softmax is
combined over the cache's axes (:func:`_combine`: the all-reduced max,
then the sums of exponentials and of the weighted values rescaled to
it). Each rank then keeps its own heads for its rows of ``wo``.

On a mesh in "tp" mode (``parallel``) each rank holds its columns of
the q/k/v projections (its heads) and its rows of ``wo``; the block's
input enters through ``parallel.enter`` and ``wo``'s partial sums leave
through ``parallel.leave``, the collectives GSPMD inserts for the JAX
package's ``shard(...)`` constraints. Where the kv heads do not split
over the model axis (``n_kv_heads % tp``), a rank's k/v columns are
part of a head: the rank all-gathers the k/v columns and keeps the heads
its query heads read, as GSPMD's split of a head's columns gives the
same numbers. MLA splits ``wq``, ``w_uk`` and ``w_uv`` by heads and keeps
``w_dkv``, ``w_kr`` and ``kv_norm`` whole (``_lm_rule``). The JAX
``repeat`` of the kv heads stays on the plain path; the kernel reads kv
head ``h // group`` for q head h instead, on the rank's local heads.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import TransformerConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import axis_index, mesh_axis_size
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import rms_norm
from repro_torch.models.transformer import parallel
from repro_torch.models.transformer.ffn import draw, linear
from repro_torch.models.transformer.rope import apply_rope

NEG = -1e30


class GQA(nn.Module):
    """The JAX package's ``init_gqa`` as a module. Projections in
    ``nn.Linear``'s ``[out, in]`` layout: the JAX package's ``wq`` ``[d,
    h*dh]``, ``wk``/``wv`` ``[d, kv*dh]`` and ``wo`` ``[h*dh, d]`` are
    their transposes."""

    def __init__(self, cfg: TransformerConfig, dtype: torch.dtype,
                 device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        s = d ** -0.5
        self.wq = linear(d, h * dh, dtype, device, generator, s)
        self.wk = linear(d, kv * dh, dtype, device, generator, s)
        self.wv = linear(d, kv * dh, dtype, device, generator, s)
        self.wo = linear(h * dh, d, dtype, device, generator, s)


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, window: int,
                  q_chunk: int = 512) -> torch.Tensor:
    """q [B, S, KV, G, Dh], k/v [B, T, KV, Dh] -> [B, S, KV, G, Dh].

    Exact softmax computed one query tile at a time; window > 0 applies
    sliding-window masking on top of causality."""
    b, s, kvh, g, dh = q.shape
    t = k.shape[1]
    scale = dh ** -0.5
    if s % q_chunk != 0:
        q_chunk = s
    k32, v32 = k.float(), v.float()
    k_pos = torch.arange(t, device=q.device)
    out = []
    for i in range(s // q_chunk):
        qc = q[:, i * q_chunk:(i + 1) * q_chunk].float()     # [B,C,KV,G,Dh]
        sc = torch.einsum("bckgd,btkd->bkgct", qc, k32) * scale
        q_pos = i * q_chunk + torch.arange(q_chunk, device=q.device)
        mask = torch.ones((q_chunk, t), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window > 0:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        p = torch.softmax(torch.where(mask, sc, NEG), dim=-1)
        out.append(torch.einsum("bkgct,btkd->bckgd", p, v32))
    return torch.cat(out, dim=1).to(q.dtype)


def gqa_forward(p: GQA, x: torch.Tensor, positions: torch.Tensor,
                cfg: TransformerConfig, *, window: int = 0,
                use_kernel: bool = False) -> torch.Tensor:
    """Full-sequence GQA. x [B, S, d] -> [B, S, d]."""
    tp = parallel.tp_size(cfg)
    x = parallel.enter(x, cfg)
    if cfg.n_heads % tp:
        return _gqa_uneven(p, x, positions, cfg, window, use_kernel, tp)
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads // tp, cfg.n_kv_heads, cfg.d_head
    q = apply_rope(p.wq(x).reshape(b, s, h, dh), positions, cfg.rope_theta)
    k, v = _local_kv(p.wk(x), p.wv(x), cfg, tp)
    kv = k.shape[2]
    g = h // kv
    k = apply_rope(k, positions, cfg.rope_theta)
    if use_kernel:
        # [B, H, S, Dh] views of the projections: the kernel reads in place
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True,
                            window=window if window > 0 else None)
        o = o.transpose(1, 2).reshape(b, s, h * dh)
    else:
        if g > 1:   # the JAX ``repeat``; a broadcast, so its backward is a
            #         sum over the group, not the atomic adds of an index
            k = k[:, :, :, None].expand(b, s, kv, g, dh).reshape(b, s, h, dh)
            v = v[:, :, :, None].expand(b, s, kv, g, dh).reshape(b, s, h, dh)
        o = _sdpa_chunked(q.reshape(b, s, h, 1, dh), k, v, causal=True,
                          window=window, q_chunk=cfg.attn_q_chunk)
        o = o.reshape(b, s, h * dh)
    return parallel.leave(p.wo(o), cfg)


def _own_columns(t: torch.Tensor, tp: int) -> torch.Tensor:
    """This rank's columns of the last axis of ``t`` (1 / tp of them, at
    its position on "model"); all of them for tp 1."""
    if tp == 1:
        return t
    cols = t.shape[-1] // tp
    return t[..., axis_index(parallel.MODEL) * cols:][..., :cols]


def _gqa_uneven(p: GQA, x: torch.Tensor, positions: torch.Tensor,
                cfg: TransformerConfig, window: int, use_kernel: bool,
                tp: int) -> torch.Tensor:
    """GQA where the heads do not split over "model" (phi3's 40 over 16):
    a rank's q columns and ``wo`` rows are 1 / tp of the heads' columns,
    parts of heads. The q and kv columns are all-gathered (their
    gradients reduce-scattered back), the rank attends the heads its
    columns touch (each with its kv head, a broadcast) and keeps its
    columns of the output for its rows of ``wo``: the split GSPMD's
    padding of the head axis computes."""
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    cols = h * dh // tp
    c0 = axis_index(parallel.MODEL) * cols
    h0, h1 = c0 // dh, -(-(c0 + cols) // dh)
    n = h1 - h0
    q = C.gather_sum(p.wq(x), 2, parallel.MODEL)[..., h0 * dh:h1 * dh]
    q = apply_rope(q.reshape(b, s, n, dh), positions, cfg.rope_theta)
    k = C.gather_sum(p.wk(x), 2, parallel.MODEL).reshape(b, s, kv, dh)
    v = C.gather_sum(p.wv(x), 2, parallel.MODEL).reshape(b, s, kv, dh)
    k = apply_rope(k, positions, cfg.rope_theta)
    g = h // kv            # each q head's kv head, broadcast to the heads
    k = k[:, :, :, None].expand(b, s, kv, g, dh).reshape(b, s, h, dh)
    v = v[:, :, :, None].expand(b, s, kv, g, dh).reshape(b, s, h, dh)
    k, v = k[:, :, h0:h1], v[:, :, h0:h1]
    if use_kernel:
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True,
                            window=window if window > 0 else None)
        o = o.transpose(1, 2)
    else:
        o = _sdpa_chunked(q.reshape(b, s, n, 1, dh), k, v, causal=True,
                          window=window, q_chunk=cfg.attn_q_chunk)
    o = o.reshape(b, s, n * dh)[..., c0 - h0 * dh:c0 - h0 * dh + cols]
    return parallel.leave(p.wo(o), cfg)


def _local_kv(k_cols: torch.Tensor, v_cols: torch.Tensor,
              cfg: TransformerConfig, tp: int):
    """The k/v heads [B, S, KVl, Dh] this rank's query heads read, from
    its k/v projection columns. When the kv heads split over the model
    axis those columns are its heads; otherwise the columns are
    all-gathered (the gradient reduce-scattered back) and the rank keeps
    kv heads ``q // group`` of its query heads q, which must be whole
    groups or parts of one."""
    b, s, _ = k_cols.shape
    kv, dh = cfg.n_kv_heads, cfg.d_head
    if tp == 1 or kv % tp == 0:
        return (k_cols.reshape(b, s, kv // tp, dh),
                v_cols.reshape(b, s, kv // tp, dh))
    h_loc, group = cfg.n_heads // tp, cfg.n_heads // kv
    if h_loc % group and group % h_loc:
        raise ValueError(f"{h_loc} query heads a rank straddle kv groups of "
                         f"{group}")
    first = axis_index(parallel.MODEL) * h_loc // group
    n = max(1, h_loc // group)
    k = C.gather_sum(k_cols, 2, parallel.MODEL).reshape(b, s, kv, dh)
    v = C.gather_sum(v_cols, 2, parallel.MODEL).reshape(b, s, kv, dh)
    return k[:, :, first:first + n], v[:, :, first:first + n]


def _cache_place(t_loc: int, t_axes: tuple) -> tuple[int, int]:
    """(the full cache length, this rank's first position) of a cache
    whose length is split over ``t_axes`` (row-major) in slices of
    ``t_loc``."""
    n, idx = 1, 0
    for ax in t_axes:
        size = mesh_axis_size(ax)
        n, idx = n * size, idx * size + axis_index(ax)
    return t_loc * n, idx * t_loc


def _combine(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
             axes: tuple) -> torch.Tensor:
    """A softmax split over ``axes``: each rank's max ``m``, sum of
    exponentials ``l`` (both [..., 1]) and exponential-weighted values
    ``o`` [..., D] over its positions, all-gathered in one exchange (a
    decode step's are a few hundred KB, so the exchange's latency is its
    cost), rescaled to the largest max and summed in rank order, then
    normalized."""
    parts = C.all_gather(torch.cat([m, l, o], dim=-1)[None], 0, axes)
    a = torch.exp(parts[..., :1] - parts[..., :1].amax(dim=0))
    return (parts[..., 2:] * a).sum(dim=0) / (parts[..., 1:2] * a).sum(dim=0)


def _attend(sc: torch.Tensor, values: torch.Tensor, eq: str,
            t_axes: tuple) -> torch.Tensor:
    """``einsum(eq, softmax(sc), values)`` over the last axis of the
    masked float32 scores ``sc``, that axis split over ``t_axes`` (each
    rank its positions; :func:`_combine`), or whole."""
    if not C.split_axes(t_axes):
        return torch.einsum(eq, torch.softmax(sc, dim=-1), values)
    m = sc.amax(dim=-1, keepdim=True)
    e = torch.exp(sc - m)
    return _combine(m, e.sum(dim=-1, keepdim=True),
                    torch.einsum(eq, e, values), t_axes)


def _own_heads(o: torch.Tensor, tp: int) -> torch.Tensor:
    """Every head's [B, h, D] -> this rank's heads [B, h / tp, D]."""
    if tp == 1:
        return o
    h_loc = o.shape[1] // tp
    first = axis_index(parallel.MODEL) * h_loc
    return o[:, first:first + h_loc]


def _all_heads(tp: int, *ts: torch.Tensor) -> list[torch.Tensor]:
    """This rank's head columns (the last axis) of each of ``ts`` ->
    every head's, in one all-gather over "model"."""
    if tp == 1:
        return list(ts)
    widths = [t.shape[-1] for t in ts]
    got = C.all_gather(torch.cat(ts, dim=-1)[None], 0, parallel.MODEL)
    return [part.movedim(0, -2).flatten(-2)
            for part in got.split(widths, dim=-1)]


def gqa_decode(p: GQA, x: torch.Tensor, pos: int, cache_k: torch.Tensor,
               cache_v: torch.Tensor, cfg: TransformerConfig, *,
               window: int = 0, t_axes: tuple = ()):
    """One-token GQA against a cache, written in place.

    x [B, 1, d]; pos: the step index (the same for every sequence);
    cache_k/v [B, T, KV, Dh], T the maximum sequence or a ring buffer's
    window. Returns (out [B, 1, d], cache_k, cache_v). The step writes
    slot ``pos % T``. Keys are rotated before they are cached, so a
    ring's slot order does not matter; validity does: a ring (``0 <
    T <= window``) holds slots ``<= pos`` and all T once ``pos >= T``,
    a full-length cache slots ``<= pos`` and, with a window, ``> pos -
    window``. On a mesh the cache holds this rank's positions of T
    (split over ``t_axes``) and the projections its heads (module
    docstring)."""
    b = x.shape[0]
    tp = parallel.tp_size(cfg)
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = h // kv
    t, start = _cache_place(cache_k.shape[1], t_axes)
    x = parallel.enter(x, cfg)
    pos_b = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _all_heads(tp, p.wq(x), p.wk(x), p.wv(x))
    q = apply_rope(q.reshape(b, 1, h, dh), pos_b, cfg.rope_theta)
    k_new = apply_rope(k_new.reshape(b, 1, kv, dh), pos_b, cfg.rope_theta)
    v_new = v_new.reshape(b, 1, kv, dh)

    slot = pos % t - start
    if 0 <= slot < cache_k.shape[1]:        # this rank owns the slot
        cache_k[:, slot] = k_new[:, 0]
        cache_v[:, slot] = v_new[:, 0]

    qg = q.reshape(b, kv, g, dh)
    sc = torch.einsum("bkgd,btkd->bkgt", qg.float(),
                      cache_k.float()) * dh ** -0.5
    slot_pos = start + torch.arange(cache_k.shape[1], device=x.device)
    if 0 < window and t <= window:
        valid = (slot_pos <= pos) | (pos >= t)          # ring buffer
    else:
        valid = slot_pos <= pos
        if window > 0:
            valid &= slot_pos > pos - window            # windowed full cache
    o = _attend(torch.where(valid, sc, NEG), cache_v.float(),
                "bkgt,btkd->bkgd", t_axes)
    # this rank's columns of every head's output: its heads, or parts of
    # heads where they do not split over "model" (``_gqa_uneven``)
    o = _own_columns(o.reshape(b, 1, h * dh), tp).to(x.dtype)
    return parallel.leave(p.wo(o), cfg), cache_k, cache_v


# ------------------------------------------------------------ MLA layer

class MLA(nn.Module):
    """The JAX package's ``init_mla`` as a module (DeepSeek-V2's latent
    attention). ``wq`` [h*(nd+rd), d], ``w_dkv`` [r, d], ``w_kr`` [rd, d]
    and ``wo`` [d, h*vd] are ``nn.Linear``s (the transposes of the JAX
    leaves); ``w_uk`` [r, h*nd] and ``w_uv`` [r, h*vd] keep the JAX
    layout, which the absorbed decode views as [r, h, nd]; ``kv_norm``
    [r] is a float32 RMS-norm gain."""

    def __init__(self, cfg: TransformerConfig, dtype: torch.dtype,
                 device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        r, nd, rd, vd = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                         cfg.v_head_dim)
        s = d ** -0.5
        self.wq = linear(d, h * (nd + rd), dtype, device, generator, s)
        self.w_dkv = linear(d, r, dtype, device, generator, s)
        self.w_kr = linear(d, rd, dtype, device, generator, s)
        self.w_uk = draw((r, h * nd), r ** -0.5, dtype, device, generator)
        self.w_uv = draw((r, h * vd), r ** -0.5, dtype, device, generator)
        self.wo = linear(h * vd, d, dtype, device, generator, s)
        self.kv_norm = nn.Parameter(torch.zeros(r, dtype=torch.float32,
                                                device=device))


def mla_forward(p: MLA, x: torch.Tensor, positions: torch.Tensor,
                cfg: TransformerConfig) -> torch.Tensor:
    """Full-sequence MLA. x [B, S, d] -> [B, S, d]. The scores ``(q_nope
    k_nope + q_rope k_rope) * (nd + rd) ** -0.5`` are the full [B, h, S,
    S] in float32, as in the JAX package; without autograd the sum, scale
    and mask run in place to keep one such tensor beside the softmax's."""
    tp = parallel.tp_size(cfg)
    if cfg.seq_parallel and tp > 1:
        x = C.gather_from(x, 1, parallel.MODEL)
    b, s, _ = x.shape
    h = cfg.n_heads // tp
    nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q = p.wq(_into_heads(x, tp)).reshape(b, s, h, nd + rd)
    q_nope = q[..., :nd]
    q_rope = apply_rope(q[..., nd:], positions, cfg.rope_theta)

    # w_dkv, w_kr and kv_norm are whole on every rank: the latent and the
    # shared rotary key are computed alike everywhere and enter the
    # rank's heads through copy_to
    c_kv = _into_heads(rms_norm(p.w_dkv(x), p.kv_norm, cfg.norm_eps), tp)
    k_rope = _into_heads(apply_rope(p.w_kr(x)[:, :, None, :], positions,
                                    cfg.rope_theta), tp)          # [B,S,1,rd]
    k_nope = (c_kv @ p.w_uk).reshape(b, s, h, nd)
    v = (c_kv @ p.w_uv).reshape(b, s, h, vd)

    sc = torch.einsum("bshd,bthd->bhst", q_nope.float(), k_nope.float())
    rope = torch.einsum("bshd,btd->bhst", q_rope.float(),
                        k_rope[:, :, 0].float())
    pos = torch.arange(s, device=x.device)
    future = pos[None, :] > pos[:, None]
    if torch.is_grad_enabled():
        # no tensor written in place: autograd, and remat's saved products
        # (``lm.forward_train``), read them again in the backward pass
        sc = ((sc + rope) * (nd + rd) ** -0.5).masked_fill(future, NEG)
    else:
        sc += rope
        sc *= (nd + rd) ** -0.5
        sc.masked_fill_(future, NEG)
    del rope
    pr = torch.softmax(sc, dim=-1)
    del sc
    o = torch.einsum("bhst,bthd->bshd", pr, v.float())
    return parallel.leave(p.wo(o.reshape(b, s, h * vd).to(x.dtype)), cfg)


def _into_heads(t: torch.Tensor, tp: int) -> torch.Tensor:
    """A tensor replicated over the model axis entering per-head work."""
    return C.copy_to(t, parallel.MODEL) if tp > 1 else t


def mla_decode(p: MLA, x: torch.Tensor, pos: int, cache_ckv: torch.Tensor,
               cache_kr: torch.Tensor, cfg: TransformerConfig, *,
               t_axes: tuple = ()):
    """Absorbed MLA decode, O(T * r) a step: only the latent ``c_kv`` [B,
    T, r] and the shared rotary key [B, T, rd] are cached (written in
    place at slot ``pos < T``); ``w_uk`` is folded into q and ``w_uv``
    into the output. Returns (out [B, 1, d], cache_ckv, cache_kr). On a
    mesh the caches hold this rank's positions (split over ``t_axes``)
    and ``wq``, ``w_uk``, ``w_uv`` and ``wo`` its heads: the absorbed
    queries of every head are gathered, the latent attention combined
    over the positions, and each rank expands its own heads."""
    b = x.shape[0]
    tp = parallel.tp_size(cfg)
    h = cfg.n_heads // tp
    nd, rd, vd, r = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                     cfg.kv_lora_rank)
    t_loc = cache_ckv.shape[1]
    _, start = _cache_place(t_loc, t_axes)
    x = parallel.enter(x, cfg)
    pos_b = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q = p.wq(x).reshape(b, 1, h, nd + rd)
    q_nope = q[:, 0, :, :nd]                                      # [B,h,nd]
    q_rope = apply_rope(q[..., nd:], pos_b, cfg.rope_theta)[:, 0]  # [B,h,rd]

    c_new = rms_norm(p.w_dkv(x), p.kv_norm, cfg.norm_eps)         # [B,1,r]
    kr_new = apply_rope(p.w_kr(x)[:, :, None, :], pos_b,
                        cfg.rope_theta)[:, :, 0, :]               # [B,1,rd]
    if 0 <= pos - start < t_loc:            # this rank owns the slot
        cache_ckv[:, pos - start] = c_new[:, 0]
        cache_kr[:, pos - start] = kr_new[:, 0]

    q_lat = torch.einsum("bhd,rhd->bhr", q_nope.float(),
                         p.w_uk.reshape(r, h, nd).float())
    q_lat, q_rope = (t.unflatten(-1, (-1, n)) for t, n in zip(_all_heads(
        tp, q_lat.flatten(-2), q_rope.float().flatten(-2)), (r, rd)))
    ckv = cache_ckv.float()
    sc = (torch.einsum("bhr,btr->bht", q_lat, ckv)
          + torch.einsum("bhd,btd->bht", q_rope,
                         cache_kr.float())) * (nd + rd) ** -0.5
    valid = start + torch.arange(t_loc, device=x.device) <= pos
    o_lat = _attend(torch.where(valid, sc, NEG), ckv, "bht,btr->bhr",
                    t_axes)                                       # [B,H,r]
    o = torch.einsum("bhr,rhd->bhd", _own_heads(o_lat, tp),
                     p.w_uv.reshape(r, h, vd).float())
    o = p.wo(o.reshape(b, 1, h * vd).to(x.dtype))
    return parallel.leave(o, cfg), cache_ckv, cache_kr
