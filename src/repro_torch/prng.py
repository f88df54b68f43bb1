"""JAX's default PRNG (``threefry2x32``, partitionable layout) in torch.

The JAX package draws with ``jax.random``: the builder keys list ``l``
with ``fold_in(PRNGKey(seed), l)``, ``LMDecoder`` samples with
``categorical`` after a ``split``. These functions give the same bits
from the same seed, on any device: a uint32 word is held in an int64
tensor and masked with ``& MASK`` after each step, so the arithmetic is
exact 64-bit integer work on the CPU and on the card alike.

A key is an int64 tensor ``[..., 2]`` of two uint32 words (JAX's legacy
``uint32[2]`` key); a leading batch of keys draws for each key at once.
Each function follows its counterpart in JAX 0.9.0 with
``jax_threefry_partitionable=True`` (its default):

``threefry2x32``  ``jax._src.prng._threefry2x32_lowering``
``key``           ``jax.random.PRNGKey`` (32-bit mode: ``[0, seed]``)
``fold_in``       ``threefry_fold_in``: the hash of ``(0, data)``
``split``         ``_threefry_split_foldlike``: key i is the hash of
                  ``(0, i)``
``random_bits``   ``_threefry_random_bits_partitionable``: element i is
                  the xor of the two words hashed from ``(i >> 32, i)``
``randint``       ``jax._src.random._randint`` (int32): two draws, a
                  high and a low word, reduced modulo the span in
                  wrapping uint32 arithmetic
``uniform``       ``_uniform``: random mantissa bits under exponent 0
``gumbel``        ``_gumbel`` (mode "low"): ``-log(-log(u))``
``categorical``   ``argmax(gumbel + logits)`` (``replace=True``)
``permutation``   ``_shuffle``: ``ceil(3 ln n / ln(2^32 - 1))`` rounds,
                  each ``key, sub = split(key)`` then a stable sort of
                  the values by 32-bit ``random_bits(sub)`` keys
                  compared as unsigned words (``lax.sort_key_val``)
``choice``        ``replace=False``: the first draws of ``permutation``;
                  ``replace=True``: ``randint``
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def _mul32(a: torch.Tensor, b: torch.Tensor | int) -> torch.Tensor:
    """a * b modulo 2^32 for uint32 words, without int64 overflow: b is
    split into 16-bit halves, each product stays below 2^48."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def _signed(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Unsigned words of ``bits`` bits read as two's complement."""
    return torch.where(x >= 1 << (bits - 1), x - (1 << bits), x)


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the word pairs (x1, x2) under
    the key (k1, k2); all four broadcast against each other."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a, b = (x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK
    return a, b


def key(seed: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit integers off: ``[0,
    seed mod 2^32]``."""
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def _hash(k: torch.Tensor, hi, lo) -> torch.Tensor:
    a, b = threefry2x32(k[..., 0], k[..., 1], hi, lo)
    return torch.stack([a, b], dim=-1)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: data (an int or an integer tensor, which
    broadcasts against the keys' batch) hashed into the key."""
    data = torch.as_tensor(data, dtype=torch.int64, device=k.device) & MASK
    return _hash(k, torch.zeros_like(data), data)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` -> keys ``[..., num, 2]``."""
    i = torch.arange(num, dtype=torch.int64, device=k.device)
    return _hash(k[..., None, :], i >> 32, i & MASK)


def random_bits(k: torch.Tensor, bit_width: int,
                shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.bits`` of 8, 16 or 32 bits -> int64 ``[*batch,
    *shape]`` for keys ``[*batch, 2]``."""
    if bit_width not in (8, 16, 32):
        raise ValueError(f"random_bits: bit width {bit_width} not in 8, 16, "
                         "32")
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=k.device)
    kk = k.reshape(*k.shape[:-1], *(1,) * len(shape), 2)
    a, b = threefry2x32(kk[..., 0], kk[..., 1], (i >> 32).reshape(shape),
                        (i & MASK).reshape(shape))
    return (a ^ b) & ((1 << bit_width) - 1)


def randint(k: torch.Tensor, shape: tuple[int, ...], minval,
            maxval) -> torch.Tensor:
    """``jax.random.randint`` in int32 -> int64 values in [minval, maxval)
    (minval where maxval <= minval); minval and maxval are ints or int
    tensors that broadcast against ``[*batch, *shape]`` and lie in the
    int32 range."""
    dev = k.device
    lo = torch.as_tensor(minval, dtype=torch.int64, device=dev)
    hi = torch.as_tensor(maxval, dtype=torch.int64, device=dev)
    k1, k2 = split(k).unbind(-2)
    higher, lower = random_bits(k1, 32, shape), random_bits(k2, 32, shape)
    span = torch.where(hi <= lo, 1, (hi - lo) & MASK)
    mult = (1 << 16) % span
    mult = _mul32(mult, mult) % span
    off = (_mul32(higher % span, mult) + lower % span) & MASK
    off = off % span
    # int32 arithmetic: the offset converted, then added, both wrapping
    return _signed((lo + _signed(off, 32)) & MASK, 32)


_FLOAT = {torch.float32: (32, 23, 0x3F800000),
          torch.bfloat16: (16, 7, 0x3F80)}
_INT_VIEW = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
# Cephes' logf polynomial, as JAX's CPU backend evaluates log (float32)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once: the product of two float32
    values is exact in float64, the sum rounds in float64, then to float32
    (a double rounding that differs from one rounding only where the
    float64 sum lands exactly between two float32 values)."""
    b = b.double() if torch.is_tensor(b) else b
    c = c.double() if torch.is_tensor(c) else c
    return (a.double() * b + c).float()


def _log(x: torch.Tensor) -> torch.Tensor:
    """log of positive finite float32 or bfloat16 values, bitwise as JAX
    on the CPU computes it: Cephes' logf in float32 (the mantissa in
    [sqrt(1/2), sqrt(2)), a degree-8 polynomial, the exponent times ln 2
    in two parts), with the multiply-adds that its compiler fuses
    computed as FMAs; a bfloat16 input is widened and its log rounded
    back."""
    f32, dtype = torch.float32, x.dtype
    x = torch.clamp_min(x.to(f32), torch.finfo(f32).tiny)
    bits = x.view(torch.int32).to(torch.int64)
    e = ((bits >> 23) - 127).to(f32) + 1.0
    m = _signed((bits & 0x807FFFFF) | 0x3F000000, 32).to(torch.int32) \
        .view(f32)
    low = m < torch.tensor(0x3F3504F3, dtype=torch.int32).view(f32).item()
    x = (m - 1.0) + torch.where(low, m, 0.0)
    e = e - low.to(f32)
    x2 = x * x
    x3 = x2 * x
    p = [torch.tensor(c, dtype=f32).item() for c in _LOG_P]
    y = _fma(_fma(x, p[0], p[1]), x, p[2])
    y1 = _fma(_fma(x, p[3], p[4]), x, p[5])
    y2 = _fma(_fma(x, p[6], p[7]), x, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * torch.tensor(_LOG_Q1, dtype=f32).item())
    return _fma(e, _LOG_Q2, _fma(x2, -0.5, x) + y).to(dtype)


def uniform(k: torch.Tensor, shape: tuple[int, ...],
            dtype: torch.dtype = torch.float32, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 or bfloat16 -> ``[*batch,
    *shape]``. The mantissa takes the top bits of a draw (of 32 bits; of
    8 for bfloat16, as JAX draws 8 bits where the mantissa has fewer),
    under exponent 0: a value in [1, 2), less 1, scaled and shifted into
    [minval, maxval): in float32 by one multiply-add (JAX's CPU compiler
    fuses it), in bfloat16 by a multiply and an add, each rounded."""
    if dtype not in _FLOAT:
        raise ValueError(f"uniform: dtype {dtype} not float32 or bfloat16")
    nbits, nmant, one = _FLOAT[dtype]
    rng_bits = nbits if nmant >= 8 else 8
    bits = random_bits(k, rng_bits, shape)
    fbits = _signed((bits >> (rng_bits - nmant)) | one, nbits)
    floats = fbits.to(_INT_VIEW[dtype]).view(dtype) - 1.0
    lo = torch.tensor(minval, dtype=dtype, device=k.device)
    hi = torch.tensor(maxval, dtype=dtype, device=k.device)
    if dtype == torch.float32:
        return torch.maximum(lo, _fma(floats, hi - lo, lo))
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(k: torch.Tensor, shape: tuple[int, ...],
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low"): ``-log(-log(u))`` with u
    uniform in [tiny, 1)."""
    u = uniform(k, shape, dtype, minval=torch.finfo(dtype).tiny)
    return -_log(-_log(u))


def categorical(k: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis (``replace=True``):
    the first maximum of gumbel noise plus the logits, in their dtype."""
    g = gumbel(k, tuple(logits.shape), logits.dtype)
    return torch.argmax(g + logits, dim=-1)


def permutation(k: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` -> int64 ``[n]``, a
    permutation of ``arange(n)`` on the key's device. The round count is
    JAX's, computed in float64 as numpy does: one round up to n = 1,625,
    two from 1,626."""
    x = torch.arange(n, dtype=torch.int64, device=k.device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(MASK)))
    for _ in range(rounds):
        k, sub = split(k).unbind(-2)
        # the words are held non-negative in int64: an unsigned order
        order = torch.sort(random_bits(sub, 32, (n,)), stable=True).indices
        x = x[order]
    return x


def choice(k: torch.Tensor, n: int, shape: tuple[int, ...],
           replace: bool = True) -> torch.Tensor:
    """``jax.random.choice(key, n, shape, replace)`` (uniform, no ``p``)
    -> int64 ``shape`` of values in [0, n)."""
    draws = math.prod(shape)
    if not replace and draws > n:
        raise ValueError(f"Cannot take a larger sample (size {draws}) than "
                         f"population (size {n}) when 'replace=False'")
    if replace:
        return randint(k, shape, 0, n)
    return permutation(k, n)[:draws].reshape(shape)


__all__ = ["MASK", "threefry2x32", "key", "fold_in", "split", "random_bits",
           "randint", "uniform", "gumbel", "categorical", "permutation",
           "choice"]
