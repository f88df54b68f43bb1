"""Port parity: the padded-sparse substrate and u8 quantization
(``repro_torch.sparse``) against ``repro.sparse`` on the same numpy
inputs. Integer outputs and quantization levels are equal; float
outputs are equal too (same elementwise arithmetic, no reductions)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.sparse import ops as jops
from repro.sparse import quant as jquant
from repro_torch.sparse import ops as tops
from repro_torch.sparse import quant as tquant


def _t(a):
    return torch.from_numpy(np.array(a))


def _rows(seed, n=12, width=40, zero_frac=0.3):
    rng = np.random.default_rng(seed)
    vals = rng.lognormal(0, 1, (n, width)).astype(np.float32)
    vals[rng.random((n, width)) < zero_frac] = 0.0
    vals[0] = 0.0                                  # an empty row
    vals[1, :10] = 1.5                             # value ties
    coords = np.stack([rng.permutation(1000)[:width] for _ in range(n)])
    return coords.astype(np.int32), vals


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_densify_matches_reference(seed):
    coords, vals = _rows(seed)
    coords[2, 5:] = 0                              # padding at coord 0
    vals[2, 5:] = 0.0
    want = jops.densify(jops.PaddedSparse(jnp.asarray(coords),
                                          jnp.asarray(vals), 1000))
    got = tops.densify(tops.PaddedSparse(_t(coords), _t(vals), 1000))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("alpha", [0.4, 0.8, 1.0])
@pytest.mark.parametrize("out_nnz", [8, 64])
def test_alpha_mass_subvector_matches_reference(alpha, out_nnz):
    """Includes the empty row (coords arange kept at alpha*0), value ties
    (ascending position), and alpha = 1 (trailing zeros kept in order)."""
    coords, vals = _rows(int(alpha * 10) + out_nnz)
    fn = jax.vmap(lambda c, v: jops.alpha_mass_subvector(c, v, alpha,
                                                         out_nnz))
    wc, wv = fn(jnp.asarray(coords), jnp.asarray(vals))
    gc, gv = tops.alpha_mass_subvector(_t(coords), _t(vals), alpha, out_nnz)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_alpha_mass_empty_row_keeps_leading_coords():
    d = 16
    gc, gv = tops.alpha_mass_subvector(torch.arange(d, dtype=torch.int32),
                                       torch.zeros(d), 0.4, 6)
    np.testing.assert_array_equal(gc.numpy(), np.arange(6))
    assert float(gv.abs().sum()) == 0.0


@pytest.mark.parametrize("fn", ["quantize_u8", "quantize_u8_ceil"])
@pytest.mark.parametrize("seed", [0, 3])
def test_quantize_matches_reference(fn, seed):
    _, vals = _rows(seed, n=64, width=96)
    vals[5] = 0.0                                  # all-padding row
    vals[6] = np.float32(2.0) * (vals[6] > 0)      # constant row
    wq, ws, wz = getattr(jquant, fn)(jnp.asarray(vals))
    gq, gs, gz = getattr(tquant, fn)(_t(vals))
    assert gq.dtype == torch.uint8
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gz.numpy(), np.asarray(wz))


def test_dequantize_matches_reference():
    _, vals = _rows(4, n=32, width=64)
    q, s, z = jquant.quantize_u8(jnp.asarray(vals))
    want = jquant.dequantize_u8(q, s, z)
    got = tquant.dequantize_u8(_t(q), _t(s), _t(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    assert float(got[np.asarray(q) == 0].abs().sum()) == 0.0


@pytest.mark.parametrize("x,k", [
    ([1.0, 3.0, 3.0, 2.0, 3.0], 2),
    ([-np.inf, 5.0, -np.inf, -np.inf, 5.0], 4),
    ([0.0] * 7, 3),
])
def test_top_k_tie_order_matches_lax(x, k):
    """lax.top_k returns the lowest index first among equal values;
    torch.topk promises no order, so the port sorts stably."""
    a = np.asarray([x, x[::-1]], np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(a), k)
    gv, gi = tops.top_k(_t(a), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_sparsify_and_top_cut_match_reference():
    coords, vals = _rows(5)
    dense = np.asarray(jops.densify(jops.PaddedSparse(
        jnp.asarray(coords), jnp.asarray(vals), 1000)))
    w = jops.sparsify(jnp.asarray(dense), 16)
    g = tops.sparsify(_t(dense), 16)
    np.testing.assert_array_equal(g.coords.numpy(), np.asarray(w.coords))
    np.testing.assert_array_equal(g.vals.numpy(), np.asarray(w.vals))
    wc, wv = jax.vmap(lambda c, v: jops.top_cut(c, v, 5))(
        jnp.asarray(coords), jnp.asarray(vals))
    gc, gv = tops.top_cut(_t(coords), _t(vals), 5)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_widen_and_take_rows_on_uint16():
    c = torch.tensor([[1, 65535], [40000, 2]], dtype=torch.uint16)
    np.testing.assert_array_equal(tops.widen_coords(c).numpy(),
                                  [[1, 65535], [40000, 2]])
    rows = tops.take_rows(c, torch.tensor([1, 1, 0]))
    assert rows.dtype == torch.uint16
    np.testing.assert_array_equal(tops.widen_coords(rows).numpy(),
                                  [[40000, 2], [40000, 2], [1, 65535]])
