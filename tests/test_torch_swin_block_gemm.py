"""K1's launch sequence (csrc/swin_block.cu) in plain torch, on the CPU: the
order of its sums, and its bars against the JAX package's
``_attn_kernel_v4``, interpreted, and the port's plain version.

K1 runs four launches: LN1 of the rolled, padded map (zero where the map is
padding), the qkv GEMM with the epilogue bf16(acc + bqkv), the window
attention, and the proj GEMM with the epilogue bf16((x + acc) + bproj), x
first (csrc/gemm_mma.cuh, each product one f32 accumulator per output
taking the 16-deep steps of k in ascending order, modelled by ``gemm``:
one step is the exact sum of 16 products of bf16 values rounded to f32;
the K2, K5, K13 and K14 sequence tests import it).  The earlier fused row
kernels, which K13 and K14 ran too until they moved to these launches,
computed the same products on tiles of ``rows_per_block(C)`` rows, 64
output columns at a time.

First, the sequence gives the fused rows' bits on a padded, shifted map
whose row count no row tile divides.  K5's proj epilogue, x + (acc +
bproj), is another order: it moves the f32 sums of these products, and
over many values their bf16 roundings; K1 must not take it.  Second, the
sequence meets K1's bars (chip_smoke.py's ``check_window_block``: atol
3e-2, rtol 2e-2, the branch y - x within 1e-2, at most 1 % of the outputs
apart) against the interpreted kernel and the plain version, at the sizes
of tests/test_torch_kernels.py's bf16 case (ws 4, C 32, 2 heads, a 7 x 10
map padded and shifted by 2), and the region mask dropped fails them.  The
attention here is the plain version's: its order of the sums is the
attention kernel's own (tests/test_torch_window_qkv_mma.py), apart from
the products'.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ir_ads_tpu.ops.pallas_swin import pallas_window_block
from ir_ads_tpu_torch.ops.swin_block import (
    pad_mask, window_attention_reference, window_block_reference,
)
from ir_ads_tpu_torch.ops.window_attention import shift_region_ids

BF16 = torch.bfloat16
CHUNK = 64  # the fused row kernels' output columns a tile_gemm call
ROUNDING_SHARE = 0.01  # chip_smoke.py's


def gemm(a, w, init=None):
    """init + a w^T (a (M, K), w (N, K) bf16) in 16-deep steps of k."""
    k16 = -(-a.shape[-1] // 16) * 16
    a64 = F.pad(a.double(), (0, k16 - a.shape[-1]))
    w64 = F.pad(w.double(), (0, k16 - w.shape[-1]))
    acc = torch.zeros(a.shape[0], w.shape[0]) if init is None else init.clone()
    for k0 in range(0, k16, 16):
        acc = acc + (a64[:, k0:k0 + 16] @ w64[:, k0:k0 + 16].t()).float()
    return acc


def rows_per_block(c):
    return max(16, min(64, 16384 // c))


def ln1(x, g, b, h_real, w_real, shift, eps=1e-5):
    """LN1 of the map's rows to bf16, zero where the rolled map is padding."""
    bsz, hp, wp, c = x.shape
    xn = F.layer_norm(x.float(), (c,), g.float(), b.float(), eps)
    if h_real != hp or w_real != wp:
        xn = xn.masked_fill(pad_mask(hp, wp, h_real, w_real, shift, x.device)[None, :, :, None],
                            0.0)
    return xn.to(BF16).reshape(-1, c)


def fused_rows(x, params, region, scale, heads, ws, h_real, w_real, shift):
    """The fused row kernels: row tiles of rows_per_block(C), each output
    tile of 64 columns by its own tile_gemm call."""
    g, b, wqkv, bqkv, wproj, bproj, bias = params
    bsz, hp, wp, c = x.shape
    xn, rows = ln1(x, g, b, h_real, w_real, shift), x.reshape(-1, c)
    bm = rows_per_block(c)
    qkv = torch.empty(xn.shape[0], 3 * c, dtype=BF16)
    for r0 in range(0, xn.shape[0], bm):
        for n0 in range(0, 3 * c, CHUNK):
            qkv[r0:r0 + bm, n0:n0 + CHUNK] = (
                gemm(xn[r0:r0 + bm], wqkv[n0:n0 + CHUNK]) + bqkv[n0:n0 + CHUNK].float()).to(BF16)
    att = window_attention_reference(qkv.reshape(bsz, hp, wp, 3 * c), bias, region, scale,
                                     heads, ws).reshape(-1, c)
    y = torch.empty_like(rows)
    for r0 in range(0, rows.shape[0], bm):
        for n0 in range(0, c, CHUNK):
            acc = gemm(att[r0:r0 + bm], wproj[n0:n0 + CHUNK])
            y[r0:r0 + bm, n0:n0 + CHUNK] = (
                (rows[r0:r0 + bm, n0:n0 + CHUNK].float() + acc)
                + bproj[n0:n0 + CHUNK].float()).to(BF16)
    return y.reshape(x.shape)


def proj_add(x, acc, bproj):
    """K1's proj epilogue: bf16((x + acc) + bproj), x first."""
    return ((x.float() + acc) + bproj.float()).to(BF16)


def sequence(x, params, region, scale, heads, ws, h_real, w_real, shift):
    """K1's four launches; the arguments and result of
    ``window_block_reference`` (bf16)."""
    g, b, wqkv, bqkv, wproj, bproj, bias = params
    bsz, hp, wp, c = x.shape
    qkv = (gemm(ln1(x, g, b, h_real, w_real, shift), wqkv) + bqkv.float()).to(BF16)
    att = window_attention_reference(qkv.reshape(bsz, hp, wp, 3 * c), bias, region, scale,
                                     heads, ws).reshape(-1, c)
    return proj_add(x.reshape(-1, c), gemm(att, wproj), bproj).reshape(x.shape)


def _case(seed, b, h_real, w_real, c, heads, ws, shift):
    """bf16 inputs in the port's layout (Linear weights (out, in)) and the
    JAX kernel's (Dense kernels (in, out)), from one numpy seed."""
    rng = np.random.RandomState(seed)
    hp, wp = -(-h_real // ws) * ws, -(-w_real // ws) * ws
    r = lambda *s, std=1.0, mean=0.0: (  # noqa: E731
        rng.randn(*s) * std + mean).astype(np.float32)
    x = torch.from_numpy(r(b, hp, wp, c)).to(BF16)
    params = [torch.from_numpy(a).to(BF16) for a in (
        r(c, std=0.05, mean=1.0), r(c, std=0.05), r(3 * c, c, std=c ** -0.5),
        r(3 * c, std=0.02), r(c, c, std=c ** -0.5), r(c, std=0.02))]
    params.append(torch.from_numpy(r(heads, ws * ws, ws * ws)))
    region = shift_region_ids(hp, wp, ws, shift) if shift else None
    jt = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)  # noqa: E731
    jparams = [jt(t.t() if t.ndim == 2 else t) for t in params[:6]]
    jparams.append(jnp.asarray(params[6].numpy()))
    treg = None if region is None else torch.from_numpy(np.asarray(region))
    jreg = None if region is None else jnp.asarray(region)
    return x, params, treg, jt(x), jparams, jreg, (c // heads) ** -0.5


def _bars(got, want, x):
    """chip_smoke.py's hold for K1: element by element, on the branch, and
    the share of outputs apart."""
    g, wt = got.float(), want.float()
    elem = bool(((g - wt).abs() <= 3e-2 + 2e-2 * wt.abs()).all())
    rel = float((g - wt).norm() / (wt - x.float()).norm())
    share = float((got != want).float().mean())
    return elem and rel <= 1e-2 and share <= ROUNDING_SHARE, rel, share


# (B, h_real, w_real, C, heads, ws, shift): 3 x 8 x 12 = 288 rows of the
# padded map, which no 64-row tile of the fused kernels and no 128-row tile
# of the GEMM divides
ORDER_CASES = [(3, 7, 10, 32, 2, 4, 2), (3, 7, 10, 64, 2, 4, 2), (3, 8, 12, 32, 2, 4, 0)]


@pytest.mark.parametrize("b,h_real,w_real,c,heads,ws,shift", ORDER_CASES)
def test_four_launches_give_the_fused_rows_bits(b, h_real, w_real, c, heads, ws, shift):
    x, params, region, _, _, _, scale = _case(20 + c + shift, b, h_real, w_real, c, heads, ws,
                                              shift)
    geo = (region, scale, heads, ws, h_real, w_real, shift)
    assert torch.equal(sequence(x, params, *geo), fused_rows(x, params, *geo))


def test_k5_proj_order_moves_bits():
    # on the case's proj products the f32 sums part ...
    b, h_real, w_real, c, heads, ws, shift = ORDER_CASES[0]
    x, params, region, _, _, _, scale = _case(31, b, h_real, w_real, c, heads, ws, shift)
    g, be, wqkv, bqkv, wproj, bproj, bias = params
    qkv = (gemm(ln1(x, g, be, h_real, w_real, shift), wqkv) + bqkv.float()).to(BF16)
    att = window_attention_reference(qkv.reshape(*x.shape[:3], 3 * c), bias, region, scale,
                                     heads, ws).reshape(-1, c)
    acc, rows = gemm(att, wproj), x.reshape(-1, c).float()
    assert not torch.equal((rows + acc) + bproj.float(), rows + (acc + bproj.float()))
    # ... and over 2^22 values of the same sizes their bf16 roundings do
    # (about 0.8 % of the f32 sums part, one in a hundred thousand of those
    # rounds apart)
    rng, n = np.random.RandomState(32), 1 << 22
    xs = torch.from_numpy(rng.randn(n).astype(np.float32)).to(BF16)
    accs = torch.from_numpy(rng.randn(n).astype(np.float32))
    bs = torch.from_numpy((rng.randn(n) * 0.02).astype(np.float32)).to(BF16)
    k5 = (xs.float() + (accs + bs.float())).to(BF16)
    assert not torch.equal(proj_add(xs, accs, bs), k5)


@pytest.mark.parametrize("shift", [2, 0])
def test_sequence_meets_the_card_bars(shift):
    b, h_real, w_real, c, heads, ws = 2, 7, 10, 32, 2, 4
    x, params, region, jx, jparams, jreg, scale = _case(4 + shift, b, h_real, w_real, c, heads,
                                                        ws, shift)
    geo = (region, scale, heads, ws, h_real, w_real, shift)
    got = sequence(x, params, *geo)
    plain = window_block_reference(x, *params, *geo)
    kernel = torch.from_numpy(np.array(pallas_window_block(
        jx, *jparams, jreg, scale, heads, ws, h_real=h_real, w_real=w_real, shift=shift,
        interpret=True), np.float32)).to(BF16)
    assert got.shape == x.shape and got.dtype == BF16
    for want in (kernel, plain):
        ok, rel, share = _bars(got, want, x)
        assert ok, (rel, share)
    # the bars see the attention: the sequence without the region mask (or,
    # unshifted, without the rel-pos bias) fails them
    bad_params = params[:6] + [torch.zeros_like(params[6])] if not shift else params
    bad = sequence(x, bad_params, None, *geo[1:])
    assert not _bars(bad, plain, x)[0]
