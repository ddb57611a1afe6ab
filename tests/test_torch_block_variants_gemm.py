"""K14's and K13's launch sequences (csrc/swin_block_full.cu,
csrc/swin_block_v7.cu) in plain torch, on the CPU: the order of their sums,
and their bars against the JAX package's ``_attn_kernel_v5`` and
``_attn_kernel_v7``, interpreted, and the port's plain versions.

K14 runs K1's four launches on the rows of the REAL (B, H, W, C) map: LN1
(no padding to zero), the qkv GEMM with the epilogue bf16(acc + bqkv), the
window attention on the rolled, padded windows (token i reads the qkv row of
the real position it rolls from, or bqkv where that position is padding,
and its output is kept only where it is real), and the proj GEMM with the
epilogue bf16((x + acc) + bproj), x first.  K13 runs K1's four launches on
the rolled, padded map (LN1 zero at padding), the proj GEMM writing y, then
K2's five on y: the adapter's two GEMMs batched over the streams (rows [s
Ts, (s + 1) Ts) with stream s's weights; the second, b2 folded in, writes
the W2 GEMM's f32 init), LN2 of y, the W1 GEMM with the tanh GELU, and the
W2 GEMM over the whole hidden from that init, out = bf16(y + acc).  Each
product is csrc/gemm_mma.cuh's order, modelled by
tests/test_torch_swin_block_gemm.py's ``gemm`` (16-deep steps of k in
ascending order from the init).

Each sequence is held to three things, on maps padded and shifted by 2 and
on maps that are not, with row counts no 64- or 128-row tile divides: bit
for bit the modelled composition of K1's and K2's sequences it replaces at
every real position (K14: pad and roll, K1, un-roll and crop; K13: K1,
un-roll and crop, K2 per stream), the interpreted Pallas kernel at
tests/test_torch_block_variants.py's bf16 bars, and the port's plain
version at chip_smoke.py's bars (atol 3e-2, rtol 2e-2, the branch within
1e-2, the share of outputs apart within SWIN_SHARE).  The planted fault,
the region mask dropped (shifted) or the rel-pos bias zeroed (unshifted),
must fail the plain version's bars.  The attention is the plain version's:
its order of the sums is the attention kernel's own
(tests/test_torch_window_qkv_mma.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import ir_ads_tpu.ops.pallas_swin as pallas_swin
from ir_ads_tpu.ops.pallas_swin import shift_region_ids
from ir_ads_tpu_torch.models.backbones.swin import pad_and_roll, unroll_and_crop
from ir_ads_tpu_torch.ops.swin_block import pad_mask, window_attention_reference
from ir_ads_tpu_torch.ops.swin_block_full import window_block_full_reference
from ir_ads_tpu_torch.ops.swin_block_v7 import window_block_v7_reference
from test_torch_block_tail_gemm import sequence as k2_sequence
from test_torch_swin_block_gemm import gemm, proj_add
from test_torch_swin_block_gemm import sequence as k1_sequence

BF16 = torch.bfloat16
SWIN_SHARE = dict(k14=0.07, k13=0.10)  # chip_smoke.py's, swin_block_full and swin_block_v7


def ln(rows, g, b, eps=1e-5):
    return F.layer_norm(rows.float(), (rows.shape[-1],), g.float(), b.float(), eps)


def real_map_attention(qkv, bqkv, bias, region, scale, heads, ws, shift):
    """K14's attention launch on the real (B, H, W, 3C) qkv map: the rolled
    windows of the padded map, whose token at (r, c) reads the real
    position ((r + shift) % Hp, (c + shift) % Wp) or, where that is
    padding, bqkv; outputs kept at real positions, (B H W, C) rows."""
    b, h, w, c3 = qkv.shape
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    full = bqkv.expand(b, hp, wp, c3).clone()
    full[:, :h, :w] = qkv
    rolled = torch.roll(full, shifts=(-shift, -shift), dims=(1, 2))
    att = window_attention_reference(rolled, bias, region, scale, heads, ws)
    return unroll_and_crop(att, h, w, shift).reshape(-1, c3 // 3)


def k14_sequence(x, params, region, scale, heads, ws, shift):
    """K14's four launches on the real map; the arguments and result of
    ``window_block_full_reference`` (bf16)."""
    g, b, wqkv, bqkv, wproj, bproj, bias = params
    bsz, h, w, c = x.shape
    rows = x.reshape(-1, c)
    qkv = (gemm(ln(rows, g, b).to(BF16), wqkv) + bqkv.float()).to(BF16)
    att = real_map_attention(qkv.reshape(bsz, h, w, 3 * c), bqkv, bias, region, scale, heads,
                             ws, shift)
    return proj_add(rows, gemm(att, wproj), bproj).reshape(x.shape)


def k14_composition(x, params, region, scale, heads, ws, shift):
    """Pad and roll, K1's four launches, un-roll and crop."""
    h, w = x.shape[1:3]
    return unroll_and_crop(k1_sequence(pad_and_roll(x, ws, shift), params, region, scale, heads,
                                       ws, h, w, shift), h, w, shift)


def k13_sequence(xm, attn, tail, region, scale, heads, ws, h_real, w_real, shift,
                 eps=1e-5, adapter_scale=0.5):
    """K13's nine launches on the rolled, padded map; the arguments and
    result of ``window_block_v7_reference`` (bf16, adapters (S, ...) or
    unstacked)."""
    g, b, wqkv, bqkv, wproj, bproj, bias = attn
    g2, be2, w1, b1, w2, b2, aw1, ab1, aw2, ab2 = tail
    bsz, hp, wp, c = xm.shape
    rows = xm.reshape(-1, c)
    xn = ln(rows, g, b, eps)
    if h_real != hp or w_real != wp:
        xn = xn.masked_fill(pad_mask(hp, wp, h_real, w_real, shift, xm.device)
                            .repeat(bsz, 1, 1).reshape(-1, 1), 0.0)
    qkv = (gemm(xn.to(BF16), wqkv) + bqkv.float()).to(BF16)
    att = window_attention_reference(qkv.reshape(bsz, hp, wp, 3 * c), bias, region, scale,
                                     heads, ws).reshape(-1, c)
    y = proj_add(rows, gemm(att, wproj), bproj)
    # the adapter's GEMMs batched over the streams: z = s, rows of stream s
    stacked = aw1.ndim == 3
    aw1, ab1, aw2, ab2 = (t if stacked else t[None] for t in (aw1, ab1, aw2, ab2))
    ys = y.reshape(aw1.shape[0], -1, c)
    init = torch.cat([
        adapter_scale * (gemm(torch.relu(gemm(ys[s], aw1[s]) + ab1[s].float()).to(BF16), aw2[s])
                         + ab2[s].float()) + b2.float()
        for s in range(aw1.shape[0])])
    hid = F.gelu(gemm(ln(y, g2, be2, eps).to(BF16), w1) + b1.float(),
                 approximate="tanh").to(BF16)
    return (y.float() + gemm(hid, w2, init)).to(BF16).reshape(xm.shape)


def k13_composition(xm, attn, tail, region, scale, heads, ws, h_real, w_real, shift):
    """K1's four launches, un-roll and crop, K2's five per stream: the real
    map's result."""
    y = unroll_and_crop(k1_sequence(xm, attn, region, scale, heads, ws, h_real, w_real, shift),
                        h_real, w_real, shift)
    streams = tail[6].shape[0] if tail[6].ndim == 3 else 1
    per, c = y.shape[0] // streams, y.shape[-1]
    return torch.cat([
        k2_sequence(y[s * per:(s + 1) * per].reshape(-1, c),
                    [*tail[:6], *(t[s] if streams > 1 else t for t in tail[6:])])
        for s in range(streams)]).reshape(y.shape)


def _inputs(seed, b, h, w, c, heads, ws, shift, streams=0):
    """bf16 inputs from one numpy seed, the std of a weight fan_in ** -0.5:
    x on the real (B, H, W, C) map, the attention parameters and (streams >
    0) the tail's, adapters stacked when streams > 1, in the port's layout
    (Linear weights (out, in); the rel-pos bias f32) and the JAX kernels'
    (Dense kernels (in, out)); the region ids of the padded map."""
    rng = np.random.RandomState(seed)
    r = lambda *s, std=1.0, mean=0.0: (  # noqa: E731
        rng.randn(*s) * std + mean).astype(np.float32)
    n, hid, ca = ws * ws, 4 * c, c // 8
    x = torch.from_numpy(r(b, h, w, c)).to(BF16)
    linear = lambda *lead, fan_out, fan_in: torch.from_numpy(  # noqa: E731
        r(*lead, fan_out, fan_in, std=fan_in ** -0.5)).to(BF16)
    vec = lambda *s, std=0.02: torch.from_numpy(r(*s, std=std)).to(BF16)  # noqa: E731
    attn = [torch.from_numpy(r(c, std=0.05, mean=1.0)).to(BF16), vec(c, std=0.05),
            linear(fan_out=3 * c, fan_in=c), vec(3 * c), linear(fan_out=c, fan_in=c), vec(c),
            torch.from_numpy(r(heads, n, n))]
    lead = (streams,) if streams > 1 else ()
    tail = [torch.from_numpy(r(c, std=0.05, mean=1.0)).to(BF16), vec(c, std=0.05),
            linear(fan_out=hid, fan_in=c), vec(hid), linear(fan_out=c, fan_in=hid), vec(c),
            linear(*lead, fan_out=ca, fan_in=c), vec(*lead, ca),
            linear(*lead, fan_out=c, fan_in=ca), vec(*lead, c)] if streams else []
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    region = shift_region_ids(hp, wp, ws, shift) if shift else None
    treg = None if region is None else torch.from_numpy(np.asarray(region))
    jreg = None if region is None else jnp.asarray(region)
    jt = lambda t: jnp.asarray(t.float().numpy(),  # noqa: E731
                               jnp.float32 if t.dtype == torch.float32 else jnp.bfloat16)
    jdense = lambda ts, weights: [  # noqa: E731
        jt(t.transpose(-1, -2) if i in weights else t) for i, t in enumerate(ts)]
    return (x, attn, tail, treg, jdense(attn, (2, 4)), jdense(tail, (2, 4, 6, 8)), jreg,
            (c // heads) ** -0.5)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _pallas_bars(got, want, x):
    """tests/test_torch_block_variants.py's measures against an interpreted
    Pallas kernel: the largest error at the map's scale, and the distance
    on what the block adds."""
    g, wt = _np(got), _np(want)
    scale = np.maximum(np.abs(wt), np.sqrt((wt ** 2).mean()))
    scaled = float((np.abs(g - wt) / scale).max())
    rel = float(np.linalg.norm(g - wt) / np.linalg.norm(wt - _np(x)))
    return scaled, rel


def _card_bars(got, want, x, share_tol):
    """chip_smoke.py's hold of a Swin block kernel against its plain
    version: element by element, on the branch, and the share apart."""
    g, wt = got.float(), want.float()
    elem = bool(((g - wt).abs() <= 3e-2 + 2e-2 * wt.abs()).all())
    rel = float((g - wt).norm() / (wt - x.float()).norm())
    share = float((got != want).float().mean())
    return elem and rel <= 1e-2 and share <= share_tol, rel, share


# (B, h, w, C, heads, ws, shift): a 7 x 10 map padded to 8 x 12 and shifted
# by 2 (140 real rows), and an aligned 8 x 12 map unshifted (288 rows)
K14_CASES = [(2, 7, 10, 32, 2, 4, 2), (3, 8, 12, 32, 2, 4, 0)]


@pytest.mark.parametrize("b,h,w,c,heads,ws,shift", K14_CASES)
def test_k14_four_launches_are_k1_on_the_padded_map(b, h, w, c, heads, ws, shift):
    x, attn, _, region, jattn, _, jreg, scale = _inputs(40 + shift, b, h, w, c, heads, ws, shift)
    geo = (region, scale, heads, ws, shift)
    got = k14_sequence(x, attn, *geo)
    assert got.shape == x.shape and got.dtype == BF16
    assert torch.equal(got, k14_composition(x, attn, *geo))

    kernel = pallas_swin.pallas_window_block_full(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), *jattn, jreg, scale, heads, ws,
        shift=shift, interpret=True)
    scaled, rel = _pallas_bars(got, kernel, x)
    assert scaled <= 2.0 ** -7 and rel <= 5e-3, (scaled, rel)

    plain = window_block_full_reference(x, *attn, *geo)
    ok, rel, share = _card_bars(got, plain, x, SWIN_SHARE["k14"])
    assert ok, (rel, share)
    # the bars see the attention: without the region mask (shifted) or the
    # rel-pos bias (unshifted) the sequence fails them
    bad = (k14_sequence(x, attn, None, *geo[1:]) if shift else
           k14_sequence(x, attn[:6] + [torch.zeros_like(attn[6])], *geo))
    assert not _card_bars(bad, plain, x, SWIN_SHARE["k14"])[0]


# (B, h, w, C, heads, ws, shift, streams): the 6 x 7 map of
# tests/test_pallas_swin_v7.py, window 4, shifted and not, with one and two
# adapter streams; and a 7 x 10 map (8 x 12 padded, 288 rows over 3 images)
K13_CASES = [(2, 6, 7, 32, 4, 4, 0, 1), (2, 6, 7, 32, 4, 4, 2, 1), (4, 6, 7, 32, 4, 4, 0, 2),
             (4, 6, 7, 32, 4, 4, 2, 2), (3, 7, 10, 32, 4, 4, 2, 1)]


@pytest.mark.parametrize("b,h,w,c,heads,ws,shift,streams", K13_CASES)
def test_k13_nine_launches_are_k1_then_k2(b, h, w, c, heads, ws, shift, streams):
    x, attn, tail, region, jattn, jtail, jreg, scale = _inputs(
        50 + shift + streams, b, h, w, c, heads, ws, shift, streams)
    xm = pad_and_roll(x, ws, shift).contiguous()
    geo = (region, scale, heads, ws, h, w, shift)
    got = k13_sequence(xm, attn, tail, *geo)
    assert got.shape == xm.shape and got.dtype == BF16
    assert torch.equal(unroll_and_crop(got, h, w, shift), k13_composition(xm, attn, tail, *geo))

    kernel = pallas_swin.pallas_window_block_v7(
        jnp.asarray(xm.float().numpy(), jnp.bfloat16), jattn, jtail, jreg, scale, heads, ws,
        h_real=h, w_real=w, shift=shift, interpret=True)
    scaled, rel = _pallas_bars(got, kernel, xm)
    assert scaled <= 2.0 ** -6 and rel <= 5e-3, (scaled, rel)

    plain = window_block_v7_reference(xm, attn, tail, *geo)
    ok, rel, share = _card_bars(got, plain, xm, SWIN_SHARE["k13"])
    assert ok, (rel, share)
    bad = (k13_sequence(xm, attn, tail, None, *geo[1:]) if shift else
           k13_sequence(xm, attn[:6] + [torch.zeros_like(attn[6])], tail, *geo))
    assert not _card_bars(bad, plain, xm, SWIN_SHARE["k13"])[0]
    if streams > 1:  # and the adapter GEMMs' batch: with the streams swapped
        swapped = k13_sequence(xm, attn, tail[:6] + [t.flip(0) for t in tail[6:]], *geo)
        assert not _card_bars(swapped, plain, xm, SWIN_SHARE["k13"])[0]

