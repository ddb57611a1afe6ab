"""The w8a8 pieces of the r4i8 dispatch against the JAX package, on the CPU.

  * ``ops.int8``: quantize_weight, quantized_matmul (n = 2 included) and the
    per-tensor 3x3 quantized_conv against ir_ads_tpu.ops.int8 and
    pallas_mlp.quantize_weight.  Same scales, same rounding (half to even,
    by true division), exact int32 sums: the codes and scales are equal and
    the outputs agree to f32 rounding (rtol 1e-6).
  * K11's plain version (``block_tail_int8_reference``) against
    ``fused_block_tail_pallas`` under IR_ADS_INT8=1 in interpret mode, and
    K10's (``window_block_int8_reference``) against ``pallas_window_block``
    under IR_ADS_INT8=1, shifted and not, padded and not; in f32 and bf16.
  * ``from_flax`` carries an int8 model's variables over, and
    ``quantize_int8_`` makes the reference's codes and scales from them.

One-step flips.  Where the two sides compute an f32 LayerNorm, a GELU or a
sum in another order, a value within an ulp of k + 0.5 quantization steps
rounds to neighbouring s8 codes.  Each test counts the flips of the first
s8 stage (LN output -> per-row codes, recomputed on both sides with each
side's own arithmetic) and bars them: at most one step apart, and none in
these cases (they are that rare: a flip needs an f32 ulp to cross a code
boundary).  The outputs are then barred on what the kernel adds (the
branch out - x, relative in norm) and element by element:

  * f32: rel <= 1e-5 and |err| <= 1e-5 (1 + |want|): summation order only,
    no flip anywhere (a flip in the hidden moves its row by ~1e-3);
  * bf16: rel <= 8e-3 and |err| <= 2e-2 + 2^-6 |want|.  Both round the same
    f32 values to bf16 in the same places, and f32 sums of another order
    (the adapter, the attention scores, the GELU's tanh) flip such a
    rounding by one ulp (2^-8 to 2^-7 relative; two where a value crosses a
    binade).  Upstream of the second s8 stage (the hidden, the attention
    output) such a one-ulp difference can flip a code by one step, which
    moves an output by one step of that product, max|h| max|w| / 127, about
    1e-2 here: atol 2e-2 covers one such flip per output.  Measured: rel
    1.2e-3 to 4.8e-3, |err| at most 2.3e-2 (one bf16 ulp at |want| in
    [2, 4), or a flip).  The same rel bar must fail the float kernel's
    output, which is 1.3e-2 to 1.7e-2 away: the bar sees the int8
    arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.ops import int8 as jint8
from ir_ads_tpu.ops.pallas_mlp import fused_block_tail_pallas
from ir_ads_tpu.ops.pallas_mlp import quantize_weight as jax_quantize_weight
from ir_ads_tpu.ops.pallas_swin import pallas_window_block, shift_region_ids
from ir_ads_tpu_torch.ops import int8 as tint8
from ir_ads_tpu_torch.ops.block_tail_int8 import block_tail_int8
from ir_ads_tpu_torch.ops.swin_block_int8 import window_block_int8

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
BARS = {"f32": dict(rel=1e-5, atol=1e-5, rtol=1e-5),
        "bf16": dict(rel=8e-3, atol=2e-2, rtol=2.0 ** -6)}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dtype)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, dtype=np.float32)


@pytest.mark.parametrize("n", [2, 24])
def test_quantize_weight_and_quantized_matmul_match_jax(n):
    rng = np.random.RandomState(n)
    x = rng.randn(2, 7, 40).astype(np.float32)
    w = (rng.randn(40, n) * 0.05).astype(np.float32)  # JAX (K, N)
    wq_j, s_j = jax_quantize_weight(jnp.asarray(w))
    wq_t, s_t = tint8.quantize_weight(_t(w.T))
    np.testing.assert_array_equal(wq_t.numpy(), np.asarray(wq_j).T)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j)[0])
    want = np.asarray(jint8.quantized_matmul(jnp.asarray(x), jnp.asarray(w)))
    got = tint8.quantized_matmul(_t(x), _t(w.T)).numpy()
    assert got.shape == (2, 7, n)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_scale_floors_differ_only_for_an_all_but_zero_channel():
    """``quantize_weight`` floors max|w| before the division, quantized_matmul
    after it; the port keeps both, as the reference does."""
    w = np.array([[1e-11, 0.5], [-2e-11, 0.25]], np.float32)  # (K, N)
    for floor_first, ref in ((True, jax_quantize_weight),
                             (False, lambda k: _jax_matmul_weight(k))):
        q_j, s_j = ref(jnp.asarray(w))
        q_t, s_t = tint8.quantize_weight(_t(w.T), floor_first=floor_first)
        np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j).T)
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j).reshape(-1))
    assert not np.array_equal(tint8.quantize_weight(_t(w.T))[0].numpy(),
                              tint8.quantize_weight(_t(w.T), floor_first=False)[0].numpy())


def _jax_matmul_weight(kernel):
    """quantized_matmul's weight codes and scales (ir_ads_tpu/ops/int8.py:44-48)."""
    s_w = jnp.maximum(jnp.max(jnp.abs(kernel), axis=0, keepdims=True) / 127.0, 1e-12)
    return jnp.clip(jnp.round(kernel / s_w), -127, 127).astype(jnp.int8), s_w


def test_quantized_conv_3x3_per_tensor_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 9, 11, 16).astype(np.float32)
    w = (rng.randn(3, 3, 16, 8) * 0.05).astype(np.float32)  # HWIO
    want = np.asarray(jint8.quantized_conv(jnp.asarray(x), jnp.asarray(w), 1))
    got = tint8.quantized_conv(_t(x), _t(w.transpose(3, 2, 0, 1)), 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # one activation scale for the whole batch: a tile's output moves with
    # its batch-mate's range, as in the reference
    alone = tint8.quantized_conv(_t(x[:1]), _t(w.transpose(3, 2, 0, 1)), 1).numpy()
    assert not np.allclose(alone, got[:1], rtol=1e-6, atol=1e-7)


def test_int_mm_is_exact_past_f32_integers():
    """The s8 products accumulate in int32: a depth of 2304 (the 3x3 fuse
    conv at level 3) reaches sums past 2^24, where an f32 emulation rounds."""
    k = 2304
    a = torch.full((3, k), 127, dtype=torch.int8)
    a[1, 0] = 126
    w = torch.full((8, k), 127, dtype=torch.int8)
    acc = tint8.int_mm(a, w)
    assert acc.dtype == torch.int32
    assert int(acc[0, 0]) == k * 127 * 127 and int(acc[1, 0]) == k * 127 * 127 - 127
    f32 = (a.float() @ w.float().t())
    assert float(f32[0, 0]) - float(f32[1, 0]) != 127.0  # f32 cannot tell them apart


def _first_stage_flips(x, ln_w, ln_b, cdt, zero=None, eps=1e-5):
    """(flips, max step) between the two sides' s8 codes of the LN output,
    each side with its own arithmetic: the JAX kernels' mean / var / rsqrt
    in jnp, the port's plain versions' F.layer_norm."""
    jdt = jnp.float32 if cdt == torch.float32 else jnp.bfloat16
    c = x.shape[-1]
    xj = jnp.asarray(_np(x)).reshape(-1, c)
    mu = jnp.mean(xj, axis=1, keepdims=True)
    xc = xj - mu
    xn = xc * (1.0 / jnp.sqrt(jnp.mean(xc * xc, axis=1, keepdims=True) + eps))
    xn = xn * jnp.asarray(ln_w, jdt).astype(jnp.float32) + jnp.asarray(ln_b, jdt).astype(
        jnp.float32)
    xn = xn.astype(jdt).astype(jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xn), axis=1, keepdims=True), 1e-12) / 127.0
    qj = np.asarray(jnp.round(xn / sx)).astype(np.int32)
    xt = torch.nn.functional.layer_norm(
        x.float().reshape(-1, c), (c,), _t(ln_w, cdt).float(), _t(ln_b, cdt).float(), eps)
    qt = tint8.quantize_rows(xt.to(cdt), floor_first=True)[0].numpy().astype(np.int32)
    if zero is not None:
        qj[zero.reshape(-1)], qt[zero.reshape(-1)] = 0, 0
    step = np.abs(qj - qt)
    return int((step > 0).sum()), int(step.max())


def _bar(got, want, base, floated, dt, c, flips):
    g, w, x, fl = (_np(t).reshape(-1, c) for t in (got, want, base, floated))
    bar = BARS[dt]
    ref = np.linalg.norm(w - x)
    rel, rel_float = np.linalg.norm(g - w) / ref, np.linalg.norm(fl - w) / ref
    err = np.abs(g - w)
    worst = float((err / (bar["atol"] + bar["rtol"] * np.abs(w))).max())
    print(f"{dt}: rel {rel:.3e} (bar {bar['rel']}; float kernel {rel_float:.3e}), "
          f"worst |err| / (atol + rtol |want|) {worst:.3f}, max |err| {err.max():.3e}, "
          f"first-stage s8 flips {flips}")
    assert flips == (0, 0)
    assert rel <= bar["rel"] and worst <= 1.0
    assert rel_float > bar["rel"]  # the bar sees the int8 arithmetic


# (rows, C, hidden, Ca): tests/test_pallas_int8.py's case and a ragged one
TAIL_CASES = [(48, 64, 128, 8), (37, 32, 128, 2)]


def _lin(rng, fan_in, *shape):
    """A weight ~ N(0, 1/fan_in): each branch is as large as its input."""
    return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("rows,c,hidden,ca", TAIL_CASES)
def test_block_tail_int8_plain_matches_pallas(monkeypatch, dt, rows, c, hidden, ca):
    jdt, tdt = DTYPES[dt]
    rng = np.random.RandomState(rows)
    r = lambda *s: (rng.randn(*s) * 0.05).astype(np.float32)  # noqa: E731
    p = dict(ln_scale=1.0 + r(c), ln_bias=r(c), w1=_lin(rng, c, c, hidden), b1=r(hidden),
             w2=_lin(rng, hidden, hidden, c), b2=r(c), aw1=_lin(rng, c, c, ca), ab1=r(ca),
             aw2=_lin(rng, ca, ca, c), ab2=r(c))
    x = rng.randn(rows, c).astype(np.float32)
    run = lambda: fused_block_tail_pallas(  # noqa: E731
        jnp.asarray(x, jdt), *map(jnp.asarray, p.values()), interpret=True)
    floated = run()
    monkeypatch.setenv("IR_ADS_INT8", "1")
    want = run()
    w1 = tint8.quantize_weight(_t(p["w1"].T))
    w2 = tint8.quantize_weight(_t(p["w2"].T))
    xt = _t(x, tdt)
    with torch.no_grad():
        got = block_tail_int8(
            xt, _t(p["ln_scale"]), _t(p["ln_bias"]), *w1, _t(p["b1"]), *w2,
            _t(p["b2"]), _t(p["aw1"].T), _t(p["ab1"]), _t(p["aw2"].T), _t(p["ab2"]))
    assert got.dtype == tdt and got.shape == (rows, c)
    flips = _first_stage_flips(xt, p["ln_scale"], p["ln_bias"], tdt)
    _bar(got, want, xt, floated, dt, c, flips)


def test_block_tail_int8_hidden_is_not_rounded_and_quantized_per_whole_row():
    """K11's two departures from K2, seen in its plain version: the f32 GELU
    hidden is quantized over its whole 4C row with no bf16 rounding."""
    from ir_ads_tpu_torch.ops.block_tail_int8 import block_tail_int8_reference

    rng = np.random.RandomState(5)
    c, hidden, ca = 32, 128, 2
    x = torch.from_numpy(rng.randn(9, c).astype(np.float32)).to(torch.bfloat16)
    w1 = tint8.quantize_weight(torch.from_numpy(_lin(rng, c, hidden, c)))
    w2 = tint8.quantize_weight(torch.from_numpy(_lin(rng, hidden, c, hidden)))
    z = lambda *s: torch.zeros(*s)  # noqa: E731
    args = (torch.ones(c), z(c), *w1, z(hidden), *w2, z(c), z(ca, c), z(ca), z(c, ca), z(c))
    got = block_tail_int8_reference(x, *args).float() - x.float()
    # by hand: the same chain with the hidden's scale taken per 64 columns
    xn = torch.nn.functional.layer_norm(x.float(), (c,)).to(torch.bfloat16).float()
    h = torch.nn.functional.gelu(tint8.int8_linear(xn, *w1, floor_first=True),
                                 approximate="tanh")
    whole = tint8.int8_linear(h, *w2, floor_first=True)
    halves = sum(tint8.int8_linear(h[:, i:i + 64], w2[0][:, i:i + 64], w2[1],
                                   floor_first=True) for i in (0, 64))
    np.testing.assert_allclose(
        got.numpy(), (x.float() + whole).to(torch.bfloat16).float().numpy() - x.float().numpy(),
        atol=0, rtol=0)
    rounded = tint8.int8_linear(h.to(torch.bfloat16).float(), *w2, floor_first=True)
    assert not torch.allclose(whole, halves, rtol=1e-3, atol=1e-3)
    assert not torch.equal(whole, rounded)


# (Hp, Wp, h_real, w_real, shift): unshifted, shifted, shifted with padding,
# unshifted with padding
BLOCK_CASES = [(8, 8, 8, 8, 0), (8, 8, 8, 8, 2), (8, 8, 7, 6, 2), (8, 12, 5, 10, 0)]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("hp,wp,h_real,w_real,shift", BLOCK_CASES)
def test_window_block_int8_plain_matches_pallas(monkeypatch, dt, hp, wp, h_real, w_real,
                                                shift):
    jdt, tdt = DTYPES[dt]
    c, heads, ws = 64, 2, 4
    rng = np.random.RandomState(hp * wp + shift)
    r = lambda *s: (rng.randn(*s) * 0.05).astype(np.float32)  # noqa: E731
    args = [1.0 + r(c), r(c), _lin(rng, c, c, 3 * c), r(3 * c), _lin(rng, c, c, c), r(c),
            rng.randn(heads, ws * ws, ws * ws).astype(np.float32)]
    x = rng.randn(2, hp, wp, c).astype(np.float32)
    region = shift_region_ids(hp, wp, ws, shift) if shift else None
    scale = (c // heads) ** -0.5
    run = lambda: pallas_window_block(  # noqa: E731
        jnp.asarray(x, jdt), *map(jnp.asarray, args),
        None if region is None else jnp.asarray(region), scale, heads, ws,
        h_real=h_real, w_real=w_real, shift=shift, interpret=True)
    floated = run()
    monkeypatch.setenv("IR_ADS_INT8", "1")
    want = run()
    g, b, wqkv, bqkv, wproj, bproj, bias = args
    xt = _t(x, tdt)
    with torch.no_grad():
        got = window_block_int8(
            xt, _t(g), _t(b), *tint8.quantize_weight(_t(wqkv.T)), _t(bqkv),
            *tint8.quantize_weight(_t(wproj.T)), _t(bproj), _t(bias),
            None if region is None else torch.from_numpy(region), scale, heads, ws,
            h_real, w_real, shift)
    assert got.dtype == tdt and got.shape == x.shape
    rr, cc = np.meshgrid(np.arange(hp), np.arange(wp), indexing="ij")
    pad = ((rr + shift) % hp >= h_real) | ((cc + shift) % wp >= w_real)
    flips = _first_stage_flips(xt, g, b, tdt, zero=np.broadcast_to(pad, (2, hp, wp)))
    _bar(got, want, xt, floated, dt, c, flips)
